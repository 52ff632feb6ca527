"""LM serving driver for the PyTorch port: batched prefill → decode loop
with a continuous-batching slot table (``repro.launch.serve`` in
PyTorch).

    python -m repro_torch.launch.serve --arch mamba2-780m --prompt-len 2048
    python -m repro_torch.launch.serve --device cpu --smoke --arch internlm2-1.8b
    python -m repro_torch.launch.serve --device cpu --smoke --arch zamba2-7b

Each request is prefilled alone (batch 1) into a free lane of a shared
cache; one batched decode step then advances every occupied lane at its
own position, and finished lanes are refilled from the queue. It serves
the decoder-only families that take tokens alone (dense, moe, ssm,
hybrid); a vlm or enc-dec ``--arch`` prints ``error: ...`` and exits 2:
those are served through the model API (``lm.prefill(...,
img_embed=)``, ``encdec.prefill``), as the reference serves them. Prefill's
attention and SSD scan run the CUDA kernels on the card (the plain
versions on the CPU); decode runs the plain attention and SSM step. The
weights are seeded, not trained.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from repro_torch.configs import ARCHS, get_config, smoke_variant
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import lm
from repro_torch.serve.slots import SlotManager
from repro_torch.serve.steps import serve_config
from repro_torch.utils import tree_map


@dataclass
class Request:
    rid: int
    prompt: torch.Tensor         # [S] integer tokens
    max_new: int
    generated: list = field(default_factory=list)
    done: bool = False


def check_slot_servable(cfg) -> None:
    """Raise ``NotImplementedError`` for a config ``SlotServer`` cannot
    serve: its requests are token prompts alone, so a vlm (image
    embeddings) or enc-dec (frames) config is refused, as the reference's
    server cannot serve them either."""
    if cfg.is_encdec or cfg.family == "vlm":
        entry = ("encdec.prefill(params, frames, tokens, cfg)"
                 if cfg.is_encdec else
                 "lm.prefill(params, tokens, cfg, img_embed=)")
        raise NotImplementedError(
            f"{cfg.name}: SlotServer serves the decoder-only families that "
            f"take token prompts alone (dense, moe, ssm, hybrid); serve "
            f"family {cfg.family!r} through {entry} and decode_step")
    lm.check_servable(cfg)


class SlotServer:
    """Fixed-batch continuous decoding over a shared cache.

    Slot bookkeeping is the shared :class:`repro_torch.serve.slots.
    SlotManager`; this class owns the LM lane state (cache rows, per-row
    positions) and the prefill/decode calls. ``timings`` holds the host
    seconds of every admission (prefill + first token) and decode step.
    """

    def __init__(self, cfg, batch: int, max_len: int,
                 device: str | torch.device | None = None):
        check_slot_servable(cfg)
        self.cfg = serve_config(cfg)
        self.device = resolve_device(device)
        self.batch = batch
        self.max_len = max_len
        self.cache = lm.init_cache(self.cfg, batch, max_len,
                                   device=self.device)
        self.batch_axes = lm.cache_batch_axes(self.cfg)
        self.params = None
        self.slots: SlotManager[Request] = SlotManager(batch)
        self.pos = torch.zeros((batch,), dtype=torch.long, device=self.device)
        self.timings: dict[str, list[float]] = {"prefill": [], "decode": []}

    def load(self, params) -> None:
        self.params = params

    def admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot. Returns False when full."""
        slot = self.slots.admit(req)
        if slot is None:
            return False
        t0 = time.perf_counter()
        try:
            # prefill this prompt alone (batch 1), then copy its cache into
            # the slot's rows, on each leaf's own batch axis (2 for a hybrid
            # SSM leaf [n_groups, k, B, ...], 1 everywhere else)
            logits, cache1 = lm.prefill(self.params,
                                        req.prompt.to(self.device)[None, :],
                                        self.cfg, max_len=self.max_len)
        except Exception:
            self.slots.release(slot)     # a failed prefill must not leak the lane
            raise
        tree_map(lambda big, small, axis: big.narrow(axis, slot, 1)
                 .copy_(small), self.cache, cache1, self.batch_axes)
        req.generated.append(int(torch.argmax(logits[0])))
        self.pos[slot] = req.prompt.shape[0]
        self.timings["prefill"].append(time.perf_counter() - t0)
        return True

    def step(self) -> list[Request]:
        """One decode step for every occupied slot. Returns finished reqs."""
        t0 = time.perf_counter()
        occ = dict(self.slots.occupied())
        tokens = torch.tensor(
            [[occ[i].generated[-1] if i in occ else 0]
             for i in range(self.batch)], dtype=torch.long,
            device=self.device)
        # per-row positions: every slot decodes at its own sequence length
        logits, self.cache = lm.decode_step(self.params, tokens, self.pos,
                                            self.cache, self.cfg)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).tolist()
        finished = []
        for i, r in list(self.slots.occupied()):
            r.generated.append(int(nxt[i]))
            self.pos[i] += 1
            if len(r.generated) >= r.max_new:
                r.done = True
                finished.append(r)
                self.slots.release(i)
        self.timings["decode"].append(time.perf_counter() - t0)
        return finished


def serve(server: SlotServer, requests: list[Request]) -> tuple[list, int]:
    """Drive ``requests`` through ``server`` to completion. Returns the
    finished requests (in finishing order) and the decode steps taken."""
    queue = deque(requests)
    done: list[Request] = []
    steps = 0
    while len(done) < len(requests):
        while queue and server.admit(queue[0]):
            queue.popleft()
        done.extend(server.step())
        steps += 1
        if steps > len(requests) * max(r.max_new for r in requests) + 64:
            raise RuntimeError("serve loop did not converge")
    return done, steps


def make_requests(n: int, prompt_len: int, max_new: int, vocab: int,
                  seed: int = 1) -> list[Request]:
    """``n`` requests with prompts drawn uniformly from the vocabulary."""
    gen = torch.Generator().manual_seed(seed)
    return [Request(i, torch.randint(0, vocab, (prompt_len,), generator=gen),
                    max_new=max_new) for i in range(n)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default="internlm2-1.8b",
                    choices=list(ARCHS))
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's tiny smoke variant")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    try:
        check_slot_servable(cfg)
    except NotImplementedError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.smoke:
        cfg = smoke_variant(cfg)
    dev = resolve_device(args.device)
    server = SlotServer(cfg, args.batch, args.prompt_len + args.gen + 8,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    server.load(lm.init_params(gen, server.cfg, dev))
    reqs = make_requests(args.requests, args.prompt_len, args.gen,
                         server.cfg.vocab_size, seed=args.seed + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done, steps = serve(server, reqs)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"[serve] {len(done)} requests, {total_tokens} tokens, "
          f"{steps} decode steps, {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
