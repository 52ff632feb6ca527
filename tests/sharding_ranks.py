"""Sharded execution on spawned CPU ranks (not collected: no ``test_``
prefix; imports no JAX, so the card tests run it too).

    python tests/sharding_ranks.py IN.npz OUT.npz [--ranks 4] [--plain]

``IN.npz`` holds, per case key ``<key>/...``: the serving params
(``serve/<path>``) and training params (``train/<path>``) as float32
numpy, the prompt ``prompt`` [B, P], the decode tokens ``decode``
[n, B, 1], the vlm's ``img_embed`` or the enc-dec's ``frames`` for the
prompt, and the training batches ``batch<i>/<key>`` (tokens, labels and
the same extras); ``arch`` lists the keys. A key is an arch of
``configs.ARCHS`` (its smoke variant at float32 compute), optionally
followed by ``+tp<n>`` (``tp_multiple`` raised to n: grok's experts then
run in TP mode), ``+L<n>`` (``n_layers``) and ``+accum<a>`` (the train
steps at ``grad_accum=a``); a case without a prompt trains only. Every
family runs: dense, ssm, moe (EP and TP), hybrid, vlm and enc-dec. Each
rank joins a ``gloo`` group over a ``FileStore`` in a temp dir (no TCP
port), builds ``make_host_mesh()`` ((2, 2) on 4 ranks) and runs
``build_prefill_step``,
the decode steps through ``build_serve_step`` (the cache grown by
``grow_cache``) and the train steps through ``build_train_step``, params
and batches placed by the builders' structs. Rank 0 writes the gathered
results to ``OUT.npz``: ``<key>/prefill``, ``<key>/prefill_cache/<path>``,
``<key>/decode<i>``, ``<key>/cache/<path>``, ``<key>/loss<i>``,
``<key>/gnorm<i>``, ``<key>/step<i>/<params|opt>/<path>``, and for MoE
``<key>/lb<i>`` (the step's load-balance loss) and ``<key>/drop<i>`` (each
MoE layer's drop share in the step's forward pass); with ``--plain`` it
also runs the port's unsharded path on the same inputs
(``plain/<key>/...``), inside the mesh's ``rules.use_mesh`` so that MoE
dispatches in the same groups (one a batch shard).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def parse_key(key: str) -> tuple[str, dict]:
    """(arch, {"tp_multiple", "n_layers", "grad_accum"} as the key names
    them)."""
    arch, *mods = key.split("+")
    kw = {}
    for m in mods:
        if m.startswith("L"):
            kw["n_layers"] = int(m[1:])
        elif m.startswith("tp"):
            kw["tp_multiple"] = int(m[2:])
        elif m.startswith("accum"):
            kw["grad_accum"] = int(m[5:])
        else:
            raise ValueError(f"case {key!r}: unknown modifier {m!r}")
    return arch, kw


def _cfg(key: str):
    from repro_torch.configs import get_config, smoke_variant
    arch, kw = parse_key(key)
    kw.pop("grad_accum", None)
    return dataclasses.replace(smoke_variant(get_config(arch)),
                               compute_dtype="float32", **kw)


def _tree(z, prefix: str) -> dict:
    from repro_torch.utils import unflatten_dict
    n = len(prefix)
    return unflatten_dict({k[n:]: z[k] for k in z.files
                           if k.startswith(prefix)})


def _np(t) -> np.ndarray:
    """A float32 copy (the donated steps overwrite their tensors)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return np.array(t.detach().float().numpy(), copy=True)


def _float(t) -> float:
    from torch.distributed.tensor import DTensor
    return float(t.to_local() if isinstance(t, DTensor) else t)


def _extras(z, prefix: str, cfg) -> list[torch.Tensor]:
    """The vlm's ``img_embed`` or the enc-dec's ``frames`` under
    ``prefix``, in the compute dtype ([] for the other families)."""
    from repro_torch.nn.layers import cdt
    return [torch.from_numpy(np.asarray(z[prefix + k], np.float32)
                             ).to(cdt(cfg))
            for k in ("img_embed", "frames") if prefix + k in z.files]


class _Drops:
    """Each ``moe_apply`` call's drop share while ``on``."""

    def __init__(self):
        from repro_torch.nn import moe
        self.seen, self.on, apply = [], False, moe.moe_apply

        def recording(*a, **kw):
            y, aux = apply(*a, **kw)
            if self.on:
                self.seen.append(_float(aux["drop_frac"]))
            return y, aux
        moe.moe_apply = recording


def run_arch(z, key: str, mesh, out: dict, prefix: str,
             drops: _Drops) -> None:
    """The case's prefill, decode and train steps on ``mesh`` (None: the
    port's unsharded path), results under ``prefix`` in ``out``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve.steps import (build_prefill_step,
                                         build_serve_step, grow_cache,
                                         serve_config)
    from repro_torch.sharding import rules
    from repro_torch.train.steps import build_train_step, model_of
    from repro_torch.utils import tree_map, tree_paths
    cfg = _cfg(key)
    mod = model_of(cfg)
    accum = parse_key(key)[1].get("grad_accum", 1)
    if f"{key}/prompt" in z.files:
        prompt = torch.from_numpy(z[f"{key}/prompt"])
        dec = torch.from_numpy(z[f"{key}/decode"])
        B, P = prompt.shape
        n = dec.shape[0]
        scfg = serve_config(cfg)
        extra = _extras(z, f"{key}/", scfg)
        sp = mod.params_from_jax(_tree(z, f"{key}/serve/"), scfg,
                                 device="cpu")
        if mesh is None:
            if cfg.is_encdec:
                logits, cache = mod.prefill(sp, extra[0], prompt, scfg,
                                            max_len=P + n)
            else:
                logits, cache = mod.prefill(
                    sp, prompt, scfg, img_embed=extra[0] if extra else None,
                    max_len=P + n)
        else:
            pstep, (p_sds, t_sds, *e_sds), _ = build_prefill_step(
                cfg, ShapeConfig("p", "prefill", P, B), mesh)
            sp = rules.place_as(sp, p_sds)
            logits, cache = pstep(sp, rules.place_as(prompt, t_sds),
                                  *(rules.place_as(e, s)
                                    for e, s in zip(extra, e_sds)))
        out[f"{prefix}/prefill"] = _np(logits)
        for path, t in tree_paths(cache):
            if path.split("/")[-1] in ("k", "v"):  # its P prompt positions
                t = t[..., :P, :, :]
            out[f"{prefix}/prefill_cache/{path}"] = _np(t)
        if mesh is not None:
            dstep, (_, tok_sds, _, c_sds), _ = build_serve_step(
                cfg, ShapeConfig("d", "decode", P + n, B), mesh)
            cache = grow_cache(cache, c_sds)
        elif cfg.is_encdec:
            # the serve step's cross cache holds P + n positions (the
            # reference's build_serve_step), the grown one zero keys there
            cache["cross"] = tree_map(lambda t: torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, n)), cache["cross"])
        for i in range(n):
            pos = torch.tensor(P + i)
            if mesh is None:
                lg, cache = mod.decode_step(sp, dec[i], pos, cache, scfg)
            else:
                lg, cache = dstep(sp, rules.place_as(dec[i], tok_sds), pos,
                                  cache)
            out[f"{prefix}/decode{i}"] = _np(lg)
        for path, t in tree_paths(cache):
            out[f"{prefix}/cache/{path}"] = _np(t)

    n_steps = sum(1 for k in z.files
                  if k.startswith(f"{key}/batch") and k.endswith("/tokens"))
    b0 = z[f"{key}/batch0/tokens"]
    shape = ShapeConfig("t", "train", b0.shape[1], b0.shape[0])
    tp = mod.params_from_jax(_tree(z, f"{key}/train/"), cfg, device="cpu")
    if mesh is None:
        step, _, opt = build_train_step(cfg, shape, lr=1e-3, device="cpu",
                                        grad_accum=accum)
        state = opt.init(tp)
    else:
        step, (p_sds, o_sds, b_sds), opt = build_train_step(
            cfg, shape, mesh, lr=1e-3, grad_accum=accum)
        tp, state = rules.place_as(tp, p_sds), rules.zeros(o_sds)
    for i in range(n_steps):
        batch = {k: torch.from_numpy(np.asarray(v, np.int64))
                 for k, v in _tree(z, f"{key}/batch{i}/").items()
                 if k in ("tokens", "labels")}
        batch.update(zip([k for k in ("img_embed", "frames")
                          if f"{key}/batch{i}/{k}" in z.files],
                         _extras(z, f"{key}/batch{i}/", cfg)))
        if mesh is not None:
            batch = rules.place_as(batch, b_sds)
        drops.seen.clear()
        drops.on = True
        tp, state, m = step(tp, state, batch)
        drops.on = False
        out[f"{prefix}/loss{i}"] = np.float32(_float(m["loss"]))
        out[f"{prefix}/gnorm{i}"] = np.float32(_float(m["gnorm"]))
        if cfg.n_experts and "lb" in m:
            out[f"{prefix}/lb{i}"] = np.float32(_float(m["lb"]))
        if drops.seen:
            out[f"{prefix}/drop{i}"] = np.array(drops.seen, np.float32)
        for path, t in tree_paths({"params": tp, "opt": state}):
            out[f"{prefix}/step{i}/{path}"] = _np(t)


def _rank(rank: int, world: int, store: str, inp: str, outp: str,
          plain: bool) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    from repro_torch.sharding import rules
    z = np.load(inp)
    out: dict = {}
    drops = _Drops()
    for key in [str(a) for a in z["arch"]]:
        run_arch(z, key, mesh, out, key, drops)
        if plain and rank == 0:
            with rules.use_mesh(mesh):
                run_arch(z, key, None, out, f"plain/{key}", drops)
    if rank == 0:
        np.savez(outp, **out)
    dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("inp")
    ap.add_argument("out")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(args.ranks, os.path.join(d, "store"),
                              args.inp, args.out, args.plain),
                 nprocs=args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
