"""Sharded execution on spawned CPU ranks (not collected: no ``test_``
prefix; imports no JAX, so the card tests run it too).

    python tests/sharding_ranks.py IN.npz OUT.npz [--ranks 4]

``IN.npz`` holds, per arch key ``<arch>/...``: the serving params
(``serve/<path>``) and training params (``train/<path>``) as float32
numpy, the prompt ``prompt`` [B, P], the decode tokens ``decode``
[n, B, 1] and the training batches ``batch<i>/<key>``; ``arch`` lists the
archs (smoke variants, float32 compute). Each rank joins a ``gloo``
group over a ``FileStore`` in a temp dir (no TCP port), builds
``make_host_mesh()`` ((2, 2) on 4 ranks) and runs ``build_prefill_step``,
the decode steps through ``build_serve_step`` and the train steps through
``build_train_step``, params and batches placed by the builders' structs.
Rank 0 writes the gathered results to ``OUT.npz``: ``<arch>/prefill``,
``<arch>/prefill_cache/<path>``, ``<arch>/decode<i>``,
``<arch>/cache/<path>``, ``<arch>/loss<i>``, ``<arch>/gnorm<i>`` and
``<arch>/step<i>/<params|opt>/<path>``; with ``--plain`` it also runs the
port's unsharded path on the same inputs (``plain/<arch>/...``).
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


def _cfg(arch: str):
    from repro_torch.configs import get_config, smoke_variant
    return dataclasses.replace(smoke_variant(get_config(arch)),
                               compute_dtype="float32")


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


def run_arch(z, arch: str, mesh, out: dict, key: str) -> None:
    """The arch's prefill, decode and train steps on ``mesh`` (None: the
    port's unsharded path), results under ``key`` in ``out``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.serve.steps import (build_prefill_step,
                                         build_serve_step, grow_cache,
                                         serve_config)
    from repro_torch.sharding import rules
    from repro_torch.train.steps import build_train_step
    from repro_torch.utils import tree_map, tree_paths
    cfg = _cfg(arch)
    prompt = torch.from_numpy(z[f"{arch}/prompt"])
    dec = torch.from_numpy(z[f"{arch}/decode"])
    B, P = prompt.shape
    n = dec.shape[0]
    scfg = serve_config(cfg)
    sp = lm.params_from_jax(_tree(z, f"{arch}/serve/"), scfg, device="cpu")
    if mesh is None:
        logits, cache = lm.prefill(sp, prompt, scfg, max_len=P + n)
    else:
        pstep, (p_sds, t_sds), _ = build_prefill_step(
            cfg, ShapeConfig("p", "prefill", P, B), mesh)
        sp = rules.place_as(sp, p_sds)
        logits, cache = pstep(sp, rules.place_as(prompt, t_sds))
    out[f"{key}/prefill"] = _np(logits)
    for path, t in tree_paths(cache):
        if path.split("/")[-1] in ("k", "v"):      # its P prompt positions
            t = t[..., :P, :, :]
        out[f"{key}/prefill_cache/{path}"] = _np(t)
    if mesh is not None:
        dstep, (_, tok_sds, _, c_sds), _ = build_serve_step(
            cfg, ShapeConfig("d", "decode", P + n, B), mesh)
        cache = grow_cache(cache, c_sds)
    for i in range(n):
        pos = torch.tensor(P + i)
        if mesh is None:
            lg, cache = lm.decode_step(sp, dec[i], pos, cache, scfg)
        else:
            lg, cache = dstep(sp, rules.place_as(dec[i], tok_sds), pos, cache)
        out[f"{key}/decode{i}"] = _np(lg)
    for path, t in tree_paths(cache):
        out[f"{key}/cache/{path}"] = _np(t)

    n_steps = sum(1 for k in z.files
                  if k.startswith(f"{arch}/batch") and k.endswith("/tokens"))
    b0 = z[f"{arch}/batch0/tokens"]
    shape = ShapeConfig("t", "train", b0.shape[1], b0.shape[0])
    tp = lm.params_from_jax(_tree(z, f"{arch}/train/"), cfg, device="cpu")
    if mesh is None:
        step, _, opt = build_train_step(cfg, shape, lr=1e-3, device="cpu")
        state = opt.init(tp)
    else:
        step, (p_sds, o_sds, b_sds), opt = build_train_step(
            cfg, shape, mesh, lr=1e-3)
        tp, state = rules.place_as(tp, p_sds), rules.zeros(o_sds)
    for i in range(n_steps):
        batch = {k: torch.from_numpy(np.asarray(v, np.int64))
                 for k, v in _tree(z, f"{arch}/batch{i}/").items()}
        if mesh is not None:
            batch = rules.place_as(batch, b_sds)
        tp, state, m = step(tp, state, batch)
        out[f"{key}/loss{i}"] = np.float32(m["loss"])
        out[f"{key}/gnorm{i}"] = np.float32(m["gnorm"])
        for path, t in tree_paths({"params": tp, "opt": state}):
            out[f"{key}/step{i}/{path}"] = _np(t)


def _rank(rank: int, world: int, store: str, inp: str, outp: str,
          plain: bool) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    z = np.load(inp)
    out: dict = {}
    for arch in [str(a) for a in z["arch"]]:
        run_arch(z, arch, mesh, out, arch)
        if plain and rank == 0:
            run_arch(z, arch, None, out, f"plain/{arch}")
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
