"""Per-rank slices of every leaf on a (2, 2, 2) ("pod", "data", "model")
mesh, from either package (not collected: no ``test_`` prefix).

    python tests/sharding_slices.py ref OUT.json    # JAX, 8 host devices
    python tests/sharding_slices.py port OUT.json   # DTensor, fake ranks

The leaves are those of every config of the registry at full width: the
params, the AdamW moments, the train_4k batch and the serving cache at
batch 4 (batch-sharded) and batch 1 (sequence-sharded), 64 positions.
``ref`` reads ``NamedSharding.devices_indices_map`` (``XLA_FLAGS`` must
force 8 host devices); ``port`` starts the ``"fake"`` backend once per
rank in this process and reads DTensor's local shape and offset, then
distributes a smoke config's params and cache (arange values) with
``distribute_tensor`` and checks each rank's local values against its
slice. Both write ``{"<arch>/<kind>/<path>": [[[start, stop], ...] per
rank]}``, ranks in the mesh's row-major order.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

SHAPE = (2, 2, 2)
AXES = ("pod", "data", "model")
CACHE_LEN = 64


def _ref(out: str) -> None:
    from functools import partial

    import jax
    from jax.sharding import NamedSharding

    from repro.configs import get_config, list_archs
    from repro.configs.base import SHAPES
    from repro.models import encdec, lm
    from repro.optim import adamw
    from repro.serve.steps import serve_config
    from repro.sharding import rules
    from repro.utils import tree_paths
    mesh = jax.make_mesh(SHAPE, AXES)
    coord = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}
    res = {}

    def put(key, sds, spec):
        m = NamedSharding(mesh, spec).devices_indices_map(tuple(sds.shape))
        by = sorted(m.items(), key=lambda kv: coord[kv[0]])
        res[key] = [[list(s.indices(n)[:2]) for s, n in zip(sl, sds.shape)]
                    for _, sl in by]

    for arch in list_archs():
        cfg = get_config(arch)
        mod = encdec if cfg.is_encdec else lm
        shapes = jax.eval_shape(partial(mod.init_params, cfg=cfg),
                                jax.random.PRNGKey(0))
        specs = rules.param_pspecs(shapes, cfg, mesh)
        mom = rules.zero1_pspecs(specs, shapes, mesh, cfg)
        opt = jax.eval_shape(adamw(1e-3).init, shapes)
        for kind, tree, sp in (("params", shapes, specs),
                               ("mu", opt["mu"], mom)):
            flat = dict(tree_paths(sp))
            for path, sds in tree_paths(tree):
                put(f"{arch}/{kind}/{path}", sds, flat[path])
        shape = SHAPES["train_4k"]
        ins = rules.input_pspecs(cfg, shape, mesh)
        for k, spec in ins.items():
            dims = ((shape.global_batch, shape.seq_len) if k in
                    ("tokens", "labels") else (shape.global_batch, 1, 1))
            put(f"{arch}/batch/{k}", jax.ShapeDtypeStruct(dims, np.int32),
                spec)
        scfg = serve_config(cfg)
        for b in (4, 1):
            if cfg.is_encdec:
                c = jax.eval_shape(partial(encdec.init_cache, scfg, b,
                                           CACHE_LEN, CACHE_LEN))
            else:
                c = jax.eval_shape(partial(lm.init_cache, scfg, b,
                                           CACHE_LEN))
            flat = dict(tree_paths(rules.cache_pspecs(c, scfg, mesh, b)))
            for path, sds in tree_paths(c):
                put(f"{arch}/cache{b}/{path}", sds, flat[path])
    with open(out, "w") as f:
        json.dump(res, f)


def _port_leaves(mesh) -> dict:
    """{key: Struct} of every leaf, built on ``mesh``."""
    from dataclasses import replace

    import torch  # noqa: F401

    from repro_torch.configs import get_config, list_archs
    from repro_torch.configs.base import SHAPES
    from repro_torch.optim import adamw
    from repro_torch.serve.steps import cache_structs, serve_config
    from repro_torch.train.steps import (make_batch_specs, opt_structs,
                                         param_structs)
    from repro_torch.utils import tree_paths
    out = {}
    for arch in list_archs():
        cfg = get_config(arch)
        p, specs = param_structs(cfg, mesh)
        o, _ = opt_structs(adamw(1e-3), p, specs, cfg, mesh)
        for kind, tree in (("params", p), ("mu", o["mu"])):
            for path, s in tree_paths(tree):
                out[f"{arch}/{kind}/{path}"] = s
        b = make_batch_specs(cfg, SHAPES["train_4k"], mesh)
        for k, s in b.items():
            if k not in ("tokens", "labels"):
                # the extras' trailing dims do not shard; keep them small
                s = replace(s, meta=s.meta.new_empty(
                    (s.shape[0], 1, 1)))
            out[f"{arch}/batch/{k}"] = s
        for n in (4, 1):
            for path, s in tree_paths(cache_structs(serve_config(cfg), mesh,
                                                    n, CACHE_LEN)):
                out[f"{arch}/cache{n}/{path}"] = s
    return out


def _check_values(mesh, rank: int) -> int:
    """distribute_tensor of arange-valued smoke params and caches: each
    rank's local tensor is its slice of the global one."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.serve.steps import cache_structs
    from repro_torch.train.steps import param_structs
    from repro_torch.utils import tree_paths
    n = 0
    for arch in ("internlm2-1.8b", "mamba2-780m", "llama-3.2-vision-90b"):
        cfg = smoke_variant(get_config(arch))
        leaves = tree_paths({"p": param_structs(cfg, mesh)[0],
                             "c": cache_structs(cfg, mesh, 4, 8)})
        for path, s in leaves:
            full = torch.arange(s.meta.numel(),
                                dtype=torch.float64).reshape(s.shape)
            local = distribute_tensor(full, mesh, s.placements,
                                      src_data_rank=None).to_local()
            shp, off = compute_local_shape_and_global_offset(
                tuple(s.shape), mesh, s.placements)
            want = full[tuple(slice(o, o + k) for o, k in zip(off, shp))]
            assert torch.equal(local, want), (arch, path, rank)
            n += 1
    return n


def _port(out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = int(np.prod(SHAPE))
    res: dict = {}
    checked = 0
    for rank in range(world):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=AXES)
        for key, s in _port_leaves(mesh).items():
            shp, off = compute_local_shape_and_global_offset(
                tuple(s.shape), mesh, s.placements)
            res.setdefault(key, []).append(
                [[o, o + k] for o, k in zip(off, shp)])
        checked += _check_values(mesh, rank)
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    print(f"values checked on {checked} (leaf, rank) pairs")


if __name__ == "__main__":
    {"ref": _ref, "port": _port}[sys.argv[1]](sys.argv[2])
