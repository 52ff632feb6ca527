"""PyTorch port, the sharding layer against the reference's on the CPU:
the config knobs, ``_resolve``'s fallback, and for every config of the
registry at full width on the meshes (1, 1), (2, 2), (2, 16), (16, 16)
and (2, 16, 16) the shape, dtype and spec of every leaf of the params,
the AdamW moments (ZeRO-1 and "2d"), the batch (with ``img_embed`` and
``frames``) and the serving cache (batch- and sequence-sharded). The
reference's specs come from its rules on its own duplicate-device mesh
(tests/test_sharding_optim.py), the port's from ``rules.MeshShape``
meshes; DeviceMesh placements are checked on the fake backend at the two
production sizes and per rank at (2, 2, 2) against
``NamedSharding.devices_indices_map``, each in a subprocess
(tests/sharding_slices.py). The builders at one rank are bit-identical
to the port's unsharded path (the one-rank host group in this process).
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import SHAPES as J_SHAPES
from repro.models import encdec as j_encdec
from repro.models import lm as j_lm
from repro.optim import adamw as j_adamw
from repro.serve.steps import serve_config as j_serve_config
from repro.sharding import rules as jr
from repro.utils import tree_paths as j_tree_paths
from repro_torch.configs import get_config, list_archs, smoke_variant
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.serve.steps import cache_structs, serve_config
from repro_torch.sharding import rules
from repro_torch.train.steps import make_batch_specs, opt_structs, param_structs
from repro_torch.utils import tree_paths
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = list_archs()
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x16": ((2, 16), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
HERE = os.path.dirname(__file__)
# the port's token ids are int64 (torch's index type), the reference's
# int32; every float leaf has the reference's dtype
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int64}


def _j_mesh(key: str) -> Mesh:
    """The reference's duplicate-device mesh (its spec tests' own)."""
    shape, axes = MESHES[key]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


def _mesh(key: str) -> rules.MeshShape:
    return rules.MeshShape(*MESHES[key])


@functools.lru_cache(maxsize=None)
def _j_shapes(arch: str):
    cfg = j_get_config(arch)
    mod = j_encdec if cfg.is_encdec else j_lm
    shapes = jax.eval_shape(functools.partial(mod.init_params, cfg=cfg),
                            jax.random.PRNGKey(0))
    return shapes, jax.eval_shape(j_adamw(1e-3).init, shapes)


def _same(got: dict, want: dict, what: str) -> None:
    """``got``: {path: rules.Struct}; ``want``: {path: (sds, P)}."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for path, s in got.items():
        sds, spec = want[path]
        assert tuple(s.shape) == tuple(sds.shape), (what, path)
        assert s.dtype == _DTYPES[str(sds.dtype)], (what, path, s.dtype)
        assert s.spec == tuple(spec), (what, path, s.spec, spec)


def test_config_knobs_match_the_reference():
    """weight_sharding, zero1, param_count_est and the effective mode for
    all ten configs and their smoke variants; grok-1-314b and
    llama-3.2-vision-90b are "2d", the smoke variants zero1=False "tp"."""
    for arch in ARCHS:
        for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                          (smoke_variant(get_config(arch)),
                           j_smoke(j_get_config(arch)))):
            assert (cfg.weight_sharding, cfg.zero1) == (jcfg.weight_sharding,
                                                        jcfg.zero1)
            assert cfg.param_count_est() == jcfg.param_count_est()
            assert (cfg.effective_weight_sharding()
                    == jcfg.effective_weight_sharding())
    for arch in ("grok-1-314b", "llama-3.2-vision-90b"):
        assert get_config(arch).weight_sharding == "2d"
    s = smoke_variant(get_config("grok-1-314b"))
    assert (s.zero1, s.weight_sharding) == (False, "tp")


@pytest.mark.parametrize("spec,mesh,fsdp,shape", [
    (("model", None), "2x3", False, (7, 4)),
    (("model", None), "2x3", False, (9, 4)),
    ((jr.FSDP, "model"), "2x2", True, (6, 4)),
    ((jr.FSDP, "model"), "2x2", False, (6, 4)),
    ((jr.FSDP, "model"), "2x2", True, (5, 4)),
    ((jr.BATCH, None), "2x16x16", False, (8, 3)),
    ((jr.BATCH, None), "2x16x16", False, (6, 3)),
    ((("pod", "data"), "model"), "2x16", False, (4, 32)),
    (None, "2x2", False, (4,)),
])
def test_resolve_fallback_matches_the_reference(spec, mesh, fsdp, shape):
    """Divisible dims shard, the rest replicate, absent axes drop, the
    placeholders resolve: case by case as the reference's ``_resolve``."""
    meshes = dict(MESHES, **{"2x3": ((2, 3), ("data", "model"))})
    dims, axes = meshes[mesh]
    n = int(np.prod(dims))
    jm = Mesh(np.array(jax.devices() * n)[:n].reshape(dims), axes)
    want = jr._resolve(spec, jm, fsdp, shape)
    assert rules._resolve(spec, rules.MeshShape(dims, axes), fsdp,
                          shape) == tuple(want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_match_the_reference(arch, mesh):
    """param_structs / opt_structs: every param leaf and every AdamW
    moment (``zero1_pspecs``: ZeRO-1, or the param's own spec in "2d"
    mode) has the reference's shape, dtype and spec; ``step``
    replicates."""
    cfg, jcfg, m, jm = get_config(arch), j_get_config(arch), _mesh(mesh), \
        _j_mesh(mesh)
    shapes, jopt = _j_shapes(arch)
    jspecs = jr.param_pspecs(shapes, jcfg, jm)
    jflat = dict(j_tree_paths(jspecs))
    p, specs = param_structs(cfg, m)
    _same(dict(tree_paths(p)), {k: (v, jflat[k])
                                for k, v in j_tree_paths(shapes)}, "params")
    o, _ = opt_structs(adamw(1e-3), p, specs, cfg, m)
    jmom = dict(j_tree_paths(jr.zero1_pspecs(jspecs, shapes, jm, jcfg)))
    for k in ("mu", "nu"):
        _same(dict(tree_paths(o[k])), {path: (v, jmom[path]) for path, v in
                                       j_tree_paths(jopt[k])}, k)
    assert o["step"].spec == () and o["step"].shape == ()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch, mesh):
    """make_batch_specs at every SHAPES entry (img_embed for the vlm,
    frames for the enc-dec), and cache_structs of the serving config at a
    batch that divides the batch axes (batch-sharded) and at batch 1
    (sequence-sharded where the positions divide "data")."""
    cfg, jcfg, m, jm = get_config(arch), j_get_config(arch), _mesh(mesh), \
        _j_mesh(mesh)
    for name, shape in SHAPES.items():
        js = J_SHAPES[name]
        got = make_batch_specs(cfg, shape, m)
        want = jr.input_pspecs(jcfg, js, jm)
        assert set(got) == set(want)
        for k, s in got.items():
            assert s.spec == tuple(want[k]), (name, k)
            assert s.shape[0] == js.global_batch
    nb = int(np.prod([n for n, a in zip(*MESHES[mesh])
                      if a in ("pod", "data")]))
    scfg, jscfg = serve_config(cfg), j_serve_config(jcfg)
    for batch in (2 * nb, 1):
        got = cache_structs(scfg, m, batch, 64, enc_len=32)
        if jscfg.is_encdec:
            c = jax.eval_shape(functools.partial(j_encdec.init_cache, jscfg,
                                                 batch, 64, 32))
        else:
            c = jax.eval_shape(functools.partial(j_lm.init_cache, jscfg,
                                                 batch, 64))
        jflat = dict(j_tree_paths(jr.cache_pspecs(c, jscfg, jm, batch)))
        _same(dict(tree_paths(got)), {k: (v, jflat[k]) for k, v in
                                      j_tree_paths(c)}, f"cache{batch}")


def test_placements_of_specs():
    """A dim over ("pod", "data") is Shard on both, pod outer; an axis the
    spec does not name replicates; an axis used twice or unknown raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = _mesh("2x16x16")
    assert rules.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements((None, "data"), m) == (Replicate(), Shard(1),
                                                   Replicate())
    assert rules.placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="shards dims"):
        rules.placements(("data", "data"), m)
    with pytest.raises(ValueError, match="not axes"):
        rules.placements(("pipe",), m)


def _run(args: list[str], env: dict | None = None) -> str:
    r = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, **(env or {})))
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


_FAKE = """
import sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import math
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.sharding import rules
from sharding_slices import _port_leaves
shape, axes = {shape!r}, {axes!r}
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=math.prod(shape))
mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
flat = _port_leaves(mesh)
same = _port_leaves(rules.MeshShape(shape, axes))
n = 0
for key, s in flat.items():
    assert s.spec == same[key].spec, key
    local, _ = compute_local_shape_and_global_offset(
        tuple(s.shape), mesh, s.placements)
    sizes = dict(zip(axes, shape))
    for d, (g, l) in enumerate(zip(s.shape, local)):
        ax = s.spec[d] if d < len(s.spec) else None
        names = ax if isinstance(ax, tuple) else (() if ax is None
                                                   else (ax,))
        assert l * math.prod(sizes[a] for a in names) == g, (key, d)
    n += 1
print(n, mesh.mesh_dim_names, tuple(mesh.shape))
"""


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_placements_on_the_fake_production_meshes(mesh):
    """On a DeviceMesh of the fake backend at 256 / 512 ranks (in a
    subprocess): every leaf's spec equals the MeshShape's, and DTensor's
    local shape of each is its global shape divided by the axes that
    shard it."""
    shape, axes = MESHES[mesh]
    out = _run(["-c", _FAKE.format(src=os.path.join(HERE, "..", "src"),
                                   tests=HERE, shape=shape, axes=axes)])
    n, names, dims = out.split(" ", 1)[0], axes, shape
    assert int(n) > 300 and f"{names} {dims}" in out


def test_rank_slices_match_devices_indices_map(tmp_path):
    """On a (2, 2, 2) mesh the slice every rank holds of every leaf (ten
    configs at full width: params, moments, batch, caches) equals the
    reference's ``NamedSharding.devices_indices_map`` on 8 forced host
    devices; distribute_tensor's local values are those slices."""
    ref, port = tmp_path / "ref.json", tmp_path / "port.json"
    _run([os.path.join(HERE, "sharding_slices.py"), "ref", str(ref)],
         {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
          "JAX_PLATFORMS": "cpu"})
    out = _run([os.path.join(HERE, "sharding_slices.py"), "port",
                str(port)])
    assert "values checked on" in out
    want, got = json.loads(ref.read_text()), json.loads(port.read_text())
    assert len(want) > 300 and set(got) == set(want)
    for key, slices in want.items():
        assert got[key] == slices, key


def test_shard_batch_and_kernel_wrappers():
    """shard_batch returns its input outside a mesh and on plain tensors;
    the K5 and K6 launchers refuse a DTensor (the one-rank host group)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        gqa_attention_cuda)
    from repro_torch.kernels.ssd.ssd import ssd_cuda
    from repro_torch.launch.mesh import make_host_mesh
    x = torch.ones(4, 2)
    assert rules.shard_batch(x) is x
    mesh = make_host_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    with rules.use_mesh(mesh):
        assert rules.shard_batch(x) is x
    t = rules.place({"d": torch.zeros(1, 4, 2, 16), "a": torch.zeros(2)},
                    {"d": ("data", None, "model", None), "a": ("model",),
                     "unused": ()}, mesh)
    d, a = t["d"], t["a"]
    assert d.placements == rules.placements(("data", None, "model", None),
                                            mesh)
    with pytest.raises(TypeError, match="DTensor"):
        gqa_attention_cuda(d, d, d)
    with pytest.raises(TypeError, match="DTensor"):
        ssd_cuda(d, d[..., 0], a, d, d)


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-780m",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2",
                                  "internlm2-1.8b+pad"])
def test_builders_at_one_rank_are_bit_identical(arch):
    """On the (1, 1) host mesh every placement replicates, so the same
    aten ops see the same tensors: build_prefill_step (with img_embed /
    frames), two build_serve_step steps and two build_train_step steps
    give the unsharded path's bits (logits, every cache leaf, loss,
    gnorm, every param and moment). ``+pad``: a vocabulary of 250 padded
    to 256 (the logits' pad mask on a DTensor)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import encdec, lm
    from repro_torch.serve.steps import (build_prefill_step, build_serve_step,
                                         grow_cache)
    from repro_torch.train.steps import build_train_step
    from repro_torch.utils import tree_map
    mesh = make_host_mesh(device="cpu")
    cfg = smoke_variant(get_config(arch.removesuffix("+pad")))
    if arch.endswith("+pad"):
        cfg = replace(cfg, vocab_size=250)
    assert cfg.phys_vocab != cfg.vocab_size or not arch.endswith("+pad")
    mod = encdec if cfg.is_encdec else lm
    B, S, n = 2, 16, 2
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + n), generator=g)
    pstep, (p_sds, t_sds, *ex), scfg = build_prefill_step(
        cfg, ShapeConfig("p", "prefill", S, B), mesh)
    extra = [torch.randn(tuple(e.shape), generator=g).to(e.dtype)
             for e in ex]
    params = mod.init_params(torch.Generator().manual_seed(0), scfg, "cpu")
    dp = rules.place_as(params, p_sds)
    logits, cache = pstep(dp, rules.place_as(tokens[:, :S], t_sds),
                          *(rules.place_as(e, s) for e, s in zip(extra, ex)))
    if cfg.is_encdec:
        ref, rc = mod.prefill(params, extra[0], tokens[:, :S], scfg,
                              max_len=S + n)
    else:
        ref, rc = mod.prefill(params, tokens[:, :S], scfg,
                              img_embed=extra[0] if extra else None,
                              max_len=S + n)
    assert torch.equal(logits.full_tensor(), ref)
    if cfg.is_encdec:
        # the serve step's cross cache holds as many positions as its self
        # cache (the reference's build_serve_step: enc_len = seq_len); the
        # grown cache pads the prefill's with zero keys, and so does this
        rc["cross"] = tree_map(lambda t: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, n)), rc["cross"])
    dstep, (_, tok_sds, _, c_sds), _ = build_serve_step(
        cfg, ShapeConfig("d", "decode", S + n, B), mesh)
    cache = grow_cache(cache, c_sds)
    for i in range(n):
        pos = torch.tensor(S + i)
        tok = tokens[:, S + i:S + i + 1]
        lg, cache = dstep(dp, rules.place_as(tok, tok_sds), pos, cache)
        want, rc = mod.decode_step(params, tok, pos, rc, scfg)
        assert torch.equal(lg.full_tensor(), want), i
    for (path, a), (_, b) in zip(tree_paths(cache), tree_paths(rc)):
        assert torch.equal(a.full_tensor(), b), path

    cfg = replace(cfg, compute_dtype="float32")
    shape = ShapeConfig("t", "train", 32, B)
    step, (p_sds, o_sds, b_sds), opt = build_train_step(cfg, shape, mesh,
                                                        lr=1e-3)
    ustep, specs, uopt = build_train_step(cfg, shape, lr=1e-3, device="cpu")
    up = mod.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    dp = rules.place_as(tree_map(torch.clone, up), p_sds)
    do, uo = rules.zeros(o_sds), uopt.init(up)
    for i in range(2):
        batch = {k: (torch.randint(0, cfg.vocab_size, tuple(v.shape),
                                   generator=g) if v.dtype == torch.int64
                     else torch.randn(tuple(v.shape), generator=g))
                 for k, v in specs.items()}
        dp, do, m = step(dp, do, rules.place_as(batch, b_sds))
        up, uo, um = ustep(up, uo, batch)
        for k in ("loss", "gnorm"):
            assert torch.equal(m[k], um[k]), (i, k)
    for (path, a), (_, b) in zip(tree_paths({"p": dp, "o": do}),
                                 tree_paths({"p": up, "o": uo})):
        assert torch.equal(a.full_tensor(), b), path
