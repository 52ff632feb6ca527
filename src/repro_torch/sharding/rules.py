"""Path-regex → partition spec rules for every param/cache/input tree (the
port's ``repro.sharding.rules``), and the DTensor placements they give.

Mesh axes: ("data", "model") on one pod, ("pod", "data", "model") on
several. The batch shards over every batch axis (pod + data); weights
shard over "model" (TP) and, in "2d" mode, also over "data" (FSDP-style),
which the archs above 8 B parameters need: their optimizer state cannot
replicate across the data axis.

Rules are ordered; the first match wins. A rule maps to a logical spec
whose axis names are resolved against the mesh (absent axes dropped) and
whose dims are checked against the leaf's shape: a dim that does not
divide falls back to replication, as in the reference.

**The torch counterpart.** A spec is a plain tuple with one entry per
tensor dim: ``None``, an axis name, or a tuple of axis names. It is
exactly ``tuple(P)`` of the reference's ``PartitionSpec``, so tests
compare the two directly. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (``launch/mesh.py``), or a :class:`MeshShape` where only the axis
names and sizes matter (spec tests at the production sizes, dry runs).
:func:`placements` turns a spec into DTensor placements, one per mesh dim
(``Shard(d)`` where the mesh dim's name shards tensor dim ``d``, else
``Replicate()``; a tensor dim over ``("pod", "data")`` is ``Shard(d)`` on
both, pod outer, the order JAX gives it). :func:`place` puts a tree on the
mesh by its specs (``distribute_tensor``), the counterpart of
``named_shardings`` plus ``jax.device_put``.

:func:`shard_batch` is the reference's sharding pin: under
:func:`use_mesh` it redistributes a DTensor activation to the batch
placement; outside a mesh, on a plain tensor or where the batch does not
divide it returns its input.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import LMConfig, ShapeConfig
from repro_torch.utils import tree_map, tree_map_with_path

PyTree = Any
Spec = tuple

BATCH = "__batch__"      # placeholder resolved to ("pod","data") / ("data",)
FSDP = "__fsdp__"        # placeholder: "data" in 2d mode, None in tp mode


class MeshShape(NamedTuple):
    """Axis names and sizes of a mesh, without devices or process groups:
    what the rules read of a ``DeviceMesh`` (the same two attributes)."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _batch_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
# (regex, spec-without-stack-axis). Stacked leaves (blocks/...) get leading
# None axes prepended from the ndim difference.

_PARAM_RULES: list[tuple[str, tuple | None]] = [
    # embeddings
    (r"embed/embedding$",            ("model", FSDP)),
    (r"embed/unembed$",              (FSDP, "model")),
    # norms and small vectors: replicate
    (r"(ln\d?|lnx|final_norm|enc_norm|q_norm|k_norm)$", None),
    (r"(A_log|D_skip|dt_bias)$",     ("model",)),
    (r"ssm/norm$",                   ("model",)),
    # attention
    (r"(attn|xattn)/wq$",            (FSDP, "model")),
    (r"(attn|xattn)/wk$",            (FSDP, "model")),
    (r"(attn|xattn)/wv$",            (FSDP, "model")),
    (r"(attn|xattn)/wo$",            ("model", FSDP)),
    # dense mlp
    (r"mlp/wg$",                     (FSDP, "model")),
    (r"mlp/wu$",                     (FSDP, "model")),
    (r"mlp/wd$",                     ("model", FSDP)),
    # moe: EP over the expert axis, or TP inside experts (chosen per config)
    (r"moe/router$",                 None),
    (r"moe/w[gu]$__EP",              ("model", None, FSDP)),
    (r"moe/wd$__EP",                 ("model", FSDP, None)),
    (r"moe/w[gu]$__TP",              (None, FSDP, "model")),
    (r"moe/wd$__TP",                 (None, "model", FSDP)),
    # ssm projections
    (r"ssm/wz$",                     (FSDP, "model")),
    (r"ssm/wx$",                     (FSDP, "model")),
    (r"ssm/wbc$",                    (FSDP, None)),
    (r"ssm/wdt$",                    (FSDP, "model")),
    (r"ssm/conv_wx$",                (None, "model")),
    (r"ssm/conv_bx$",                ("model",)),
    (r"ssm/conv_wbc$",               None),
    (r"ssm/conv_bbc$",               None),
    (r"ssm/out_proj$",               ("model", FSDP)),
]


def _moe_mode(cfg: LMConfig) -> str:
    tp = cfg.tp_multiple
    return "EP" if cfg.n_experts and cfg.n_experts % tp == 0 else "TP"


def _resolve(spec: tuple | None, mesh, fsdp_on: bool,
             shape: tuple[int, ...]) -> Spec:
    if spec is None:
        return ()
    axes = []
    sizes = axis_sizes(mesh)
    for dim, ax in enumerate(spec):
        if ax == FSDP:
            ax = "data" if fsdp_on else None
        if ax == BATCH:
            ax = batch_axes(mesh)
        if ax is None:
            axes.append(None)
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        names = tuple(n for n in names if n in sizes)
        if not names:
            axes.append(None)
            continue
        if shape[dim] % math.prod(sizes[n] for n in names) != 0:
            axes.append(None)           # fallback: replicate this dim
            continue
        axes.append(names if len(names) > 1 else names[0])
    return tuple(axes)


def param_pspecs(params: PyTree, cfg: LMConfig, mesh) -> PyTree:
    """Spec tree matching the param tree (leaves: anything with ``shape``
    and ``ndim``, e.g. ``meta`` tensors)."""
    fsdp_on = cfg.effective_weight_sharding() == "2d"
    moe_suffix = _moe_mode(cfg)

    def rule_for(path: str, leaf) -> Spec:
        for pat, spec in _PARAM_RULES:
            if "__" in pat:
                pat_base, mode = pat.split("__")
                if mode != moe_suffix:
                    continue
                pat = pat_base
            if re.search(pat, path):
                if spec is None:
                    return ()
                # prepend stack axes (stacked params have extra leading dims)
                extra = leaf.ndim - len(spec)
                full = (None,) * extra + tuple(spec)
                return _resolve(full, mesh, fsdp_on, tuple(leaf.shape))
        return ()   # default: replicate

    return tree_map_with_path(rule_for, params)


def zero1_pspecs(param_specs: PyTree, params: PyTree, mesh,
                 cfg: LMConfig) -> PyTree:
    """Optimizer-moment specs: the param's spec with one free dim sharded
    over "data".

    ZeRO-1: moments never need replication across the data axis; the
    first unsharded dim whose size divides the data axis (and is above 1)
    takes it. In 2d mode params already use "data"; specs pass through."""
    if not cfg.zero1 or cfg.effective_weight_sharding() == "2d":
        return param_specs
    if "data" not in mesh.mesh_dim_names:
        return param_specs
    dsize = axis_sizes(mesh)["data"]

    def shard_one(spec: Spec, leaf) -> Spec:
        axes = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, ax in enumerate(axes):
            if ax is None and leaf.shape[i] % dsize == 0 and leaf.shape[i] > 1:
                axes[i] = "data"
                return tuple(axes)
        return spec

    return spec_map(shard_one, param_specs, params)


# ---------------------------------------------------------------------------
# activations / inputs / caches
# ---------------------------------------------------------------------------

def _axes_entry(axes: tuple[str, ...]):
    """A spec entry over ``axes`` as ``PartitionSpec`` normalises it: the
    name alone, a tuple of several, or ``None`` for none."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def activation_pspec(mesh, *trailing) -> Spec:
    return (_axes_entry(batch_axes(mesh)),) + tuple(trailing)


def input_pspecs(cfg: LMConfig, shape: ShapeConfig, mesh) -> dict[str, Spec]:
    """Specs of the data batch (tokens / labels / frames / img_embed)."""
    b = batch_axes(mesh)
    bspec = (_axes_entry(b) if shape.global_batch % max(_batch_size(mesh), 1)
             == 0 else None)
    out = {"tokens": (bspec, None), "labels": (bspec, None)}
    if cfg.family == "vlm":
        out["img_embed"] = (bspec, None, None)
    if cfg.is_encdec:
        out["frames"] = (bspec, None, None)
    return out


def cache_pspecs(cache: PyTree, cfg: LMConfig, mesh,
                 global_batch: int) -> PyTree:
    """KV/SSM cache specs. The batch shards over (pod, data) when it
    divides; otherwise (long_500k, B=1) the *sequence* axis of attention
    caches shards over "data" and SSM states replicate across data."""
    b = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    batch_ok = global_batch % max(_batch_size(mesh), 1) == 0
    bspec = _axes_entry(b) if batch_ok else None
    model = sizes.get("model", 1)

    def spec_for(path: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if path in ("k", "v") or path.endswith("/k") or path.endswith("/v"):
            # [*stack, B, S, KV, hd]
            extra = leaf.ndim - 4
            sspec = None
            if not batch_ok and shape[extra + 1] % sizes.get("data", 1) == 0:
                sspec = "data"
            kvspec = "model" if shape[extra + 2] % model == 0 else None
            return (None,) * extra + (bspec, sspec, kvspec, None)
        if path.endswith("state"):       # [*stack, B, nh, hp, N]
            extra = leaf.ndim - 4
            return (None,) * extra + (
                bspec, "model" if shape[extra + 1] % model == 0 else None,
                None, None)
        if "conv_x" in path:             # [*stack, B, K-1, di]
            extra = leaf.ndim - 3
            return (None,) * extra + (
                bspec, None, "model" if shape[extra + 2] % model == 0
                else None)
        if "conv_bc" in path:
            extra = leaf.ndim - 3
            return (None,) * extra + (bspec, None, None)
        return ()

    return tree_map_with_path(spec_for, cache)


# ---------------------------------------------------------------------------
# DTensor placements and placing
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the mesh dim's name appears in tensor dim ``d``'s
    entry, ``Replicate()`` where it appears in none or where the mesh dim
    has one rank (a shard over one rank is the whole tensor: at (1, 1)
    every placement replicates). A name used by two tensor dims raises, as
    ``NamedSharding`` does."""
    from torch.distributed.tensor import Replicate, Shard
    owner: dict[str, int] = {}
    for d, ax in enumerate(spec):
        for name in (ax if isinstance(ax, tuple) else
                     () if ax is None else (ax,)):
            if name in owner:
                raise ValueError(f"spec {spec}: mesh axis {name!r} shards "
                                 f"dims {owner[name]} and {d}")
            owner[name] = d
    unknown = set(owner) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names {sorted(unknown)}, not axes of "
                         f"the mesh {mesh.mesh_dim_names}")
    sizes = axis_sizes(mesh)
    return tuple(Shard(owner[n]) if n in owner and sizes[n] > 1
                 else Replicate() for n in mesh.mesh_dim_names)


def spec_map(fn, spec_tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn(spec, *leaves)`` over a spec tree (specs are tuples, so a plain
    tree map would walk into them)."""
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    return fn(spec_tree, *rest)


def place(tree: PyTree, spec_tree: PyTree, mesh) -> PyTree:
    """Each leaf of ``tree`` (the full tensor, the same on every rank) as a
    DTensor on ``mesh`` with its spec's placements. Every rank keeps its
    own slice of its own copy (``src_data_rank=None``): nothing is sent.
    ``tree`` may hold fewer keys than ``spec_tree``."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, spec: distribute_tensor(
        t, mesh, placements(spec, mesh), src_data_rank=None), tree, spec_tree)


def place_as(tree: PyTree, struct_tree: PyTree) -> PyTree:
    """:func:`place` by a :class:`Struct` tree's specs and mesh."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, s: distribute_tensor(
        t, s.mesh, s.placements, src_data_rank=None), tree, struct_tree)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "placements") else t


def gather(tree: PyTree) -> PyTree:
    """Every DTensor leaf as its full tensor (``full_tensor()``); other
    leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


@dataclass(frozen=True)
class Struct:
    """A leaf of a step's argument structures (the reference's
    ``ShapeDtypeStruct`` with a ``NamedSharding``): a ``meta`` tensor of
    the global shape and dtype, its spec and its mesh. Nothing is
    allocated."""
    meta: torch.Tensor
    spec: Spec
    mesh: Any

    @property
    def shape(self) -> torch.Size:
        return self.meta.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def structs(meta_tree: PyTree, spec_tree: PyTree, mesh) -> PyTree:
    """A :class:`Struct` tree from a ``meta`` tree and its specs."""
    return spec_map(lambda spec, t: Struct(t, spec, mesh), spec_tree,
                    meta_tree)


def specs_of(struct_tree: PyTree) -> PyTree:
    return tree_map(lambda s: s.spec, struct_tree)


def zeros(struct_tree: PyTree) -> PyTree:
    """Zero DTensors of a :class:`Struct` tree, each rank allocating only
    its own shard (a step's fresh cache)."""
    from torch.distributed.tensor import zeros as dzeros
    return tree_map(lambda s: dzeros(tuple(s.shape), dtype=s.dtype,
                                     device_mesh=s.mesh,
                                     placements=s.placements), struct_tree)


# ---------------------------------------------------------------------------
# the ambient mesh and the batch pin
# ---------------------------------------------------------------------------

_AMBIENT = threading.local()


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return getattr(_AMBIENT, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """The reference's ``with mesh:``: :func:`shard_batch` pins to
    ``mesh`` inside."""
    prev = current_mesh()
    _AMBIENT.mesh = mesh
    try:
        yield mesh
    finally:
        _AMBIENT.mesh = prev


def shard_batch(x: torch.Tensor, *trailing) -> torch.Tensor:
    """Pin the leading (batch) axis of an activation to ("pod", "data"),
    the rest to ``trailing`` (``None`` or an axis name per dim; unnamed
    dims replicate).

    The reference pins the scan carry at each layer boundary so GSPMD
    never runs the full batch on every device; under DTensor the pin is
    an explicit ``redistribute`` at the same points. A no-op outside
    :func:`use_mesh`, on a plain tensor, or when the batch does not divide
    (long_500k's B=1)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    axes = batch_axes(mesh)
    n = _batch_size(mesh)
    if not axes or n <= 1 or x.shape[0] % n != 0:
        return x
    spec = (_axes_entry(axes),) + tuple(trailing[:x.ndim - 1])
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_placements(mesh, shape: tuple[int, ...], batch_dim: int | None,
                     model_dim: int | None) -> tuple:
    """Placements for a per-shard kernel call (``local_map``): tensor dim
    ``batch_dim`` over the batch axes and ``model_dim`` over "model", each
    where its size divides, every other mesh dim (and any of one rank)
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    nb = _batch_size(mesh)
    out = []
    for name in mesh.mesh_dim_names:
        if sizes[name] == 1:
            out.append(Replicate())
        elif (name in batch_axes(mesh) and batch_dim is not None
                and shape[batch_dim] % nb == 0):
            out.append(Shard(batch_dim))
        elif (name == "model" and model_dim is not None
              and shape[model_dim] % sizes["model"] == 0):
            out.append(Shard(model_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (a plain tensor the same on every rank: positions, a mask) as
    a replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor, so
    the two can meet in one op; else ``t``."""
    mesh = getattr(ref, "device_mesh", None)
    if mesh is None or hasattr(t, "placements"):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def head_placements(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """(q's, k's and v's) placements for attention on local shards: the
    batch over the batch axes and the heads (dim 2) over "model" when both
    q's and k's head counts divide it, so a query head's kv head ``h // G``
    stays on its rank."""
    mesh = q.device_mesh
    model = axis_sizes(mesh).get("model", 1)
    heads = 2 if q.shape[2] % model == 0 and k.shape[2] % model == 0 else None
    return (local_placements(mesh, q.shape, 0, heads),
            local_placements(mesh, k.shape, 0, heads))


def check_placed(name: str, t: torch.Tensor, sds: Struct) -> None:
    """Raise unless ``t`` has ``sds``'s global shape and placements."""
    if (tuple(t.shape) != tuple(sds.shape)
            or tuple(getattr(t, "placements", ())) != sds.placements):
        raise ValueError(f"{name} is {tuple(t.shape)} placed "
                         f"{getattr(t, 'placements', 'as a plain tensor')}; "
                         f"the step takes {tuple(sds.shape)} placed "
                         f"{sds.placements}")
