"""Declarative variant-axis registry for the co-design sweep grid — the
PyTorch port's own copy of ``repro.core.variant_grid`` (pure Python over
the port's :class:`~repro_torch.core.leakage.LeakageConfig`).

The paper's deliverable is a trade-off surface over circuit config ×
T_INTG, but the real design space is wider: the Tri-Design follow-up
(arXiv:2304.02968) sweeps technology/circuit knobs like comparator
threshold and process variation. This module generalizes the engine's
hard-coded circuit × null_mismatch expansion into a REGISTRY of variant
axes, each declaring

  * how a value applies to a :class:`~repro_torch.core.leakage.LeakageConfig`
    (``apply``),
  * which circuits it is meaningful for (``applies_to`` — e.g. nullifier
    mismatch only exists on circuit (c)),
  * how it labels a variant (``label_part``) and reports into the
    per-record ``"variant"`` dict of the v3 artifact (``value_of``),
  * the default value grid the sweep CLI uses when ``--axes <name>``
    activates the axis without explicit values (``cli_defaults``).

Axes come in two execution classes:

  ``stacked=True``   values only change *numbers* (leak linearization,
                     comparator threshold) — they expand into the flat
                     stacked ``[n_cfg]`` variant axis that the batched
                     finetune/eval loops over within one outer cell;
  ``stacked=False``  values change tensor *shapes* (``n_sub`` — event
                     sub-slots per window) — they join T_INTG in the
                     outer python loop.

Adding an axis = adding one registry entry (plus, if it is a new leakage
knob, the corresponding ``LeakageConfig`` field and its fold into
``LeakCoeffs``); the sweep engine, labels, artifact schema, and CLI pick
it up from the registry.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Sequence

from repro_torch.core.leakage import (
    CircuitConfig, LeakageConfig, resolve_v_threshold,
)


@dataclass(frozen=True)
class VariantAxis:
    """One sweepable knob of the circuit-variant grid."""
    name: str                                  # SweepGrid field / artifact key
    apply: Callable[[LeakageConfig, Any], LeakageConfig]
    value_of: Callable[[LeakageConfig], Any]   # value stored on a variant
    label_part: Callable[[LeakageConfig], str | None]  # None → no suffix
    cli_defaults: tuple                        # grid used by --axes <name>
    applies_to: Callable[[LeakageConfig], bool] = lambda lc: True
    stacked: bool = True                       # False → outer python loop
    help: str = ""

    @property
    def cli(self) -> str:
        return self.name.replace("_", "-")


def _fmt(v: float) -> str:
    return f"{v:g}"


# Registry order is label order and expansion order — null_mismatch first so
# the pre-registry labels ("c@m=0.06") are reproduced exactly for default
# grids.
AXES: tuple[VariantAxis, ...] = (
    VariantAxis(
        name="null_mismatch",
        apply=lambda lc, m: replace(lc, null_mismatch=m),
        value_of=lambda lc: lc.null_mismatch,
        label_part=lambda lc: (f"m={_fmt(lc.null_mismatch)}"
                               if lc.circuit == CircuitConfig.NULLIFIED
                               else None),
        applies_to=lambda lc: lc.circuit == CircuitConfig.NULLIFIED,
        cli_defaults=(0.02, 0.06, 0.2),
        help="nullifier current-mismatch fraction (circuit (c) only)"),
    VariantAxis(
        name="v_threshold",
        apply=lambda lc, v: replace(lc, v_threshold=v),
        value_of=lambda lc: lc.v_threshold,
        label_part=lambda lc: (f"vt={_fmt(lc.v_threshold)}"
                               if lc.v_threshold is not None else None),
        cli_defaults=(0.01, 0.02),
        help="comparator threshold override (V); unset → model default"),
    VariantAxis(
        name="sigma",
        apply=lambda lc, s: replace(lc, sigma=s),
        value_of=lambda lc: lc.sigma,
        label_part=lambda lc: (f"s={_fmt(lc.sigma)}" if lc.sigma else None),
        cli_defaults=(0.0, 0.1),
        help="process-variation sigma on the per-filter leak taus"),
    VariantAxis(
        name="n_sub",
        apply=lambda lc, n: lc,       # shape axis: lives on P2MConfig
        value_of=lambda lc: None,     # filled by the engine per outer cell
        label_part=lambda lc: None,
        cli_defaults=(2, 4),
        stacked=False,
        help="event sub-slots per integration window (shape-changing: "
             "joins T_INTG in the outer loop)"),
)

STACKED_AXES: tuple[VariantAxis, ...] = tuple(a for a in AXES if a.stacked)
OUTER_AXES: tuple[VariantAxis, ...] = tuple(a for a in AXES if not a.stacked)


def axis(name: str) -> VariantAxis:
    """Registry lookup by field name or kebab-case CLI name."""
    key = name.replace("-", "_")
    for a in AXES:
        if a.name == key:
            return a
    raise KeyError(f"unknown variant axis {name!r} "
                   f"(registered: {[a.name for a in AXES]})")


def expand_variants(grid, base: LeakageConfig) -> tuple[LeakageConfig, ...]:
    """Flatten circuits × every active stacked axis into the flat variant
    list that becomes the stacked ``[n_cfg]`` engine axis.

    ``grid`` carries one tuple of values per axis name (empty → axis not
    swept, variants keep ``base``'s value). An axis only multiplies the
    circuits it applies to — e.g. mismatch variants of circuits (a)/(b)
    would be duplicates, so ``applies_to`` skips them.
    """
    out: list[LeakageConfig] = []
    for c in grid.circuits:
        variants = [replace(base, circuit=c)]
        for ax in STACKED_AXES:
            values = tuple(getattr(grid, ax.name, ()) or ())
            if not values:
                continue
            nxt: list[LeakageConfig] = []
            for lc in variants:
                if ax.applies_to(lc):
                    nxt.extend(ax.apply(lc, v) for v in values)
                else:
                    nxt.append(lc)
            variants = nxt
        out.extend(variants)
    return tuple(out)


def variant_label(lc: LeakageConfig) -> str:
    """Human/record label: circuit value + one ``@``-joined suffix per axis
    that deviates from the un-swept default (registry order)."""
    parts = [lc.circuit.value]
    for ax in STACKED_AXES:
        p = ax.label_part(lc)
        if p is not None:
            parts.append(p)
    return "@".join(parts)


def variant_dict(lc: LeakageConfig, *, v_threshold_default: float,
                 n_sub: int) -> dict:
    """The per-record ``"variant"`` dict of the v3 artifact: every
    registered axis resolved to the value this record actually ran with."""
    out: dict[str, Any] = {"circuit": lc.circuit.value}
    for ax in STACKED_AXES:
        out[ax.name] = ax.value_of(lc)
    out["v_threshold"] = resolve_v_threshold(lc, v_threshold_default)
    out["n_sub"] = n_sub
    return out


def outer_cells(grid, default_n_sub: int) -> tuple[tuple[float, int], ...]:
    """The outer (shape-changing) python loop: T_INTG × n_sub cells."""
    n_subs = tuple(getattr(grid, "n_sub", ()) or (default_n_sub,))
    return tuple((t, ns) for t in grid.t_intg_grid_ms for ns in n_subs)


def active_axes(grid) -> list[str]:
    """Names of the registry axes this grid sweeps (non-empty value tuple),
    for the artifact's grid metadata."""
    return [a.name for a in AXES if tuple(getattr(grid, a.name, ()) or ())]


def grid_axis_values(grid) -> dict[str, list]:
    """Axis → value-list mapping for the v3 artifact's grid block."""
    return {a.name: list(getattr(grid, a.name, ()) or []) for a in AXES}


def check_values(name: str, values: Sequence[Any]) -> tuple:
    """Validate CLI-provided axis values (registry-level sanity only)."""
    ax = axis(name)
    vals = tuple(values)
    if ax.name == "n_sub":
        vals = tuple(int(v) for v in vals)
        if any(v < 1 for v in vals):
            raise ValueError("n_sub values must be >= 1")
    elif any(float(v) < 0 for v in vals):
        raise ValueError(f"{ax.name} values must be >= 0")
    return vals
