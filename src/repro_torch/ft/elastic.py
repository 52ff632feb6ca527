"""Elastic re-mesh planning (the port's ``repro.ft.elastic``, pure Python,
the reference's logic unchanged): given the surviving chip count, pick the next
(data, model) mesh the job restarts onto.

Invariants the planner maintains:

* the **model axis is preserved** when possible — TP degree is baked into
  the padded physical shapes (heads/vocab padded to tp_multiple), so keeping
  it avoids re-padding and keeps checkpoints bit-identical; the data axis
  absorbs capacity loss (DP is the elastic dimension, as in production
  systems);
* the global batch must stay divisible by the new data-parallel degree —
  the planner reports the largest feasible data axis and, if the batch does
  not divide, the per-step accumulation factor that restores the global
  batch exactly;
* failures that break the model axis (survivors < tp) degrade the model
  axis to the largest power-of-two divisor of the survivor count that still
  divides the padded head count.

Checkpoints are mesh-shape-agnostic (checkpoint/store.py), so executing the
plan is: drain → checkpoint → restart with ``ElasticPlan.mesh_shape`` →
restore, the step built with ``grad_accum=ElasticPlan.grad_accum``
(``train/steps.build_train_step`` on the new mesh). The planner is pure and
unit-testable.

As in the reference, where the batch does not divide the new data axis
``grad_accum`` is ``ceil(global_batch / data)``, which need not divide the
batch; ``build_train_step`` then raises ``ValueError`` (the reference's step
asserts).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, int]          # (data, model)
    grad_accum: int                      # microbatch factor to keep global batch
    dropped_chips: int
    note: str

    @property
    def chips(self) -> int:
        return self.mesh_shape[0] * self.mesh_shape[1]


def _largest_pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while p * 2 <= cap and n % (p * 2) == 0:
        p *= 2
    return p


def plan_remesh(surviving_chips: int, *, tp: int, global_batch: int,
                prev_data_axis: int | None = None) -> ElasticPlan:
    """Plan the next mesh after failures leave ``surviving_chips`` healthy."""
    if surviving_chips < 1:
        raise ValueError("no surviving chips")
    if surviving_chips >= tp and surviving_chips % tp == 0:
        model = tp
        note = "model axis preserved"
    elif surviving_chips >= tp:
        # keep tp, round the data axis down to the largest full multiple
        model = tp
        note = "model axis preserved; idle remainder chips"
    else:
        model = _largest_pow2_divisor(tp, surviving_chips)
        note = f"model axis degraded {tp}->{model} (survivors < tp)"
    data = max(surviving_chips // model, 1)
    used = data * model

    # restore the exact global batch: accumulate if it no longer divides
    if global_batch % data == 0:
        accum = 1
    else:
        # per-device microbatch of 1 with accumulation over the remainder
        accum = -(-global_batch // data)  # ceil
        note += f"; grad-accum x{accum} restores global batch {global_batch}"
    return ElasticPlan(mesh_shape=(data, model), grad_accum=accum,
                       dropped_chips=surviving_chips - used, note=note)
