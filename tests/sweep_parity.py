"""Holding two runs of the co-design sweep's training against each other
(the card against the CPU, the port against the reference), and the
elements that may differ by Adam steps rather than by roundoff.

Adam's step lr·m̂/(√v̂ + eps) divides a gradient by its own size, so an
element whose gradient is as small as the roundoff of its computation
steps by up to lr with a sign that roundoff picks: two sound runs may
differ there by up to 2·lr a step. Such elements are of two kinds:

- elements whose exact gradient is 0 under train-mode BatchNorm (BN
  subtracts the batch mean and divides by the batch spread of every
  conv's output channel): every conv bias; the centre tap of a 3×3 SAME
  conv (the one tap that never reads the padding) on an input channel
  that holds one non-zero value over the batch, the time steps and the
  map; the BN scale of a channel whose pre-BN values are one value
  there. In exact arithmetic they do not change the forward (BN removes
  them);
- elements whose gradient is a small difference of large sums, such as
  the taps of a backbone whose layer 1 is silent (every site of a
  channel the same, so a tap's sum cancels but for the border).

Both are measured on the run the other is held against, not listed:
:func:`record_constant_channels` logs the constant channels of every
train-mode backbone forward, and :func:`roundoff_masks` maps the log onto
each cell's stacked params in the sweep's order of work (the shared
pretrain, then per protocol, cell and step one forward per variant);
:func:`cpu_reference` adds the elements that two more sound CPU runs,
which change only the roundoff (the batch's order reversed, which the
step's sums do not depend on; one thread), move by more than a tenth of
the tight limit. :class:`ParamParity` holds the masked elements to 2·lr
a step and every other one to ``rtol`` of its leaf's largest magnitude
(BN running means, which absorb the bias steps, to ``MEAN_RTOL``), and
fails when the masked share of all elements passes
``MAX_MASKED_SHARE``.

:func:`skip_updates` plants the faults the check must catch: a run on
which some or all of the sweep's finetune updates are dropped while the
same batches are drawn.
"""
from __future__ import annotations

import contextlib
from typing import Iterable

import torch

from repro_torch.core import snn, sweep
from repro_torch.data import sources
from repro_torch.utils import tree_paths

MEAN_RTOL = 1e-2
MAX_MASKED_SHARE = 0.03
# two sound runs' records: their backend energies read the backbone's
# spike counts, which the roundoff-trained weights move a little; the
# limit lies between the sound runs' readings and those of runs that drop
# one update (chip_smoke.py's [sweep parity] prints both)
COUNTER_RTOL = 5e-3


@contextlib.contextmanager
def record_constant_channels():
    """Patch the port's ``snn.conv_apply`` and ``snn.bn_apply`` to log, for
    each train-mode BN call, ``(const_in, const_pre)``: the conv's input
    channels that hold one non-zero value over every other axis, and the
    BN input channels that hold one value. Yields the log (a list, one
    entry per conv layer of every train-mode forward, in call order)."""
    log: list[tuple[torch.Tensor, torch.Tensor]] = []
    conv, bn = snn.conv_apply, snn.bn_apply
    stash: list[torch.Tensor | None] = [None]

    def constant(x: torch.Tensor, nonzero: bool) -> torch.Tensor:
        with torch.no_grad():
            flat = x.detach().reshape(-1, x.shape[-1])
            hi, lo = flat.amax(dim=0), flat.amin(dim=0)
            same = hi == lo
            return (same & (hi != 0) if nonzero else same).cpu()

    def conv_apply(p, x, stride=1):
        stash[0] = constant(x, nonzero=True)
        return conv(p, x, stride)

    def bn_apply(p, s, x, *, train, **kw):
        if train:
            log.append((stash[0], constant(x, nonzero=False)))
            stash[0] = None
        return bn(p, s, x, train=train, **kw)

    snn.conv_apply, snn.bn_apply = conv_apply, bn_apply
    try:
        yield log
    finally:
        snn.conv_apply, snn.bn_apply = conv, bn


def roundoff_masks(log: list, final_params: dict[str, dict], *, n_pre: int,
                   steps: int) -> dict[str, dict]:
    """``{protocol: {cell: {path: bool mask}}}`` over the stacked trained
    params of ``final_params`` (``{protocol: GridResult.final_params}``,
    in run order) from a :func:`record_constant_channels` log of the same
    run: ``n_pre`` pretrain forwards shared by every cell, then per
    protocol and cell ``steps`` (warm-up + finetune) steps of one forward
    per variant. Raises if the log does not have that many forwards."""
    first = next(iter(next(iter(final_params.values())).values()))
    convs = sorted(k for k in first["backbone"] if k.startswith("conv"))
    G = first["backbone"][convs[0]]["w"].shape[0]
    L = len(convs)
    n_cells = sum(len(fp) for fp in final_params.values())
    want = L * (n_pre + n_cells * steps * G)
    if len(log) != want:
        raise AssertionError(f"{len(log)} logged BN calls, expected {want}: "
                             f"the sweep's order of work has changed")
    fwd = [log[i * L:(i + 1) * L] for i in range(len(log) // L)]
    out: dict[str, dict] = {}
    base = n_pre
    for proto, cells in final_params.items():
        out[proto] = {}
        for cell, fp in cells.items():
            masks = {path: torch.zeros(t.shape, dtype=torch.bool)
                     for path, t in tree_paths(fp)}
            for g in range(G):
                mine = list(range(n_pre)) + [base + s * G + g
                                             for s in range(steps)]
                for f in mine:
                    for name, (c_in, c_pre) in zip(convs, fwd[f]):
                        i = name[len("conv"):]
                        masks[f"backbone/{name}/b"][g] = True
                        w = masks[f"backbone/{name}/w"][g]
                        k = w.shape[0] // 2
                        w[k, k, c_in, :] = True
                        masks[f"backbone/bn{i}/scale"][g] |= c_pre
            out[proto][cell] = masks
            base += steps * G
    return out


class ReversedBatches(sources.SyntheticSource):
    """The synthetic source with each batch in reverse order along the
    batch axis: a sweep step's sums over the batch (BN statistics, the
    mean loss, weight gradients, counts) take the same exact values in
    another order."""

    def sample_batch(self, gen, batch_size, t_intg_ms, n_sub=1):
        ev, lab = super().sample_batch(gen, batch_size, t_intg_ms, n_sub)
        return ev.flip(0), lab.flip(0)


def cpu_reference(run, data_cfg, *, n_pre: int, steps: int, rtol: float
                  ) -> tuple[dict, dict]:
    """``run(source) → {protocol: GridResult}`` (a sweep on the CPU with
    ``keep_params=True``) on ``data_cfg``, and the masks of its
    roundoff-trained elements: the constant-channel classes, plus every
    element that the batch-reversed run or a one-thread run moves by more
    than ``rtol / 10`` of its leaf's largest magnitude."""
    with record_constant_channels() as log:
        res = run(data_cfg)
    masks = roundoff_masks(log, {p: r.final_params for p, r in res.items()},
                           n_pre=n_pre, steps=steps)
    twins = [run(ReversedBatches(data_cfg))]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        twins.append(run(data_cfg))
    finally:
        torch.set_num_threads(threads)
    for twin in twins:
        for proto, r in res.items():
            for cell, fp in r.final_params.items():
                got = dict(tree_paths(twin[proto].final_params[cell]))
                for path, w in tree_paths(fp):
                    lim = rtol / 10 * float(w.abs().max())
                    masks[proto][cell][path] |= (got[path] - w).abs() > lim
    return res, masks


class ParamParity:
    """Accumulates the comparison of trained param trees; ``failures``
    lists what broke the limits (module docstring)."""

    def __init__(self, *, lr: float, steps: int, rtol: float):
        self.loose_lim = 2 * lr * steps
        self.rtol = rtol
        self.failures: list[str] = []
        self.n_masked = self.n_all = 0
        self.worst_tight = 0.0          # of a leaf's largest magnitude
        self.worst_masked = 0.0         # absolute

    def compare(self, where: str, got: dict, want: dict,
                masks: dict[str, torch.Tensor]) -> None:
        got = dict(tree_paths(got))
        for path, w in tree_paths(want):
            w = w.detach().cpu()
            err = (got[path].detach().cpu() - w).abs()
            top = max(float(w.abs().max()), 1e-30)
            if path.startswith("state/") and path.endswith("/mean"):
                if float(err.max()) > MEAN_RTOL * top:
                    self.failures.append(f"{where} {path}: running mean "
                                         f"differs by {float(err.max()):.3g}")
                continue
            m = masks[path]
            self.n_masked += int(m.sum())
            self.n_all += err.numel()
            if (~m).any():
                tight = float(err[~m].max())
                self.worst_tight = max(self.worst_tight, tight / top)
                if tight > self.rtol * top:
                    self.failures.append(
                        f"{where} {path}: differs by {tight:.3g} > "
                        f"{self.rtol:g} of its largest {top:.3g}")
            if m.any():
                loose = float(err[m].max())
                self.worst_masked = max(self.worst_masked, loose)
                if loose > self.loose_lim:
                    self.failures.append(
                        f"{where} {path}: a roundoff-trained element "
                        f"differs by {loose:.3g} > {self.loose_lim:g}")

    def share(self) -> float:
        return self.n_masked / max(self.n_all, 1)

    def finish(self) -> list[str]:
        if self.share() > MAX_MASKED_SHARE:
            self.failures.append(
                f"{self.n_masked} of {self.n_all} elements masked as "
                f"roundoff-trained ({self.share():.3g} > "
                f"{MAX_MASKED_SHARE:g})")
        return self.failures

    def summary(self) -> str:
        return (f"params within {self.worst_tight:.3g} of a leaf's largest "
                f"magnitude (limit {self.rtol:g}) but for {self.n_masked} "
                f"of {self.n_all} roundoff-trained elements "
                f"({self.share():.3g}, limit {MAX_MASKED_SHARE:g}), "
                f"within {self.worst_masked:.3g} (limit {self.loose_lim:g})")


def compare_runs(got: dict, want: dict, masks: dict, *, lr: float,
                 steps: int, rtol: float) -> ParamParity:
    """Every cell's trained params of two ``{protocol: GridResult}`` runs
    (``keep_params=True``), ``want``'s masks from :func:`roundoff_masks`."""
    par = ParamParity(lr=lr, steps=steps, rtol=rtol)
    for proto, res in want.items():
        for cell, fp in res.final_params.items():
            par.compare(f"{proto} {cell}", got[proto].final_params[cell], fp,
                        masks[proto][cell])
    par.finish()
    return par


def energy_reading(got: dict, want: dict) -> dict[str, float]:
    """Per protocol, the largest relative difference of the records'
    backend energies between two ``run_protocols`` results (held to
    ``COUNTER_RTOL``)."""
    return {p: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for a, b in zip(got[p].records, want[p].records)
                   for k in ("backend_energy_conventional_j",
                             "backend_energy_p2m_j"))
            for p in want}


@contextlib.contextmanager
def skip_updates(calls: Iterable[int] | None = None):
    """Drop the updates of the sweep's finetune step on the given calls of
    each cell (0 the warm-up step, then the finetune steps; ``None``
    every call): the step runs and its batch is drawn, but the params,
    optimizer and BN state it returns are the ones it was given."""
    make = sweep.make_batched_finetune_step
    skip = None if calls is None else set(calls)

    def patched(*args, **kw):
        step = make(*args, **kw)
        n = [0]

        def run(p2m, bb, opt_state, state, events, labels):
            out = step(p2m, bb, opt_state, state, events, labels)
            i, n[0] = n[0], n[0] + 1
            if skip is None or i in skip:
                return (p2m, bb, opt_state, state) + tuple(out[4:])
            return out

        return run

    sweep.make_batched_finetune_step = patched
    try:
        yield
    finally:
        sweep.make_batched_finetune_step = make
