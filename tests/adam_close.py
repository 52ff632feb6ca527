"""One train run's params and AdamW moments held to another's, step by
step (not collected: no ``test_`` prefix; imports no JAX, so the card
tests and chip_smoke.py's [lm train parity] use it too).

AdamW moves an element by lr g / (sqrt(v) + eps) (bias-corrected). Where
sqrt(v) is nonzero and below 10 eps (a clipped gradient near 1e-8, whose
roundoff in either run is a large share of it), two runs' roundoff in g
becomes a visible part of an lr-sized step, and the element keeps that
offset from then on. With ``exempt``, a param off the tolerance passes
only at such an element (the wanted run's state says which, at this step
or an earlier one), within the steps' reach, 2 lr a step taken, and such
passes are under 1e-3 of a leaf; and at every step where an element is
so marked, the clipped gradient each run took there (read back from its
first moment) is held per element to the gradient tolerance, so the
exemption covers AdamW's amplification and not the gradient. Without
``exempt`` every element is held to the tolerance."""
from __future__ import annotations

import numpy as np

RTOL, ATOL = 2e-4, 2e-5         # the reference's grad-accumulation test
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6   # the float32 gradient parity tests'
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # adamw's defaults in both
MAX_SHARE = 1e-3                # of a leaf's elements exempted


def state_gaps(got: dict, want: dict, t: int, lr: float, carry: dict,
               exempt: bool = False, rtol: float = RTOL, atol: float = ATOL
               ) -> tuple[float, list, list]:
    """``got`` and ``want`` map paths ("params/...", "opt/mu/...",
    "opt/nu/...") to float32 arrays after step ``t`` (1-based), and are
    given every step from the first; ``carry`` (empty before step 1)
    keeps the marked elements and both runs' first moments from step to
    step. Returns (worst, exempted, faults): the largest |got - want| /
    (atol + rtol |want|) over the elements held to it; each exempted
    element this step as a dict (its path, index, both runs' sqrt(v),
    param and clipped gradient); what broke the rule (empty if nothing
    did)."""
    worst, exempted, faults = 0.0, [], []
    for path, a in got.items():
        w = want[path]
        if np.shape(a) != np.shape(w):
            faults.append(f"{path}: shape {np.shape(a)} against "
                          f"{np.shape(w)}")
            continue
        r = np.abs(a - w) / (atol + rtol * np.abs(w))
        leaf = path.removeprefix("params/")
        if exempt and leaf != path:
            v = [np.sqrt(s["opt/nu/" + leaf] / (1 - ADAM_B2 ** t))
                 for s in (got, want)]
            now = (v[1] > 0) & (v[1] < 10 * ADAM_EPS)
            marked = carry[path] = carry.get(path, False) | now
            mu = [np.asarray(s["opt/mu/" + leaf], np.float64)
                  for s in (got, want)]
            prev = carry.get("mu/" + leaf, (0.0, 0.0))
            carry["mu/" + leaf] = mu
            g = [(m - ADAM_B1 * p) / (1 - ADAM_B1) for m, p in zip(mu, prev)]
            bad = now & (np.abs(g[0] - g[1])
                         > GRAD_ATOL + GRAD_RTOL * np.abs(g[1]))
            if bad.any():
                faults.append(f"{path} step {t}: the clipped gradient at "
                              f"{int(bad.sum())} ill-conditioned elements "
                              f"off rtol {GRAD_RTOL} / atol {GRAD_ATOL}")
            off = marked & (r > 1)
            gap = np.abs(a - w)[off].max(initial=0)
            if off.mean() >= MAX_SHARE or gap > 2 * lr * t:
                faults.append(f"{path} step {t}: {int(off.sum())} "
                              f"ill-conditioned elements off the limit, "
                              f"at most {gap:.3g} apart (2 lr a step is "
                              f"{2 * lr * t:.3g})")
            for i in (tuple(map(int, j)) for j in np.argwhere(off)):
                exempted.append(dict(
                    path=path, index=i, step=t,
                    sqrt_v=(float(v[0][i]), float(v[1][i])),
                    param=(float(a[i]), float(w[i])),
                    grad=(float(g[0][i]), float(g[1][i]))))
            r = r[~off]
        top = float(r.max(initial=0))
        worst = max(worst, top)
        if not top <= 1:            # NaN included
            faults.append(f"{path} step {t}: {int((r > 1).sum())} elements "
                          f"off rtol {rtol} / atol {atol}, at most {top:.3g} "
                          f"of the limit")
    return worst, exempted, faults


def close_state(got: dict, want: dict, t: int, lr: float, carry: dict,
                exempt: bool = False) -> list:
    """``state_gaps``, asserted to have no fault; returns the exempted
    elements."""
    _, exempted, faults = state_gaps(got, want, t, lr, carry, exempt)
    assert not faults, faults
    return exempted
