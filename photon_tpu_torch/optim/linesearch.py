"""Strong-Wolfe line search as a Python state machine.

The port of ``photon_tpu/optim/linesearch.py::wolfe_linesearch``
(bracket + zoom, Nocedal & Wright alg. 3.5/3.6, quadratic interpolation
with bisection safeguards, and the Hager-Zhang approximate-Wolfe window
near the optimum). The JAX version is one ``lax.while_loop``; here each
trial evaluates the objective on the card and reads ``(f(a), phi'(a))``
to the host in one sync, and the stage logic runs on host scalars in the
solve's own precision. The stages, constants, acceptance rules and
evaluation counts are the JAX version's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photon_tpu_torch.optim.base import ValueAndGrad, fetch, np_dtype

Tensor = torch.Tensor

_BRACKET, _ZOOM, _DONE = 0, 1, 2


class LineSearchResult(NamedTuple):
    """Accepted point. ``f <= f0`` whenever ``step > 0``: the flatness
    window affects classification only (see the JAX version)."""

    step: np.floating   # accepted step length
    f: Tensor           # objective at the accepted point (0-d)
    g: Tensor           # gradient at the accepted point
    f_host: np.floating  # the same value, already on the host
    num_evals: int
    success: bool


def _zoom_candidate(a_lo, f_lo, d_lo, a_hi, f_hi):
    """Quadratic interpolation with a bisection safeguard."""
    h = a_hi - a_lo
    denom = 2.0 * (f_hi - f_lo - d_lo * h)
    a_q = a_lo - d_lo * h * h / denom
    mid = a_lo + 0.5 * h
    lo, hi = min(a_lo, a_hi), max(a_lo, a_hi)
    pad = 0.1 * (hi - lo)
    bad = (not np.isfinite(a_q)) or a_q <= lo + pad or a_q >= hi - pad
    return mid if bad else a_q


def wolfe_linesearch(fg: ValueAndGrad, x: Tensor, direction: Tensor,
                     f0, g0: Tensor, d0, f0_t: Tensor, *,
                     initial_step=1.0, c1: float = 1e-4, c2: float = 0.9,
                     max_evals: int = 25,
                     max_step: float = 1e10) -> LineSearchResult:
    """A step along ``direction`` meeting the strong Wolfe conditions.

    ``f0`` and ``d0 = g0 . direction`` are host scalars of the solve's
    precision (the caller has read them already); ``f0_t`` / ``g0`` are
    the same point's value and gradient on the card. Falls back to the
    best strict-decrease point seen (``success=False``) when no Wolfe
    point turns up within ``max_evals``."""
    dt = np_dtype(x)
    f0, d0 = dt(f0), dt(d0)
    c1, c2 = dt(c1), dt(c2)
    slack = dt(8.0) * np.finfo(dt).eps * abs(f0)
    zero = dt(0.0)
    # (a, f, phi'(a), g, f on the card) of the zoom bracket's ends and of
    # the previous trial; the hi end never needs its gradient
    lo = (zero, f0, d0, g0, f0_t)
    hi = (zero, f0, d0)
    prev = lo
    best = (zero, f0, g0, f0_t)
    success = False
    stage = _BRACKET
    i = 0
    a_next = dt(initial_step)
    with np.errstate(all="ignore"):
        while stage != _DONE:
            a = a_next
            f_t, g_a = fg(x + float(a) * direction)
            f_a, d_a = fetch(f_t, torch.dot(g_a, direction), dtype=dt)
            i += 1
            trial = (a, f_a, d_a, g_a, f_t)
            finite = bool(np.isfinite(f_a))

            # best strict-decrease tracker (the failure fallback);
            # non-finite trials never win
            if f_a < best[1] and finite:
                best = (a, f_a, g_a, f_t)

            # a non-finite trial is an Armijo failure: the bracket shrinks
            # back toward the finite region
            armijo_fail = bool(f_a > f0 + c1 * a * d0) or not finite
            wolfe_ok = bool(abs(d_a) <= -c2 * d0)
            approx_conv = (bool(f_a <= f0 + slack) and bool(d_a >= c2 * d0)
                           and bool(d_a <= (2.0 * c1 - 1.0) * d0) and finite)
            approx_take = approx_conv and bool(f_a <= f0)
            approx_stop = approx_conv and not approx_take

            in_bracket = stage == _BRACKET
            br_to_zoom1 = armijo_fail or (i > 1 and bool(f_a >= prev[1]))
            br_accept = (not br_to_zoom1) and wolfe_ok
            br_to_zoom2 = ((not br_to_zoom1) and (not wolfe_ok)
                           and bool(d_a >= 0))
            br_grow = not (br_to_zoom1 or br_accept or br_to_zoom2)

            zm_shrink_hi = armijo_fail or bool(f_a >= lo[1])
            zm_accept = (not zm_shrink_hi) and wolfe_ok
            zm_flip = ((not zm_shrink_hi) and (not wolfe_ok)
                       and bool(d_a * (hi[0] - lo[0]) >= 0))

            accept = (br_accept if in_bracket else zm_accept) or approx_take

            if in_bracket:
                lo, hi = ((prev, trial[:3]) if br_to_zoom1
                          else (trial, prev[:3]))
            elif zm_shrink_hi:
                hi = trial[:3]
            else:
                lo, hi = trial, (lo[:3] if zm_flip else hi)

            entering_zoom = in_bracket and (br_to_zoom1 or br_to_zoom2)
            interval = abs(hi[0] - lo[0])
            interval_dead = (entering_zoom or not in_bracket) and bool(
                interval <= dt(1e-10) * max(abs(hi[0]), dt(1.0)))
            # accept lo when the zoom interval collapses
            collapse_accept = interval_dead and not accept

            if accept or collapse_accept or approx_stop or i >= max_evals:
                stage = _DONE
            elif in_bracket and br_grow:
                stage = _BRACKET
            else:
                stage = _ZOOM

            if in_bracket and br_grow:
                a_next = min(dt(2.0) * a, dt(max_step))
            else:
                a_next = _zoom_candidate(lo[0], lo[1], lo[2], hi[0], hi[1])

            if accept:
                best = (a, f_a, g_a, f_t)
            elif collapse_accept:
                best = (lo[0], lo[1], lo[3], lo[4])
            success = success or accept or approx_stop
            prev = trial

    a_best, f_best, g_best, ft_best = best
    return LineSearchResult(step=a_best, f=ft_best, g=g_best, f_host=f_best,
                            num_evals=i, success=success)

