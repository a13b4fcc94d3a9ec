"""L-BFGS as a Python loop over tensors on the card.

The port of ``photon_tpu/optim/lbfgs.py::minimize`` and
``two_loop_direction`` (replacing breeze.optimize.LBFGS behind the
reference's LBFGS adapter, optimization/LBFGS.scala:39): a two-loop
recursion over a circular (S, Y) history, the strong-Wolfe line search
(``optim/linesearch.py``), and the JAX carry's rules — steepest descent
on a non-descent direction, a first step of ``min(1, 1/||g||)``,
non-decreasing steps rejected, curvature pairs stored only when
``s.y > 1e-10 * max(y.y, 1e-30)``, OBJECTIVE_NOT_IMPROVING after two
failed line searches in a row, a typed failure after two non-finite
evaluations in a row. Defaults mirror the reference: maxIter=100,
numCorrections=10, tol=1e-7 (LBFGS.scala:152-157).

Host syncs per iteration: one for the direction's slope and ||g||^2, one
per line-search evaluation, one for the accepted step's curvature and
||g||. History slot bookkeeping stays on the host, so the two-loop
recursion itself reads nothing back.

Box bounds (LBFGSB) are not ported yet: a config with bounds raises
``ValueError``. The margin-resident ``minimize_directional`` waits for
the model-sharded features it serves.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from photon_tpu_torch.optim import base
from photon_tpu_torch.optim.base import (
    ConvergenceReason,
    FailureMode,
    SolverConfig,
    SolverResult,
    StateTracking,
    ValueAndGrad,
    absolute_tolerances,
    convergence_reason,
    fetch,
    nonfinite_code,
    np_dtype,
)
from photon_tpu_torch.optim.linesearch import wolfe_linesearch

Tensor = torch.Tensor


def two_loop_direction(g: Tensor, s_hist: Tensor, y_hist: Tensor,
                       rho: List, gamma, n_pairs: int, head: int,
                       m: int) -> Tensor:
    """Standard two-loop recursion over the ``n_pairs`` valid slots of the
    circular buffer, newest first; ``rho`` and ``gamma`` (the initial
    Hessian scale s.y / y.y of the newest pair) are host scalars."""
    q = g
    alphas = [None] * m
    for j in range(n_pairs):
        idx = (head - 1 - j) % m
        a = float(rho[idx]) * torch.dot(s_hist[idx], q)
        q = q - a * y_hist[idx]
        alphas[idx] = a
    r = float(gamma) * q
    for j in range(n_pairs):
        idx = (head - n_pairs + j) % m
        beta = float(rho[idx]) * torch.dot(y_hist[idx], r)
        r = r + s_hist[idx] * (alphas[idx] - beta)
    return -r


def minimize(value_and_grad: ValueAndGrad, x0: Tensor, *,
             config: SolverConfig = SolverConfig()) -> SolverResult:
    """Minimize ``value_and_grad(x) -> (f, g)`` from ``x0``."""
    if config.lower_bounds is not None or config.upper_bounds is not None:
        raise ValueError("L-BFGS with box bounds is L-BFGS-B, which is not "
                         "yet ported to photon_tpu_torch")
    syncs0 = base.host_syncs
    m = config.num_corrections
    d = x0.shape[0]
    dt = np_dtype(x0)
    x = x0
    f_t, g = value_and_grad(x)
    f, gnorm, g_fin = fetch(f_t, torch.linalg.vector_norm(g),
                            torch.isfinite(g).all(), dtype=dt)
    tols = absolute_tolerances(f, gnorm, config.tolerance, dt)
    reason = (ConvergenceReason.GRADIENT_CONVERGED
              if gnorm <= tols.gradient_tol
              else ConvergenceReason.NOT_CONVERGED)
    # a non-finite start (poisoned data) exits before the first step
    failure = nonfinite_code(f, bool(g_fin))

    s_hist = torch.zeros((m, d), dtype=x0.dtype, device=x0.device)
    y_hist = torch.zeros_like(s_hist)
    rho = [dt(0.0)] * m
    gamma = dt(1.0)
    n_pairs = head = it = nf_count = 0
    n_evals = 1
    ls_failed = False
    trk = StateTracking.init(config.track_states)

    with np.errstate(all="ignore"):
        while (reason == ConvergenceReason.NOT_CONVERGED
               and failure == FailureMode.NONE):
            direction = two_loop_direction(g, s_hist, y_hist, rho, gamma,
                                           n_pairs, head, m)
            # safeguard: steepest descent on a non-descent direction
            d_dir, d_neg = fetch(torch.dot(direction, g),
                                 -torch.dot(g, g), dtype=dt)
            if d_dir < 0:
                d0 = d_dir
            else:
                direction, d0 = -g, d_neg
            init_step = (min(dt(1.0), dt(1.0) / max(gnorm, dt(1e-12)))
                         if n_pairs == 0 else dt(1.0))
            ls = wolfe_linesearch(value_and_grad, x, direction, f, g, d0,
                                  f_t, initial_step=init_step,
                                  max_evals=config.linesearch_max_iterations)
            x_new = x + float(ls.step) * direction
            s = x_new - x
            yv = ls.g - g
            sy, yy, gnorm_new, g_fin = fetch(
                torch.dot(s, yv), torch.dot(yv, yv),
                torch.linalg.vector_norm(ls.g), torch.isfinite(ls.g).all(),
                dtype=dt)
            g_finite = bool(g_fin)
            finite = bool(np.isfinite(ls.f_host)) and g_finite
            decreased = finite and bool(ls.f_host < f)

            f_prev = f
            if decreased:
                # curvature update from the accepted step
                if sy > dt(1e-10) * max(yy, dt(1e-30)):
                    write = head % m
                    s_hist[write] = s
                    y_hist[write] = yv
                    rho[write] = dt(1.0) / (sy if sy != 0 else dt(1.0))
                    gamma = sy / yy if yy > 0 else dt(1.0)
                    head = (head + 1) % m
                    n_pairs = min(n_pairs + 1, m)
                x, f, f_t, g, gnorm = x_new, ls.f_host, ls.f, ls.g, gnorm_new

            it += 1
            reason = convergence_reason(it, f_prev, f, gnorm, tols,
                                        config.max_iterations,
                                        improved=decreased)
            # two consecutive failed line searches -> not improving
            if (reason == ConvergenceReason.NOT_CONVERGED
                    and not decreased and ls_failed):
                reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
            # two consecutive non-finite evaluations: typed failure at the
            # last finite iterate
            nf_count = 0 if finite else nf_count + 1
            failure = (nonfinite_code(ls.f_host, g_finite) if nf_count >= 2
                       else FailureMode.NONE)
            if failure != FailureMode.NONE:
                reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
            n_evals += ls.num_evals
            ls_failed = not decreased
            if trk is not None:
                trk.record(it - 1, f, gnorm,
                           step=ls.step if decreased else 0.0)

    return base.finish(x, f_t, g, it, reason, n_evals, failure, trk, syncs0)
