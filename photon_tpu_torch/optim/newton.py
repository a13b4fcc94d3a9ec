"""Damped Newton (IRLS) with an explicit Hessian and a Cholesky solve.

The port of ``photon_tpu/optim/newton.py::minimize``. For a
twice-differentiable GLM loss each outer iteration solves

    H(x) s = -g(x);   x <- x + t s      (t from Armijo backtracking)

with H the explicit [d, d] Hessian (one curvature-weighted Gram,
``ops/features.weighted_gram``) factored by ``torch.linalg``. The JAX
package does that algebra outside Pallas too; the only kernel on this
path is the value+gradient evaluation.

Safeguards, as in the JAX version: a Cholesky that fails (non-PD
curvature) or an ascent step falls back to steepest descent for that
iteration; Armijo backtracking from t=1 with a machine-epsilon slack
rejects divergent steps; a finite value with a non-finite gradient ends
the solve with a typed failure.

Host syncs per iteration: one for the direction's slope, one per
backtracking evaluation (value, ||g||, gradient finite).
"""

from __future__ import annotations

import numpy as np
import torch

from photon_tpu_torch.optim import base
from photon_tpu_torch.optim.base import (
    ConvergenceReason,
    FailureMode,
    SolverConfig,
    SolverResult,
    StateTracking,
    absolute_tolerances,
    convergence_reason,
    fetch,
    nonfinite_code,
    np_dtype,
)

Tensor = torch.Tensor

_ARMIJO_C1 = 1e-4


def minimize(value_and_grad, hess_matrix, x0: Tensor,
             config: SolverConfig = SolverConfig(max_iterations=25,
                                                 tolerance=1e-7)
             ) -> SolverResult:
    """``value_and_grad(x) -> (f, g)``; ``hess_matrix(x) -> [d, d]``, the
    full regularized Hessian at x. Both are re-evaluated every outer
    iteration."""
    syncs0 = base.host_syncs
    dt = np_dtype(x0)
    x = x0
    f_t, g = value_and_grad(x)
    f, gnorm, g_fin = fetch(f_t, torch.linalg.vector_norm(g),
                            torch.isfinite(g).all(), dtype=dt)
    tols = absolute_tolerances(f, gnorm, config.tolerance, dt)
    # sentinel f_prev far from f0: the first check can only fire on the
    # gradient (a stationary start) or max_iterations == 0
    f_far = f + dt(2.0) * tols.value_tol + dt(1.0)
    reason = convergence_reason(0, f_far, f, gnorm, tols,
                                config.max_iterations)
    failure = nonfinite_code(f, bool(g_fin))
    it = 0
    n_evals = 1
    trk = StateTracking.init(config.track_states)
    c1 = dt(_ARMIJO_C1)

    with np.errstate(all="ignore"):
        while (reason == ConvergenceReason.NOT_CONVERGED
               and failure == FailureMode.NONE):
            h = hess_matrix(x)
            chol, info = torch.linalg.cholesky_ex(h)
            step = -torch.cholesky_solve(g[:, None], chol)[:, 0]
            # descent safeguard: a failed factorization, a non-finite or
            # an ascent step gives way to steepest descent
            newton_ok = ((info == 0) & torch.isfinite(step).all()
                         & (torch.dot(g, step) < 0.0))
            direction = torch.where(newton_ok, step, -g)
            (gdot,) = fetch(torch.dot(g, direction), dtype=dt)

            # Armijo backtracking from t = 1, with the machine-epsilon
            # slack of the JAX version (classification only, see below)
            slack = dt(4.0) * np.finfo(dt).eps * abs(f)
            t = dt(1.0)
            accepted = False
            k = 0
            while not accepted and k < config.linesearch_max_iterations:
                ft_new, g_new = value_and_grad(x + float(t) * direction)
                f_new, gnorm_new, g_fin = fetch(
                    ft_new, torch.linalg.vector_norm(g_new),
                    torch.isfinite(g_new).all(), dtype=dt)
                k += 1
                accepted = bool(np.isfinite(f_new)) and bool(
                    f_new <= f + c1 * t * gdot + slack)
                if not accepted:
                    t = dt(0.5) * t

            # a step the slack admits with f_new > f keeps `accepted` (the
            # solve is converged to the dtype's resolution) but never moves
            # the iterate uphill; a non-finite gradient is never admitted
            g_finite = bool(g_fin)
            take = accepted and bool(f_new <= f) and g_finite
            failure = (FailureMode.NON_FINITE_GRADIENT
                       if accepted and not g_finite else FailureMode.NONE)
            f_prev = f
            if take:
                x = x + float(t) * direction
                f, f_t, g, gnorm = f_new, ft_new, g_new, gnorm_new
            it += 1
            reason = convergence_reason(it, f_prev, f, gnorm, tols,
                                        config.max_iterations,
                                        improved=accepted)
            # an exhausted line search: no further progress is possible
            if reason == ConvergenceReason.NOT_CONVERGED and not accepted:
                reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
            if failure != FailureMode.NONE:
                reason = ConvergenceReason.OBJECTIVE_NOT_IMPROVING
            if trk is not None:
                trk.record(it - 1, f, gnorm)
            n_evals += k

    return base.finish(x, f_t, g, it, reason, n_evals, failure, trk, syncs0)
