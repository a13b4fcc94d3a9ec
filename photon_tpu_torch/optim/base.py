"""Solver contracts: configuration, result, convergence reasons,
tolerance semantics, and the host reads the solvers pay.

The port of ``photon_tpu/optim/base.py`` (reference: photon-lib
optimization/Optimizer.scala:36-190, OptimizerState.scala,
OptimizationStatesTracker.scala:31).

The JAX solvers are one on-device ``lax.while_loop`` each. Here a solver
is a Python loop over tensors on the card: each convergence test and each
line-search decision reads a few scalars to the host. Every such read
goes through :func:`fetch`, which copies them in one transfer and counts
one host sync; ``SolverResult.host_syncs`` reports a solve's count.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class ConvergenceReason(enum.IntEnum):
    """Reference: Optimizer.getConvergenceReason (Optimizer.scala:135-149);
    the same codes as the JAX package."""

    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    OBJECTIVE_NOT_IMPROVING = 4
    DUALITY_GAP_CONVERGED = 5


class FailureMode(enum.IntEnum):
    """A typed failure found inside a solve: a non-finite loss, gradient
    or step rejects the step and ends the solve at the last finite
    iterate."""

    NONE = 0
    NON_FINITE_LOSS = 1
    NON_FINITE_GRADIENT = 2
    NON_FINITE_STEP = 3


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Reference: OptimizerConfig.scala:28 + per-solver defaults
    (LBFGS.scala:152-157)."""

    max_iterations: int = 100
    tolerance: float = 1e-7
    num_corrections: int = 10
    linesearch_max_iterations: int = 25
    lower_bounds: Optional[Tensor] = None
    upper_bounds: Optional[Tensor] = None
    # per-iteration (loss, ||g||, step) ring size; 0 disables tracking
    track_states: int = 0


class SolverResult(NamedTuple):
    """Final state, mirroring OptimizerState + convergence bookkeeping.
    Counts and codes are host ints; ``host_syncs`` is this port's own
    field: the device-to-host reads the solve paid."""

    coef: Tensor
    value: Tensor
    gradient: Tensor
    iterations: int
    reason: int                # ConvergenceReason
    num_fun_evals: int         # objective evaluations
    loss_history: Optional[Tensor] = None
    gnorm_history: Optional[Tensor] = None
    step_history: Optional[Tensor] = None
    failure: int = FailureMode.NONE
    host_syncs: int = 0


class Tolerances(NamedTuple):
    """Absolute tolerances set from the initial state
    (reference: Optimizer.setAbsTolerances)."""

    value_tol: np.floating
    gradient_tol: np.floating


#: host syncs (one transfer of scalars each) in this process
host_syncs = 0


def fetch(*scalars: Tensor, dtype=np.float64) -> List[np.floating]:
    """The values of 0-d tensors on the host, in ONE device-to-host copy
    (one counted sync). Returned as numpy scalars of ``dtype`` — the
    solve's own precision, so host arithmetic rounds as the JAX carry's
    does. Booleans come back as 0.0 / 1.0."""
    global host_syncs
    host_syncs += 1
    packed = torch.stack([s.reshape(()).to(torch.float64) for s in scalars])
    return [dtype(v) for v in packed.cpu().numpy()]


def np_dtype(t: Tensor):
    return {torch.float32: np.float32, torch.float64: np.float64,
            torch.float16: np.float16}[t.dtype]


def absolute_tolerances(f0, gnorm0, rel_tol: float, dtype) -> Tolerances:
    tiny = np.finfo(dtype).tiny
    rel = dtype(rel_tol)
    return Tolerances(value_tol=rel * max(abs(f0), tiny),
                      gradient_tol=rel * max(gnorm0, tiny))


def convergence_reason(it: int, f_prev, f, gnorm, tols: Tolerances,
                       max_iterations: int,
                       improved: Optional[bool] = None) -> int:
    """Priority-ordered decision, the reference's order MaxIterations ->
    FunctionValuesConverged -> GradientConverged (Optimizer.scala:135-149).
    ``improved`` False (a rejected step, f == f_prev) gates the
    function-values test off, as in the JAX package."""
    f_conv = bool(abs(f_prev - f) <= tols.value_tol)
    if improved is not None:
        f_conv = f_conv and improved
    if it >= max_iterations:
        return ConvergenceReason.MAX_ITERATIONS
    if f_conv:
        return ConvergenceReason.FUNCTION_VALUES_CONVERGED
    if gnorm <= tols.gradient_tol:
        return ConvergenceReason.GRADIENT_CONVERGED
    return ConvergenceReason.NOT_CONVERGED


def nonfinite_code(f, g_finite: bool) -> int:
    """FailureMode from a host loss value and a gradient-finite flag."""
    if not np.isfinite(f):
        return FailureMode.NON_FINITE_LOSS
    return FailureMode.NONE if g_finite else FailureMode.NON_FINITE_GRADIENT


class StateTracking:
    """Ring buffer of the last ``size`` iterations' (loss, ||g||, step),
    kept on the host from values the solver has already read."""

    def __init__(self, size: int):
        self.loss = [float("nan")] * size
        self.gnorm = [float("nan")] * size
        self.step = [float("nan")] * size

    @staticmethod
    def init(size: int) -> Optional["StateTracking"]:
        return StateTracking(size) if size > 0 else None

    def record(self, it: int, f, gnorm, step=None) -> None:
        slot = it % len(self.loss)
        self.loss[slot] = float(f)
        self.gnorm[slot] = float(gnorm)
        self.step[slot] = float("nan") if step is None else float(step)

    def tensors(self, dtype: torch.dtype, device) -> Tuple[Tensor, ...]:
        t = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return t(self.loss), t(self.gnorm), t(self.step)


ValueAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]


def finish(x: Tensor, f: Tensor, g: Tensor, it: int, reason: int,
           n_evals: int, failure: int, trk: Optional[StateTracking],
           syncs_at_start: int) -> SolverResult:
    hist = (None, None, None) if trk is None \
        else trk.tensors(x.dtype, x.device)
    return SolverResult(
        coef=x, value=f, gradient=g, iterations=it, reason=int(reason),
        num_fun_evals=n_evals, loss_history=hist[0], gnorm_history=hist[1],
        step_history=hist[2], failure=int(failure),
        host_syncs=host_syncs - syncs_at_start)
