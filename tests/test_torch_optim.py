"""L-BFGS, the strong-Wolfe line search and NEWTON: the port's Python-loop
solvers against the JAX package's on-device while-loops.

The problems are ``tests/test_optimizers.py``'s (Rosenbrock, an exact
quadratic, logistic and Poisson GLMs), in float64 on ``device="cpu"``.
Each pair of solves must give the same ``ConvergenceReason`` and failure
code, coefficients within rtol 1e-6 / atol 1e-8 (the same iteration in
the same precision; the sums differ only in order), and iteration and
``num_fun_evals`` counts within a slack of 2 (a last comparison against a
tolerance may land on the other side of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.data.dataset import DataBatch as JBatch
from photon_tpu.function.objective import GLMObjective as JObjective
from photon_tpu.function.objective import Hyper as JHyper
from photon_tpu.ops.losses import LogisticLoss as JLogistic
from photon_tpu.ops.losses import PoissonLoss as JPoisson
from photon_tpu.optim import SolverConfig as JSolverConfig
from photon_tpu.optim import lbfgs as jlbfgs
from photon_tpu.optim import newton as jnewton
from photon_tpu.optim.linesearch import wolfe_linesearch as j_wolfe
from photon_tpu_torch.data.dataset import DataBatch
from photon_tpu_torch.function.objective import GLMObjective, Hyper
from photon_tpu_torch.ops.losses import LogisticLoss, PoissonLoss
from photon_tpu_torch.optim import base, lbfgs, newton
from photon_tpu_torch.optim.base import (ConvergenceReason, FailureMode,
                                         SolverConfig)
from photon_tpu_torch.optim.linesearch import wolfe_linesearch

COEF_TOL = dict(rtol=1e-6, atol=1e-8)
SLACK = 2
D = 12


def _same(res, jres, tol=COEF_TOL):
    assert res.reason == int(jres.reason)
    assert res.failure == int(jres.failure)
    assert abs(res.iterations - int(jres.iterations)) <= SLACK
    assert abs(res.num_fun_evals - int(jres.num_fun_evals)) <= SLACK
    np.testing.assert_allclose(res.coef.numpy(), np.asarray(jres.coef), **tol)


def _rosen_np(z):
    return np.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2 + (1 - z[:-1]) ** 2)


def _rosen_torch(z):
    f = torch.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2 + (1 - z[:-1]) ** 2)
    g = torch.zeros_like(z)
    inner = z[1:] - z[:-1] ** 2
    g[:-1] += -400.0 * z[:-1] * inner - 2.0 * (1 - z[:-1])
    g[1:] += 200.0 * inner
    return f, g


def _rosen_jax(x):
    fn = lambda z: jnp.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2
                           + (1 - z[:-1]) ** 2)
    return fn(x), jax.grad(fn)(x)


def _logistic(rng, n=1500, d=D):
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ w))).astype(np.float64)
    jb = JBatch(jnp.asarray(X), jnp.asarray(y))
    pb = DataBatch.from_numpy(X, y, device="cpu", dtype=torch.float64)
    return jb, pb


def _glm_vgs(jloss, ploss, jb, pb, lam):
    jo, po = JObjective(jloss), GLMObjective(ploss)
    jh, ph = JHyper.of(lam, dtype=jnp.float64), Hyper.of(lam)
    jvg = lambda c: jo.value_and_gradient(c, jb, jh)
    pvg = lambda c: po.value_and_gradient(c, pb, ph)
    jhm = lambda c: jo.hessian_matrix(c, jb, jh)
    phm = lambda c: po.hessian_matrix(c, pb, ph)
    return jvg, pvg, jhm, phm


def test_lbfgs_rosenbrock_matches_jax():
    cfg = dict(max_iterations=300, tolerance=1e-12)
    jres = jax.jit(lambda x: jlbfgs.minimize(
        _rosen_jax, x, config=JSolverConfig(**cfg)))(jnp.zeros(10))
    res = lbfgs.minimize(_rosen_torch, torch.zeros(10, dtype=torch.float64),
                         config=SolverConfig(**cfg))
    _same(res, jres, tol=dict(rtol=1e-5, atol=1e-6))
    assert float(torch.linalg.vector_norm(res.coef - 1.0)) < 1e-5
    assert _rosen_np(res.coef.numpy()) < 1e-10


def test_lbfgs_quadratic_exact_matches_jax(rng):
    A = rng.normal(size=(25, 25))
    Q = A @ A.T + 25 * np.eye(25)
    b = rng.normal(size=25)
    Qj, bj, Qt, bt = jnp.asarray(Q), jnp.asarray(b), torch.tensor(Q), \
        torch.tensor(b)
    cfg = dict(tolerance=1e-13, max_iterations=400)
    jres = jlbfgs.minimize(lambda x: (0.5 * x @ Qj @ x - bj @ x, Qj @ x - bj),
                           jnp.zeros(25), config=JSolverConfig(**cfg))
    res = lbfgs.minimize(lambda x: (0.5 * x @ Qt @ x - bt @ x, Qt @ x - bt),
                         torch.zeros(25, dtype=torch.float64),
                         config=SolverConfig(**cfg))
    _same(res, jres)
    np.testing.assert_allclose(res.coef.numpy(), np.linalg.solve(Q, b),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("tol,max_it", [(1e-12, 300), (1e-6, 100), (0.0, 7)])
def test_lbfgs_logistic_matches_jax(rng, tol, max_it):
    jb, pb = _logistic(rng)
    jvg, pvg, _, _ = _glm_vgs(JLogistic, LogisticLoss, jb, pb, 1.0)
    cfg = dict(tolerance=tol, max_iterations=max_it, track_states=4)
    jres = jlbfgs.minimize(jvg, jnp.zeros(D), config=JSolverConfig(**cfg))
    res = lbfgs.minimize(pvg, torch.zeros(D, dtype=torch.float64),
                         config=SolverConfig(**cfg))
    _same(res, jres)
    np.testing.assert_allclose(float(res.value), float(jres.value),
                               rtol=1e-12)
    if res.iterations == int(jres.iterations):
        np.testing.assert_allclose(res.loss_history.numpy(),
                                   np.asarray(jres.loss_history), rtol=1e-10)
    # the host reads the Python loop pays, counted exactly: one at the
    # start, then per iteration one for the direction, one per line-search
    # evaluation and one for the accepted step
    assert res.host_syncs == 2 * res.iterations + res.num_fun_evals


@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_newton_matches_jax(rng, loss):
    if loss == "logistic":
        jb, pb = _logistic(rng, n=600)
        pair, lam = (JLogistic, LogisticLoss), 0.5
    else:
        n = 800
        X = rng.normal(size=(n, D)) * 0.3
        y = rng.poisson(np.exp(X @ (rng.normal(size=D) * 0.5))).astype(
            np.float64)
        jb = JBatch(jnp.asarray(X), jnp.asarray(y))
        pb = DataBatch.from_numpy(X, y, device="cpu", dtype=torch.float64)
        pair, lam = (JPoisson, PoissonLoss), 1e-3
    jvg, pvg, jhm, phm = _glm_vgs(*pair, jb, pb, lam)
    cfg = dict(max_iterations=50, tolerance=1e-12)
    jres = jnewton.minimize(jvg, jhm, jnp.zeros(D),
                            config=JSolverConfig(**cfg))
    res = newton.minimize(pvg, phm, torch.zeros(D, dtype=torch.float64),
                          config=SolverConfig(**cfg))
    _same(res, jres)
    assert res.reason in (ConvergenceReason.FUNCTION_VALUES_CONVERGED,
                          ConvergenceReason.GRADIENT_CONVERGED)
    # one read for the direction per iteration, one per evaluation
    assert res.host_syncs == res.iterations + res.num_fun_evals
    # Newton is the same minimizer as L-BFGS
    lres = lbfgs.minimize(pvg, torch.zeros(D, dtype=torch.float64),
                          config=SolverConfig(tolerance=1e-12,
                                              max_iterations=300))
    np.testing.assert_allclose(res.coef.numpy(), lres.coef.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_newton_non_pd_curvature_falls_back_like_jax():
    """Unregularized squared loss on rank-deficient data: the Cholesky
    fails and the iteration takes steepest descent instead of stopping."""
    X = np.ones((20, 3))
    y = np.linspace(-1, 1, 20)
    Xj, yj, Xt, yt = jnp.asarray(X), jnp.asarray(y), torch.tensor(X), \
        torch.tensor(y)
    jvg = lambda c: (0.5 * jnp.sum((Xj @ c - yj) ** 2), Xj.T @ (Xj @ c - yj))
    pvg = lambda c: (0.5 * torch.sum((Xt @ c - yt) ** 2),
                     Xt.T @ (Xt @ c - yt))
    x0 = np.asarray([1.0, -2.0, 0.5])
    cfg = dict(max_iterations=10, tolerance=1e-10)
    jres = jnewton.minimize(jvg, lambda c: Xj.T @ Xj, jnp.asarray(x0),
                            config=JSolverConfig(**cfg))
    res = newton.minimize(pvg, lambda c: Xt.T @ Xt, torch.tensor(x0),
                          config=SolverConfig(**cfg))
    assert res.reason == int(jres.reason)
    np.testing.assert_allclose(float(res.value), float(jres.value),
                               rtol=1e-8, atol=1e-12)
    assert float(res.value) < float(pvg(torch.tensor(x0))[0])


def test_nonfinite_start_is_a_typed_failure_like_jax():
    jvg = lambda x: (jnp.sum(x) * jnp.nan, x)
    pvg = lambda x: (torch.sum(x) * float("nan"), x)
    for jsolve, psolve in (
            (lambda: jlbfgs.minimize(jvg, jnp.ones(3)),
             lambda: lbfgs.minimize(pvg, torch.ones(3, dtype=torch.float64))),
            (lambda: jnewton.minimize(jvg, lambda c: jnp.eye(3), jnp.ones(3)),
             lambda: newton.minimize(pvg, lambda c: torch.eye(
                 3, dtype=torch.float64), torch.ones(3, dtype=torch.float64)))):
        jres, res = jsolve(), psolve()
        assert res.failure == int(jres.failure) == FailureMode.NON_FINITE_LOSS
        assert res.iterations == int(jres.iterations) == 0
        assert res.reason == int(jres.reason)


@pytest.mark.parametrize("step", [1.0, 0.05, 40.0])
def test_wolfe_linesearch_matches_jax(rng, step):
    """The state machine alone: same accepted step, value, evaluation
    count and success flag from the same start, for a first trial inside,
    short of and past the Wolfe interval."""
    jb, pb = _logistic(rng, n=400)
    jvg, pvg, _, _ = _glm_vgs(JLogistic, LogisticLoss, jb, pb, 0.1)
    x0 = rng.normal(size=D) * 0.3
    jf, jg = jvg(jnp.asarray(x0))
    direction = -np.asarray(jg) * 0.7 + rng.normal(size=D) * 0.05
    want = j_wolfe(jvg, jnp.asarray(x0), jnp.asarray(direction), jf, jg,
                   initial_step=step)
    xt, dt = torch.tensor(x0), torch.tensor(direction)
    f_t, g = pvg(xt)
    f0, d0 = base.fetch(f_t, torch.dot(g, dt))
    got = wolfe_linesearch(pvg, xt, dt, f0, g, d0, f_t, initial_step=step)
    assert got.num_evals == int(want.num_evals)
    assert got.success == bool(want.success)
    np.testing.assert_allclose(float(got.step), float(want.step), rtol=1e-10)
    np.testing.assert_allclose(float(got.f), float(want.f), rtol=1e-12)
    np.testing.assert_allclose(got.g.numpy(), np.asarray(want.g), rtol=1e-9,
                               atol=1e-12)


def test_box_bounds_raise_typed():
    with pytest.raises(ValueError, match="L-BFGS-B"):
        lbfgs.minimize(lambda x: (x @ x, 2 * x), torch.zeros(3),
                       config=SolverConfig(lower_bounds=-torch.ones(3)))


@pytest.mark.parametrize("name", ["TRON", "OWLQN", "LBFGSB", "DIRECT",
                                  "SDCA"])
def test_unported_optimizer_types_raise_typed(name):
    from photon_tpu_torch.optim.problem import (GLMOptimizationConfiguration,
                                                GlmOptimizationProblem,
                                                OptimizerConfig)
    from photon_tpu_torch.types import OptimizerType, TaskType

    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType[name]))
    with pytest.raises(ValueError, match="not yet ported"):
        GlmOptimizationProblem(TaskType.LOGISTIC_REGRESSION, cfg)


def test_newton_refuses_what_jax_refuses():
    from photon_tpu_torch.function.objective import L1Regularization
    from photon_tpu_torch.optim.problem import (GLMOptimizationConfiguration,
                                                GlmOptimizationProblem,
                                                OptimizerConfig)
    from photon_tpu_torch.types import OptimizerType, TaskType

    newton_opt = OptimizerConfig(optimizer_type=OptimizerType.NEWTON)
    with pytest.raises(ValueError, match="Hessian"):
        GlmOptimizationProblem(TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
                               GLMOptimizationConfiguration(newton_opt))
    with pytest.raises(ValueError, match="L1"):
        GlmOptimizationProblem(
            TaskType.LOGISTIC_REGRESSION,
            GLMOptimizationConfiguration(newton_opt,
                                         regularization=L1Regularization))
