"""The training slice as a whole: fixed-effect GLM fits through the port's
``train_generalized_linear_model`` / ``GlmOptimizationProblem.run`` on
``device="cpu"`` against the JAX package's on the same data.

Data: the fixed-effect part of the flagship GLMix synthetic
(``bench.py::config_glmix_logistic``, ``:484-516``: d_global = 256,
features N(0, 1/256), the per-user term folded into the labels as noise)
at n = 3,000 training and 1,000 validation rows. The padded-ELL variant
keeps 32 random features of each row.

Bars: the validation AUC of every fit within 0.005 of the JAX fit's (the
bar ``bench.py:641`` holds against sklearn); float32 coefficients within
a relative L2 distance of 2e-3 (both solves stop at tolerance 1e-6 on
float32 sums taken in different orders); float64 coefficients within
rtol 1e-6 / atol 1e-8 and the same convergence reasons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_tpu.data.dataset import DataBatch as JBatch
from photon_tpu.estimators.model_training import \
    train_generalized_linear_model as j_train
from photon_tpu.evaluation import evaluators as jev
from photon_tpu.function.objective import L2Regularization as JL2
from photon_tpu.ops import features as JF
from photon_tpu.ops import normalization as JN
from photon_tpu.optim.problem import GLMOptimizationConfiguration as JCfg
from photon_tpu.optim.problem import GlmOptimizationProblem as JProblem
from photon_tpu.optim.problem import OptimizerConfig as JOpt
from photon_tpu.types import OptimizerType as JOptType
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.data.dataset import DataBatch
from photon_tpu_torch.estimators.model_training import \
    train_generalized_linear_model
from photon_tpu_torch.evaluation import evaluators as ev
from photon_tpu_torch.function.objective import L2Regularization
from photon_tpu_torch.models.glm import glm_from_arrays
from photon_tpu_torch.ops import aggregators as agg
from photon_tpu_torch.ops import features as F
from photon_tpu_torch.ops import normalization as N
from photon_tpu_torch.optim.problem import (GLMOptimizationConfiguration,
                                            GlmOptimizationProblem,
                                            OptimizerConfig)
from photon_tpu_torch.types import OptimizerType, TaskType

D_GLOBAL, N_USERS, D_USER = 256, 1_000, 4
N_TRAIN, N_VAL, K_ELL = 3_000, 1_000, 32
LAMBDAS = (10.0, 1.0)
AUC_BAR = 0.005
F32_COEF_REL = 2e-3
F64_TOL = dict(rtol=1e-6, atol=1e-8)


def _flagship(n, seed):
    """bench.py's ``make``: the global features and labels."""
    w_rng = np.random.default_rng(99)
    w_g = w_rng.normal(size=D_GLOBAL)
    w_u = w_rng.normal(size=(N_USERS, D_USER)) * 1.5
    r = np.random.default_rng(seed)
    xg = r.normal(size=(n, D_GLOBAL)).astype(np.float32) / np.sqrt(D_GLOBAL)
    users = r.integers(0, N_USERS, size=n)
    xu = r.normal(size=(n, D_USER)).astype(np.float32)
    logits = xg @ w_g + np.einsum("nk,nk->n", xu, w_u[users])
    y = (r.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    return xg, y


def _ell(x, seed):
    r = np.random.default_rng(seed)
    keep = np.zeros_like(x, dtype=bool)
    for i in range(x.shape[0]):
        keep[i, r.choice(x.shape[1], size=K_ELL, replace=False)] = True
    return sp.csr_matrix(np.where(keep, x, 0.0))


@pytest.fixture(scope="module")
def data():
    x, y = _flagship(N_TRAIN, 0)
    xv, yv = _flagship(N_VAL, 1)
    return {"dense": (x, y, xv, yv),
            "ell": (_ell(x, 2), y, _ell(xv, 3), yv)}


def _batches(layout, x, y, dtype):
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    if layout == "ell":
        jx = JF.from_scipy_csr(x, max_nnz=K_ELL, dtype=np_dt)
        px = F.from_scipy_csr(x, max_nnz=K_ELL, dtype=np_dt)
    else:
        jx, px = jnp.asarray(x, np_dt), x
    return (JBatch(jx, jnp.asarray(y, np_dt)),
            DataBatch.from_numpy(px, y, device="cpu", dtype=dtype))


def _scores(layout, x, coef):
    if layout == "ell":
        return (x @ coef).astype(np.float64)
    return x.astype(np.float64) @ coef


def _auc(scores, y):
    return float(ev.auc(torch.from_numpy(scores), torch.from_numpy(y)))


def _configs(opt_name, tol):
    jc = JCfg(optimizer=JOpt(optimizer_type=JOptType[opt_name],
                             max_iterations=100, tolerance=tol),
              regularization=JL2)
    pc = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType[opt_name],
                                  max_iterations=100, tolerance=tol),
        regularization=L2Regularization)
    return jc, pc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("layout", ["dense", "ell"])
@pytest.mark.parametrize("opt_name", ["LBFGS", "NEWTON"])
def test_lambda_path_matches_jax(data, opt_name, layout, dtype):
    x, y, xv, yv = data[layout]
    jb, pb = _batches(layout, x, y, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jc, pc = _configs(opt_name, 1e-6)
    jmodels, jstats = j_train(JTask.LOGISTIC_REGRESSION, jb, D_GLOBAL, jc,
                              regularization_weights=LAMBDAS, dtype=jdt)
    agg.reset_counts()
    models, stats = train_generalized_linear_model(
        TaskType.LOGISTIC_REGRESSION, pb, D_GLOBAL, pc,
        regularization_weights=LAMBDAS, dtype=dtype, device="cpu")
    # every evaluation took the route the structure asks for
    kernel = "dense_kernel" if layout == "dense" else "sparse_kernel"
    evals = sum(s.num_fun_evals for s in stats.values())
    want_route = kernel if dtype == torch.float32 else "two_pass"
    assert agg.routes[want_route] == evals
    assert sum(agg.routes.values()) == evals
    for lam in LAMBDAS:
        got = models[lam].coefficients.means.numpy().astype(np.float64)
        want = np.asarray(jmodels[lam].coefficients.means, np.float64)
        assert models[lam].coefficients.means.dtype == dtype
        if dtype == torch.float32:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= F32_COEF_REL, (lam, rel)
        else:
            np.testing.assert_allclose(got, want, **F64_TOL)
            assert stats[lam].reason == int(jstats[lam].reason)
        auc_port = _auc(_scores(layout, xv, got), yv)
        auc_jax = _auc(_scores(layout, xv, want), yv)
        assert abs(auc_port - auc_jax) <= AUC_BAR
        assert auc_port > 0.5      # better than chance


def test_warm_starts_cross_both_ways(data):
    """A JAX fit warm-starts the port through ``glm_from_arrays`` and the
    port's fit warm-starts JAX: each lands where it started, in at most a
    couple of iterations."""
    x, y, _, _ = data["dense"]
    jb, pb = _batches("dense", x, y, torch.float64)
    jc, pc = _configs("LBFGS", 1e-12)
    jm, jr = JProblem(JTask.LOGISTIC_REGRESSION, jc).run(
        jb, dim=D_GLOBAL, regularization_weight=1.0)
    warm = glm_from_arrays(np.asarray(jm.coefficients.means),
                           "LOGISTIC_REGRESSION")
    assert warm.task == TaskType.LOGISTIC_REGRESSION and warm.dim == D_GLOBAL
    pm, pr = GlmOptimizationProblem(TaskType.LOGISTIC_REGRESSION, pc).run(
        pb, initial=warm.coefficients.means, regularization_weight=1.0,
        device="cpu")
    assert pr.iterations <= 2 < int(jr.iterations)
    np.testing.assert_allclose(pm.coefficients.means.numpy(),
                               np.asarray(jm.coefficients.means), rtol=1e-5,
                               atol=1e-6)
    cold, cold_r = GlmOptimizationProblem(TaskType.LOGISTIC_REGRESSION,
                                          pc).run(pb, dim=D_GLOBAL,
                                                  regularization_weight=1.0,
                                                  device="cpu")
    jm2, jr2 = JProblem(JTask.LOGISTIC_REGRESSION, jc).run(
        jb, initial=jnp.asarray(cold.coefficients.means.numpy()),
        regularization_weight=1.0)
    assert int(jr2.iterations) <= 2 < cold_r.iterations
    np.testing.assert_allclose(np.asarray(jm2.coefficients.means),
                               cold.coefficients.means.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_normalized_fit_matches_jax(data):
    """STANDARDIZATION with an intercept: the solve runs in transformed
    space on the two-pass path and the models come back in original
    space, as in the JAX package."""
    x, y, _, _ = data["dense"]
    x = np.concatenate([x[:, :31] * 3.0 + 1.0,
                        np.ones((x.shape[0], 1), np.float32)], axis=1)
    stats = (x.mean(axis=0), x.var(axis=0, ddof=1), np.abs(x).max(axis=0))
    jn = JN.build_normalization_context(
        JN.NormalizationType.STANDARDIZATION, *map(jnp.asarray, stats),
        intercept_index=31)
    pn = N.build_normalization_context(
        N.NormalizationType.STANDARDIZATION,
        *(torch.from_numpy(np.array(s, np.float64)) for s in stats),
        intercept_index=31)
    jc, pc = _configs("LBFGS", 1e-10)
    jb = JBatch(jnp.asarray(x, jnp.float64), jnp.asarray(y))
    pb = DataBatch.from_numpy(x, y, device="cpu", dtype=torch.float64)
    jm, jr = JProblem(JTask.LOGISTIC_REGRESSION, jc, jn, 31).run(
        jb, dim=32, regularization_weight=0.5)
    agg.reset_counts()
    pm, pr = GlmOptimizationProblem(TaskType.LOGISTIC_REGRESSION, pc, pn,
                                    31).run(pb, dim=32,
                                            regularization_weight=0.5,
                                            device="cpu")
    assert agg.routes["two_pass"] == pr.num_fun_evals
    assert pr.reason == int(jr.reason)
    np.testing.assert_allclose(pm.coefficients.means.numpy(),
                               np.asarray(jm.coefficients.means), **F64_TOL)


def test_auc_and_rmse_match_jax():
    rng = np.random.default_rng(4)
    scores = np.round(rng.normal(size=500), 1)      # many ties
    labels = (rng.random(500) < 0.4).astype(np.float64)
    weights = rng.random(500)
    weights[::7] = 0.0
    for w in (None, weights):
        tw = None if w is None else torch.from_numpy(w)
        jw = None if w is None else jnp.asarray(w)
        np.testing.assert_allclose(
            float(ev.auc(torch.from_numpy(scores), torch.from_numpy(labels),
                         tw)),
            float(jev.auc(jnp.asarray(scores), jnp.asarray(labels), jw)),
            rtol=1e-12)
        np.testing.assert_allclose(
            float(ev.rmse(torch.from_numpy(scores), torch.from_numpy(labels),
                          tw)),
            float(jev.rmse(jnp.asarray(scores), jnp.asarray(labels), jw)),
            rtol=1e-12)
    for task in TaskType:
        assert ev.default_evaluator_for_task(task).value == \
            jev.default_evaluator_for_task(JTask(task.value)).value
