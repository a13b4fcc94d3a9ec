"""Losses, features, normalization, aggregators and the GLM objective:
the port against the JAX package.

Seeded numpy inputs go through ``photon_tpu.ops.{losses, features,
normalization, aggregators}`` / ``photon_tpu.function.objective`` and
through the port's counterparts on ``device="cpu"``, in float64 (the JAX
tests run with x64 on), at ``tests/test_losses.py`` /
``tests/test_aggregators.py``'s shapes. Float64 results agree to
rtol 1e-10 (the same algebra, sums taken in other orders). The routing
checks run in float32 and use the kernel launch and route counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_tpu.data.dataset import DataBatch as JBatch
from photon_tpu.function.objective import GLMObjective as JObjective
from photon_tpu.function.objective import Hyper as JHyper
from photon_tpu.ops import aggregators as jagg
from photon_tpu.ops import features as JF
from photon_tpu.ops import losses as JL
from photon_tpu.ops import normalization as JN
from photon_tpu.ops import pallas_glm
from photon_tpu_torch.data.dataset import DataBatch
from photon_tpu_torch.function.objective import GLMObjective, Hyper
from photon_tpu_torch.ops import aggregators as agg
from photon_tpu_torch.ops import features as F
from photon_tpu_torch.ops import fused_value_grad as fvg
from photon_tpu_torch.ops import losses as L
from photon_tpu_torch.ops import normalization as N

TOL = dict(rtol=1e-10, atol=1e-12)
N_ROWS, D = 48, 11
LOSS_PAIRS = [(JL.LogisticLoss, L.LogisticLoss), (JL.SquaredLoss, L.SquaredLoss),
              (JL.PoissonLoss, L.PoissonLoss),
              (JL.SmoothedHingeLoss, L.SmoothedHingeLoss)]
LOSS_IDS = [p[1].name for p in LOSS_PAIRS]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


def _labels(name, rng, n):
    if name in ("logistic", "smoothed_hinge"):
        return rng.integers(0, 2, size=n).astype(np.float64)
    if name == "poisson":
        return rng.poisson(3.0, size=n).astype(np.float64)
    return rng.normal(size=n)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", LOSS_PAIRS, ids=LOSS_IDS)
def test_losses_match_jax(pair):
    jl, pl = pair
    rng = np.random.default_rng(3)
    z = rng.normal(size=64) * 2.0
    y = _labels(pl.name, rng, 64)
    jv, jdz = jl.loss_and_dz(jnp.asarray(z), jnp.asarray(y))
    pv, pdz = pl.loss_and_dz(_t(z), _t(y))
    np.testing.assert_allclose(pv.numpy(), _np(jv), **TOL)
    np.testing.assert_allclose(pdz.numpy(), _np(jdz), **TOL)
    np.testing.assert_allclose(pl.d2z(_t(z), _t(y)).numpy(),
                               _np(jl.d2z(jnp.asarray(z), jnp.asarray(y))),
                               **TOL)
    np.testing.assert_allclose(pl.mean(_t(z)).numpy(),
                               _np(jl.mean(jnp.asarray(z))), **TOL)
    assert pl.has_hessian == jl.has_hessian


def test_log1p_exp_is_stable_and_matches_jax():
    z = np.asarray([-1000.0, -30.0, -1.0, 0.0, 1.0, 30.0, 1000.0])
    got = L.log1p_exp(_t(z)).numpy()
    np.testing.assert_allclose(got, _np(JL.log1p_exp(jnp.asarray(z))),
                               rtol=1e-15)
    assert np.isfinite(got).all() and got[-1] == 1000.0
    # the f32 kernel's logistic formula in plain arithmetic
    z32 = z.astype(np.float32)
    formula = (np.maximum(z32, 0) + np.log1p(np.exp(-np.abs(z32))))
    np.testing.assert_allclose(got.astype(np.float32), formula, rtol=1e-6)


def test_loss_for_task_matches_jax():
    from photon_tpu.types import TaskType as JTask
    from photon_tpu_torch.types import TaskType

    for task in TaskType:
        assert L.loss_for_task(task).name == \
            JL.loss_for_task(JTask(task.value)).name


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


def _features(rng, k_cap=None):
    dense = rng.normal(size=(N_ROWS, D))
    dense = dense * (rng.random((N_ROWS, D)) < 0.4)
    csr = sp.csr_matrix(dense)
    kw = {} if k_cap is None else {"max_nnz": k_cap}
    return (dense, JF.from_scipy_csr(csr, dtype=np.float64, **kw),
            F.from_scipy_csr(csr, dtype=np.float64, **kw))


def test_ell_builders_match_jax():
    rng = np.random.default_rng(5)
    dense, jx, px = _features(rng, k_cap=D)
    np.testing.assert_array_equal(px.indices.numpy(), _np(jx.indices))
    np.testing.assert_array_equal(px.values.numpy(), _np(jx.values))
    assert px.indices.dtype == torch.int32
    csr = sp.csr_matrix(dense)
    pa = F.from_csr_arrays(csr.indptr, csr.indices, csr.data,
                           dtype=np.float64)
    ja = JF.from_csr_arrays(csr.indptr, csr.indices, csr.data,
                            dtype=np.float64)
    np.testing.assert_array_equal(pa.indices.numpy(), _np(ja.indices))
    np.testing.assert_array_equal(pa.values.numpy(), _np(ja.values))
    rows = [(np.nonzero(r)[0], r[np.nonzero(r)[0]]) for r in dense]
    pr, jr = F.from_rows(rows, D), JF.from_rows(rows, D)
    np.testing.assert_array_equal(pr.indices.numpy(), _np(jr.indices))
    np.testing.assert_array_equal(pr.values.numpy(), _np(jr.values))
    with pytest.raises(ValueError):
        F.from_scipy_csr(csr, max_nnz=1)
    with pytest.raises(ValueError):
        F.from_rows(rows, D, max_nnz=1)


@pytest.mark.parametrize("layout", ["dense", "ell", "wide_ell"])
def test_feature_products_match_jax(layout):
    rng = np.random.default_rng(11)
    dense, jx, px = _features(rng)
    if layout == "dense":
        jx, px = jnp.asarray(dense), _t(dense)
    elif layout == "wide_ell":
        # k > 64 takes the densifying weighted_gram branch
        jx = JF.SparseFeatures(jnp.tile(jx.indices, (1, 12)),
                               jnp.tile(jx.values, (1, 12)))
        px = F.SparseFeatures(_t(_np(jx.indices)), _t(_np(jx.values)))
    theta = rng.normal(size=D)
    w = rng.random(N_ROWS) + 0.5
    jt, jw, pt, pw = jnp.asarray(theta), jnp.asarray(w), _t(theta), _t(w)
    assert F.num_samples(px) == JF.num_samples(jx) == N_ROWS
    for got, want in [
            (F.matvec(px, pt), JF.matvec(jx, jt)),
            (F.rmatvec(px, pw, D), JF.rmatvec(jx, jw, D)),
            (F.sq_rmatvec(px, pw, D), JF.sq_rmatvec(jx, jw, D)),
            (F.weighted_gram(px, pw, D), JF.weighted_gram(jx, jw, D)),
            (F.to_dense(px, D), JF.to_dense(jx, D))]:
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_mixed_storage_promotes_like_jax():
    """bf16 features against f32 weights: JAX promotes implicitly, the
    port explicitly, to the same f32 results."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(20, 6)).astype(np.float32)
    w = rng.random(20).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    px = torch.from_numpy(x).to(torch.bfloat16)
    got = F.rmatvec(px, torch.from_numpy(w), 6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               _np(JF.rmatvec(jx, jnp.asarray(w), 6)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(N.NormalizationType),
                         ids=lambda k: k.value)
def test_normalization_context_matches_jax(kind):
    rng = np.random.default_rng(8)
    dense = rng.normal(size=(N_ROWS, D)) * 3.0 + 1.0
    dense[:, -1] = 1.0
    stats = (dense.mean(axis=0), dense.var(axis=0, ddof=1),
             np.abs(dense).max(axis=0))
    pc = N.build_normalization_context(kind, *map(_t, stats),
                                       intercept_index=D - 1)
    jc = JN.build_normalization_context(JN.NormalizationType(kind.value),
                                        *map(jnp.asarray, stats),
                                        intercept_index=D - 1)
    for got, want in ((pc.factors, jc.factors), (pc.shifts, jc.shifts)):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    model = rng.normal(size=D)
    tr = pc.model_to_transformed_space(_t(model), D - 1)
    np.testing.assert_allclose(
        tr.numpy(), _np(jc.model_to_transformed_space(jnp.asarray(model),
                                                      D - 1)), **TOL)
    np.testing.assert_allclose(
        pc.transformed_space_to_model(tr, D - 1).numpy(), model, **TOL)


# ---------------------------------------------------------------------------
# aggregators and the objective
# ---------------------------------------------------------------------------


def _norms(rng, kind):
    factors = rng.random(D) + 0.5
    shifts = rng.normal(size=D)
    f, s = {"none": (None, None), "factors": (factors, None),
            "shifts": (None, shifts), "both": (factors, shifts)}[kind]
    j = JN.NormalizationContext(None if f is None else jnp.asarray(f),
                                None if s is None else jnp.asarray(s))
    p = N.NormalizationContext(None if f is None else _t(f),
                               None if s is None else _t(s))
    return j, p


def _batches(rng, sparse):
    dense, jx, px = _features(rng)
    if not sparse:
        jx, px = jnp.asarray(dense), _t(dense)
    y = rng.integers(0, 2, size=N_ROWS).astype(np.float64)
    off = rng.normal(size=N_ROWS) * 0.3
    w = rng.random(N_ROWS) + 0.5
    jb = JBatch(jx, jnp.asarray(y), jnp.asarray(off), jnp.asarray(w))
    pb = DataBatch(px, _t(y), _t(off), _t(w))
    return jb, pb


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell"])
@pytest.mark.parametrize("kind", ["none", "factors", "shifts", "both"])
@pytest.mark.parametrize("pair", LOSS_PAIRS[:3], ids=LOSS_IDS[:3])
def test_value_and_gradient_and_hessians_match_jax(pair, kind, sparse):
    jl, pl = pair
    rng = np.random.default_rng(42)
    jb, pb = _batches(rng, sparse)
    jn, pn = _norms(rng, kind)
    coef = rng.normal(size=D) * 0.5
    vec = rng.normal(size=D)
    jc, pc = jnp.asarray(coef), _t(coef)
    jargs = (jb.features, jb.labels, jb.offsets, jb.weights)
    pargs = (pb.features, pb.labels, pb.offsets, pb.weights)
    jv, jg = jagg.value_and_gradient(jl, *jargs, jc, jn)
    pv, pg = agg.value_and_gradient(pl, *pargs, pc, pn)
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-10)
    np.testing.assert_allclose(pg.numpy(), _np(jg), **TOL)
    for name, extra in (("hessian_diagonal", ()), ("hessian_matrix", ()),
                        ("hessian_vector", (vec,))):
        jx = [jnp.asarray(e) for e in extra]
        px = [_t(e) for e in extra]
        want = getattr(jagg, name)(jl, *jargs, jc, *jx, jn)
        got = getattr(agg, name)(pl, *pargs, pc, *px, pn)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell"])
def test_objective_matches_jax(sparse):
    rng = np.random.default_rng(17)
    jb, pb = _batches(rng, sparse)
    jn, pn = _norms(rng, "both")
    coef = rng.normal(size=D)
    vec = rng.normal(size=D)
    lam = 0.7
    jo, po = JObjective(JL.LogisticLoss, jn), GLMObjective(L.LogisticLoss, pn)
    jh, ph = JHyper.of(lam, dtype=jnp.float64), Hyper.of(lam)
    jc, pc = jnp.asarray(coef), _t(coef)
    jv, jg = jo.value_and_gradient(jc, jb, jh)
    pv, pg = po.value_and_gradient(pc, pb, ph)
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-10)
    np.testing.assert_allclose(pg.numpy(), _np(jg), **TOL)
    pairs = [
        (po.hessian_vector(pc, _t(vec), pb, ph),
         jo.hessian_vector(jc, jnp.asarray(vec), jb, jh)),
        (po.hessian_diagonal(pc, pb, ph), jo.hessian_diagonal(jc, jb, jh)),
        (po.hessian_matrix(pc, pb, ph), jo.hessian_matrix(jc, jb, jh)),
        (po.hessian_matrix_from_weights(po.hessian_weights(pc, pb), D, pb,
                                        ph),
         jo.hessian_matrix_from_weights(jo.hessian_weights(jc, jb), D, jb,
                                        jh)),
        (po.hessian_vector_from_weights(po.hessian_weights(pc, pb),
                                        _t(vec), pb, ph),
         jo.hessian_vector_from_weights(jo.hessian_weights(jc, jb),
                                        jnp.asarray(vec), jb, jh)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# routing by structure
# ---------------------------------------------------------------------------


def _route_case(case, rng):
    n, d = 64, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    coef = (rng.normal(size=d) * 0.3).astype(np.float32)
    idx = rng.integers(0, d, size=(n, 3)).astype(np.int32)
    val = rng.normal(size=(n, 3)).astype(np.float32)
    norm = N.no_normalization()
    jnorm = JN.no_normalization()
    if case == "dense_f32":
        px, jx = torch.from_numpy(x), jnp.asarray(x)
    elif case == "dense_bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            torch.bfloat16)
    elif case in ("ell_f32", "ell_wide"):
        if case == "ell_wide":
            d = fvg.MAX_SPARSE_DIM + 1
            coef = (rng.normal(size=d) * 0.3).astype(np.float32)
            idx = rng.integers(0, d, size=(n, 3)).astype(np.int32)
        px = F.SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val))
        jx = JF.SparseFeatures(jnp.asarray(idx), jnp.asarray(val))
    elif case == "dense_f64_coef":
        px, jx = torch.from_numpy(x), jnp.asarray(x)
        coef = coef.astype(np.float64)
    else:  # dense_normalized
        px, jx = torch.from_numpy(x), jnp.asarray(x)
        f = (rng.random(d) + 0.5).astype(np.float32)
        norm = N.NormalizationContext(torch.from_numpy(f), None)
        jnorm = JN.NormalizationContext(jnp.asarray(f), None)
    return px, jx, y, coef, norm, jnorm


@pytest.mark.parametrize("case,route", [
    ("dense_f32", "dense_kernel"), ("dense_bf16", "dense_kernel"),
    ("ell_f32", "sparse_kernel"), ("ell_wide", "two_pass"),
    ("dense_f64_coef", "two_pass"), ("dense_normalized", "two_pass")])
def test_routing_by_structure(case, route):
    """f32 dense / ELL (D <= 4096) with identity normalization reach the
    kernel wrappers; f64 coefficients, a normalization and a wide ELL take
    the two-pass path. Each agrees with the JAX two-pass result; on the
    CPU no kernel launches and no two-pass evaluation counts as on the
    card."""
    rng = np.random.default_rng(23)
    px, jx, y, coef, norm, jnorm = _route_case(case, rng)
    agg.reset_counts()
    launches = (fvg.dense_launches, fvg.sparse_launches)
    pv, pg = agg.value_and_gradient(L.LogisticLoss, px, torch.from_numpy(y),
                                    None, None, torch.from_numpy(coef), norm)
    assert agg.routes == {k: int(k == route) for k in agg.routes}
    assert (fvg.dense_launches, fvg.sparse_launches) == launches
    assert agg.two_pass_cuda == 0
    assert agg.kernel_route(px, torch.from_numpy(coef), norm) == (
        None if route == "two_pass" else route)
    jv, jg = jagg.value_and_gradient(JL.LogisticLoss, jx, jnp.asarray(y),
                                     None, None, jnp.asarray(coef), jnorm)
    assert pg.dtype == (torch.float64 if case == "dense_f64_coef"
                        else torch.float32)
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-5)
    np.testing.assert_allclose(pg.numpy(), _np(jg), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", ["f64_coef", "normalized"])
def test_out_of_range_ell_ids_add_zero_on_the_two_pass_route(route):
    """An ELL id outside [0, D) adds 0 on the two-pass route (an f64 coef,
    or a normalization), as on the K2 route (its plain version here) and
    in the Pallas kernel (interpret mode): the id 5 with D = 4 matches no
    column. The normalized case uses factors that are powers of two, so
    coef / f * f is the K2 case's coef exactly; its gradient is f * X^T r."""
    idx = np.array([[0, 5], [1, 2]], np.int32)
    val = np.array([[0.5, -1.0], [2.0, 0.25]], np.float32)
    y = np.array([1.0, 0.0], np.float32)
    coef = np.array([0.3, -0.2, 0.7, 0.1], np.float32)
    x = F.SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val))
    jv, jg = pallas_glm.fused_sparse_value_grad(
        JL.LogisticLoss, JF.SparseFeatures(jnp.asarray(idx), jnp.asarray(val)),
        jnp.asarray(y), None, None, jnp.asarray(coef), interpret=True)
    kv, kg = fvg.fused_sparse_value_grad_reference(
        L.LogisticLoss, x, torch.from_numpy(y), None, None,
        torch.from_numpy(coef))
    f = np.ones(4, np.float32)
    if route == "f64_coef":
        norm, pcoef = N.no_normalization(), torch.from_numpy(coef).double()
    else:
        f = np.array([2.0, 0.5, 4.0, 0.25], np.float32)
        norm = N.NormalizationContext(torch.from_numpy(f), None)
        pcoef = torch.from_numpy(coef / f)
    agg.reset_counts()
    pv, pg = agg.value_and_gradient(L.LogisticLoss, x, torch.from_numpy(y),
                                    None, None, pcoef, norm)
    assert agg.routes["two_pass"] == 1
    tol = dict(rtol=1e-6, atol=1e-6)
    for v in (float(kv), float(jv)):
        np.testing.assert_allclose(float(pv), v, **tol)
    for g in (kg.numpy(), _np(jg)):
        np.testing.assert_allclose(pg.numpy(), f * g, **tol)
    # and the stray slot really added nothing
    z = np.array([0.5 * 0.3, 2.0 * -0.2 + 0.25 * 0.7])
    np.testing.assert_allclose(float(pv), np.sum(np.logaddexp(0, z) - y * z),
                               rtol=1e-6)
