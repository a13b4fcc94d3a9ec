"""Fused value+gradient kernels K1 (dense) and K2 (padded ELL): the port's
plain versions against the JAX package.

The same seeded numpy inputs go through ``photon_tpu.ops.pallas_glm.
fused_dense_value_grad`` / ``fused_sparse_value_grad`` (Pallas, interpret
mode off the TPU, as ``tests/test_pallas_glm.py`` runs them), through the
JAX two-pass ``aggregators.value_and_gradient``, and through the port's
wrappers on CPU tensors, which take the kernels' plain PyTorch versions.
The shapes and edge cases are ``tests/test_pallas_glm.py``'s. Tolerances
(value rtol 5e-6, gradient rtol = atol = 5e-5) are that file's: both
sides sum f32 terms, in different orders. The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops import aggregators as jagg
from photon_tpu.ops import features as JF
from photon_tpu.ops import losses as JL
from photon_tpu.ops import pallas_glm
from photon_tpu.ops.normalization import no_normalization
from photon_tpu_torch.ops import fused_value_grad as fvg
from photon_tpu_torch.ops import losses as PL
from photon_tpu_torch.ops.features import SparseFeatures

VALUE_RTOL = 5e-6
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)

LOSSES = [(JL.LogisticLoss, PL.LogisticLoss), (JL.SquaredLoss, PL.SquaredLoss),
          (JL.PoissonLoss, PL.PoissonLoss),
          (JL.SmoothedHingeLoss, PL.SmoothedHingeLoss)]
LOSS_IDS = [p[1].name for p in LOSSES]


def _j(a, dtype=None):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.as_tensor(np.array(a)).to(dtype)


def _dense_problem(n, d, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) > 0.4).astype(np.float32)
    off = (rng.normal(size=n) * 0.2).astype(np.float32)
    w = (rng.random(n) + 0.1).astype(np.float32)
    coef = (rng.normal(size=d) * 0.4).astype(np.float32)
    return x, y, off, w, coef


def _sparse_problem(n, k, d, seed=13):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = (rng.normal(size=(n, k)) / np.sqrt(max(k, 1))).astype(np.float32)
    y = (rng.random(n) > 0.4).astype(np.float32)
    off = (rng.normal(size=n) * 0.2).astype(np.float32)
    w = (rng.random(n) + 0.1).astype(np.float32)
    coef = (rng.normal(size=d) * 0.4).astype(np.float32)
    return idx, val, y, off, w, coef


def _port_dense(loss, x, y, off, w, coef, xdtype=torch.float32):
    v, g = fvg.fused_dense_value_grad(loss, _t(x, xdtype), _t(y), _t(off),
                                      _t(w), _t(coef))
    assert v.dtype == g.dtype == torch.float32
    return float(v), g.numpy()


def _port_sparse(loss, idx, val, y, off, w, coef, vdtype=torch.float32):
    x = SparseFeatures(_t(idx, torch.int32), _t(val, vdtype))
    v, g = fvg.fused_sparse_value_grad(loss, x, _t(y), _t(off), _t(w),
                                       _t(coef))
    assert v.dtype == g.dtype == torch.float32
    return float(v), g.numpy()


def _close(got, want):
    np.testing.assert_allclose(got[0], float(want[0]), rtol=VALUE_RTOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1], np.float32),
                               **GRAD_TOL)


def _jax_two_pass(jloss, x, y, off, w, coef):
    with pallas_glm.disabled():
        return jagg.value_and_gradient(jloss, x, _j(y), _j(off), _j(w),
                                       _j(coef), no_normalization())


# ---------------------------------------------------------------------------
# K1, dense rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", LOSSES, ids=LOSS_IDS)
def test_dense_matches_pallas_and_two_pass(pair):
    jloss, ploss = pair
    x, y, off, w, coef = _dense_problem(997, 37)   # not tile-aligned
    got = _port_dense(ploss, x, y, off, w, coef)
    _close(got, pallas_glm.fused_dense_value_grad(
        jloss, _j(x), _j(y), _j(off), _j(w), _j(coef), tile_n=256))
    _close(got, _jax_two_pass(jloss, _j(x), y, off, w, coef))


def test_dense_none_offsets_and_weights():
    x, y, _, _, coef = _dense_problem(997, 37)
    got = _port_dense(PL.LogisticLoss, x, y, None, None, coef)
    _close(got, pallas_glm.fused_dense_value_grad(
        JL.LogisticLoss, _j(x), _j(y), None, None, _j(coef)))


@pytest.mark.parametrize("n", [1, 7, 1023, 1025])
def test_dense_tile_remainders(n):
    """Rows past a 1024-row tile: the Pallas wrapper pads with zero-weight
    rows, which must add nothing."""
    x, y, off, w, coef = _dense_problem(n, 8, seed=n)
    got = _port_dense(PL.LogisticLoss, x, y, off, w, coef)
    _close(got, pallas_glm.fused_dense_value_grad(
        JL.LogisticLoss, _j(x), _j(y), _j(off), _j(w), _j(coef)))


def test_dense_zero_weight_rows():
    x, y, off, w, coef = _dense_problem(300, 16)
    w[::3] = 0.0
    got = _port_dense(PL.PoissonLoss, x, y, off, w, coef)
    _close(got, pallas_glm.fused_dense_value_grad(
        JL.PoissonLoss, _j(x), _j(y), _j(off), _j(w), _j(coef)))
    # a zero-weight row's features do not matter at all
    x2 = x.copy()
    x2[::3] = 1e3
    again = _port_dense(PL.PoissonLoss, x2, y, off, w, coef)
    np.testing.assert_allclose(again[0], got[0], rtol=VALUE_RTOL)
    np.testing.assert_allclose(again[1], got[1], **GRAD_TOL)


def test_dense_empty_batch():
    x = np.zeros((0, 5), np.float32)
    y = np.zeros(0, np.float32)
    coef = np.ones(5, np.float32)
    v, g = _port_dense(PL.LogisticLoss, x, y, None, None, coef)
    jv, jg = pallas_glm.fused_dense_value_grad(JL.LogisticLoss, _j(x), _j(y),
                                               None, None, _j(coef))
    assert v == float(jv) == 0.0
    np.testing.assert_array_equal(g, np.asarray(jg))
    np.testing.assert_array_equal(g, np.zeros(5, np.float32))


def test_dense_bf16_storage():
    """bf16 features: both sides read the same bf16 values and accumulate
    in f32, so the f32 tolerances hold."""
    x, y, _, _, coef = _dense_problem(96, 12, seed=9)
    x16 = jnp.asarray(x, jnp.bfloat16)
    x16_np = np.asarray(x16.astype(jnp.float32))   # the exact bf16 values
    got = _port_dense(PL.LogisticLoss, x16_np, y, None, None, coef,
                      xdtype=torch.bfloat16)
    _close(got, pallas_glm.fused_dense_value_grad(
        JL.LogisticLoss, x16, _j(y), None, None, _j(coef)))


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [257, 1025, 8193])
def test_dense_intercept_and_wide_widths(d, xdtype):
    """Widths the kernel takes one element a lane (an intercept column
    added to 256 or 1024 features) or a cluster of blocks a row (past
    8192): the plain version against Pallas, f32 and bf16 storage."""
    x, y, off, w, coef = _dense_problem(70, d, seed=d)
    coef /= np.sqrt(d)
    if xdtype == "bf16":
        xj = jnp.asarray(x, jnp.bfloat16)
        x = np.asarray(xj.astype(jnp.float32))   # the exact bf16 values
        tdtype = torch.bfloat16
    else:
        xj, tdtype = _j(x), torch.float32
    got = _port_dense(PL.LogisticLoss, x, y, off, w, coef, xdtype=tdtype)
    _close(got, pallas_glm.fused_dense_value_grad(
        JL.LogisticLoss, xj, _j(y), _j(off), _j(w), _j(coef), tile_n=64))


# ---------------------------------------------------------------------------
# K2, padded-ELL rows
# ---------------------------------------------------------------------------


def _jax_sparse(jloss, idx, val, y, off, w, coef, tile_n=256, vdtype=None):
    x = JF.SparseFeatures(jnp.asarray(idx, jnp.int32), _j(val, vdtype))
    want = pallas_glm.fused_sparse_value_grad(jloss, x, _j(y), _j(off),
                                              _j(w), _j(coef), tile_n=tile_n)
    return want, x


@pytest.mark.parametrize("pair", LOSSES, ids=LOSS_IDS)
def test_sparse_every_loss_matches_pallas_and_two_pass(pair):
    jloss, ploss = pair
    idx, val, y, off, w, coef = _sparse_problem(200, 5, 64)
    idx[:, 1] = idx[:, 0]                    # duplicate ids accumulate
    got = _port_sparse(ploss, idx, val, y, off, w, coef)
    want, x = _jax_sparse(jloss, idx, val, y, off, w, coef)
    _close(got, want)
    _close(got, _jax_two_pass(jloss, x, y, off, w, coef))


@pytest.mark.parametrize("n", [1, 7, 127, 128, 129, 333])
def test_sparse_tile_remainders(n):
    idx, val, y, off, w, coef = _sparse_problem(n, 4, 64)
    got = _port_sparse(PL.LogisticLoss, idx, val, y, off, w, coef)
    _close(got, _jax_sparse(JL.LogisticLoss, idx, val, y, off, w, coef,
                            tile_n=128)[0])


def test_sparse_zero_weight_rows_and_none_vectors():
    idx, val, y, off, w, coef = _sparse_problem(100, 4, 64)
    w[::3] = 0.0
    got = _port_sparse(PL.LogisticLoss, idx, val, y, off, w, coef)
    _close(got, _jax_sparse(JL.LogisticLoss, idx, val, y, off, w, coef)[0])
    got = _port_sparse(PL.LogisticLoss, idx, val, y, None, None, coef)
    _close(got, _jax_sparse(JL.LogisticLoss, idx, val, y, None, None,
                            coef)[0])


def test_sparse_empty_segments_and_zero_width():
    """All-pad rows contribute only their offset's loss; an ELL of width
    0 is every row empty."""
    idx, val, y, off, w, coef = _sparse_problem(60, 3, 32)
    idx[::4], val[::4] = 0, 0.0
    got = _port_sparse(PL.LogisticLoss, idx, val, y, off, w, coef)
    _close(got, _jax_sparse(JL.LogisticLoss, idx, val, y, off, w, coef)[0])

    k0i, k0v = np.zeros((16, 0), np.int32), np.zeros((16, 0), np.float32)
    got = _port_sparse(PL.LogisticLoss, k0i, k0v, y[:16], off[:16], w[:16],
                       coef)
    want, x = _jax_sparse(JL.LogisticLoss, k0i, k0v, y[:16], off[:16],
                          w[:16], coef)
    _close(got, want)
    _close(got, _jax_two_pass(JL.LogisticLoss, x, y[:16], off[:16], w[:16],
                              coef))
    np.testing.assert_array_equal(got[1], np.zeros(32, np.float32))


def test_sparse_empty_batch():
    v, g = _port_sparse(PL.LogisticLoss, np.zeros((0, 4), np.int32),
                        np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                        None, None, np.zeros(8, np.float32))
    assert v == 0.0
    np.testing.assert_array_equal(g, np.zeros(8, np.float32))


def test_sparse_bf16_values():
    idx, val, y, off, w, coef = _sparse_problem(150, 6, 48)
    v16 = jnp.asarray(val, jnp.bfloat16)
    exact = np.asarray(v16.astype(jnp.float32))
    got = _port_sparse(PL.LogisticLoss, idx, exact, y, off, w, coef,
                       vdtype=torch.bfloat16)
    _close(got, _jax_sparse(JL.LogisticLoss, idx, exact, y, off, w, coef,
                            vdtype=jnp.bfloat16)[0])


@pytest.mark.parametrize("n", [7, 9, 63, 65])
@pytest.mark.parametrize("draw", ["zipf", "one_column"])
def test_sparse_skewed_columns(draw, n):
    """Column ids as real sparse features draw them (Zipf(1.1): a few hot
    columns take most entries) and all in one column, at n around a warp's
    run of rows in the kernel (8) and the rows one block takes a step
    (8 warps x 8 rows = 64)."""
    idx, val, y, off, w, coef = _sparse_problem(n, 32, 1024, seed=n)
    if draw == "zipf":
        rng = np.random.default_rng(n)
        p = np.arange(1, 1025, dtype=np.float64) ** -1.1
        idx = rng.permutation(1024)[rng.choice(1024, size=idx.shape,
                                               p=p / p.sum())]
        idx = idx.astype(np.int32)
    else:
        idx[:] = 517
    got = _port_sparse(PL.LogisticLoss, idx, val, y, off, w, coef)
    want, x = _jax_sparse(JL.LogisticLoss, idx, val, y, off, w, coef)
    _close(got, want)
    _close(got, _jax_two_pass(JL.LogisticLoss, x, y, off, w, coef))


def test_sparse_out_of_range_index_adds_nothing():
    """An index outside [0, D) matches no one-hot column in the Pallas
    kernel: it adds 0 to the margin and to the gradient."""
    idx, val, y, off, w, coef = _sparse_problem(40, 4, 16)
    stray = idx.copy()
    stray[::2, 3] = 16
    stray[1::2, 3] = -1
    kept = val.copy()
    kept[:, 3] = 0.0
    got = _port_sparse(PL.LogisticLoss, stray, val, y, off, w, coef)
    _close(got, _jax_sparse(JL.LogisticLoss, stray, val, y, off, w,
                            coef)[0])
    same = _port_sparse(PL.LogisticLoss, idx, kept, y, off, w, coef)
    np.testing.assert_allclose(got[0], same[0], rtol=VALUE_RTOL)
    np.testing.assert_allclose(got[1], same[1], **GRAD_TOL)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_plain_versions_without_counting():
    before = (fvg.dense_launches, fvg.sparse_launches)
    x, y, off, w, coef = _dense_problem(10, 3)
    _port_dense(PL.LogisticLoss, x, y, off, w, coef)
    idx, val, y, off, w, coef = _sparse_problem(10, 2, 6)
    _port_sparse(PL.LogisticLoss, idx, val, y, off, w, coef)
    assert (fvg.dense_launches, fvg.sparse_launches) == before


@pytest.mark.parametrize("bad", ["coef", "labels", "sparse_values"])
def test_wrappers_reject_mismatched_shapes(bad):
    x = torch.zeros((4, 3))
    y = torch.zeros(4)
    coef = torch.zeros(3)
    if bad == "coef":
        with pytest.raises(ValueError):
            fvg.fused_dense_value_grad(PL.LogisticLoss, x, y, None, None,
                                       torch.zeros(5))
    elif bad == "labels":
        with pytest.raises(ValueError):
            fvg.fused_dense_value_grad(PL.LogisticLoss, x, torch.zeros(3),
                                       None, None, coef)
    else:
        sx = SparseFeatures(torch.zeros((4, 2), dtype=torch.int32),
                            torch.zeros((4, 3)))
        with pytest.raises(ValueError):
            fvg.fused_sparse_value_grad(PL.LogisticLoss, sx, y, None, None,
                                        coef)


def test_kernel_source_has_no_float_atomics():
    """Bitwise reruns need every reduction in a fixed order: no CUDA
    source of the port (K1/K2 and every other ``.cu`` / ``.cuh`` under
    ``csrc/``) uses an atomic operation or an atomic bulk reduction."""
    from photon_tpu_torch.ops import cuda_build

    sources = sorted(f for f in os.listdir(cuda_build.CSRC_DIR)
                     if f.endswith((".cu", ".cuh")))
    assert fvg.KERNEL + ".cu" in sources
    for name in sources:
        src = open(os.path.join(cuda_build.CSRC_DIR, name)).read()
        assert re.search(r"\batomic\w*\s*\(", src) is None, name
        assert re.search(r"\bred\.|cp\.reduce", src) is None, name
    assert cuda_build.library_path(fvg.KERNEL).startswith(
        cuda_build.BUILD_DIR)

