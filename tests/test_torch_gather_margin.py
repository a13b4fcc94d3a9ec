"""Gather+margin kernel (K3): the port's wrapper against the JAX one.

The same seeded numpy inputs go through ``photon_tpu.ops.pallas_glm.
fused_gather_margin`` (Pallas, interpret mode off the TPU) and through
``photon_tpu_torch.ops.gather_margin.gather_margin`` on CPU tensors, which
takes the kernel's plain PyTorch version. Tolerance atol = rtol = 1e-6:
both sum f32 products, in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops.pallas_glm import fused_gather_margin
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops import gather_margin as gm

TOL = dict(rtol=1e-6, atol=1e-6)


def _both(idx, val, off, theta):
    want = fused_gather_margin(
        jnp.asarray(idx, jnp.int32), jnp.asarray(val, jnp.float32),
        None if off is None else jnp.asarray(off, jnp.float32),
        jnp.asarray(theta, jnp.float32))
    got = gm.gather_margin(
        torch.as_tensor(idx, dtype=torch.int32),
        torch.as_tensor(val, dtype=torch.float32),
        None if off is None else torch.as_tensor(off, dtype=torch.float32),
        torch.as_tensor(theta, dtype=torch.float32))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n", [1, 5, 64, 127, 128, 129])
def test_tile_remainders_match_jax(n):
    rng = np.random.default_rng(21)
    d, k = 96, 6
    idx = rng.integers(0, d, size=(n, k))
    val = rng.normal(size=(n, k))
    off = rng.normal(size=n)
    theta = rng.normal(size=d) * 0.3
    got, want = _both(idx, val, off, theta)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, **TOL)


def test_out_of_range_pads_and_duplicates_match_jax():
    """Indices outside [0, D) add 0 (no one-hot column matches them),
    pad slots (0, 0.0) add 0, duplicate columns accumulate."""
    rng = np.random.default_rng(5)
    n, d, k = 40, 16, 9
    idx = rng.integers(0, d, size=(n, k))
    val = rng.normal(size=(n, k))
    idx[:, 1] = idx[:, 0]                       # duplicates
    idx[::3, 2] = -1
    idx[1::3, 3] = d
    idx[2::3, 4] = d + 11
    idx[:, 5], val[:, 5] = 0, 0.0               # pad slots
    off = rng.normal(size=n)
    theta = rng.normal(size=d)
    got, want = _both(idx, val, off, theta)
    np.testing.assert_allclose(got, want, **TOL)
    # the stray slots really contributed nothing
    keep = (idx >= 0) & (idx < d)
    manual = off + np.sum(np.where(keep, val * theta[np.clip(idx, 0, d - 1)],
                                   0.0), axis=1)
    np.testing.assert_allclose(got, manual, rtol=1e-5, atol=1e-5)


def test_degenerate_shapes_match_jax():
    theta = np.arange(8, dtype=np.float32)
    # empty batch
    got, want = _both(np.zeros((0, 3)), np.zeros((0, 3)), None, theta)
    assert got.shape == want.shape == (0,)
    # zero slot width: margins are the offsets
    off = np.asarray([1.5, -2.0])
    got, want = _both(np.zeros((2, 0)), np.zeros((2, 0)), off, theta)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, off, **TOL)
    # None offsets
    got, want = _both(np.asarray([[2], [5]]), np.asarray([[2.0], [1.0]]),
                      None, theta)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, [4.0, 5.0])


def test_wide_theta_beyond_tpu_vmem_limit():
    """The TPU kernel caps D at 4096; the port has no such limit. Held
    against the JAX wrapper's own expression off the kernel."""
    rng = np.random.default_rng(9)
    n, d, k = 17, 9000, 12
    idx = rng.integers(0, d, size=(n, k))
    val = rng.normal(size=(n, k)).astype(np.float32)
    off = rng.normal(size=n).astype(np.float32)
    theta = rng.normal(size=d).astype(np.float32)
    got = gm.gather_margin(torch.as_tensor(idx, dtype=torch.int32),
                           torch.from_numpy(val), torch.from_numpy(off),
                           torch.from_numpy(theta)).numpy()
    want = np.asarray(jnp.asarray(off) + jnp.sum(
        jnp.asarray(val) * jnp.asarray(theta)[jnp.asarray(idx)], axis=-1))
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_tensors_take_plain_version_without_counting():
    before = gm.launches
    idx = torch.zeros((3, 2), dtype=torch.int32)
    out = gm.gather_margin(idx, torch.ones((3, 2)), None, torch.ones(4))
    torch.testing.assert_close(out, torch.full((3,), 2.0))
    assert gm.launches == before


@pytest.mark.parametrize("bad", ["shape", "offsets", "theta"])
def test_wrapper_rejects_bad_shapes(bad):
    idx = torch.zeros((3, 2), dtype=torch.int32)
    val = torch.zeros((3, 2))
    off = torch.zeros(3)
    theta = torch.zeros(4)
    if bad == "shape":
        val = torch.zeros((3, 3))
    elif bad == "offsets":
        off = torch.zeros(4)
    else:
        theta = torch.zeros((4, 1))
    with pytest.raises(ValueError):
        gm.gather_margin(idx, val, off, theta)


def test_library_path_keyed_by_source_and_flags():
    """The kernel library's build name is a pure function of the source
    bytes and the nvcc flags, inside the package's build directory."""
    p1 = cuda_build.library_path(gm.KERNEL)
    p2 = cuda_build.library_path(gm.KERNEL)
    assert p1 == p2
    assert p1.startswith(cuda_build.BUILD_DIR)
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
