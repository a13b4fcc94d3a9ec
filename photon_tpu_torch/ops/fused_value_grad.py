"""Fused GLM value + gradient, one pass over the features (K1 and K2).

The port of ``photon_tpu/ops/pallas_glm.py::fused_dense_value_grad``
(TPU kernel ``_fused``, K1) and ``::fused_sparse_value_grad``
(``_fused_sparse``, K2):

    value = sum_i w_i l(z_i, y_i),   grad = sum_i w_i l'(z_i, y_i) x_i,
    z_i = x_i . coef + off_i

with no L2 term (the objective adds it). ``offsets=None`` / ``weights=None``
mean 0 / 1, ``n == 0`` gives zeros, an ELL of width 0 gives each row its
offset's loss, and an ELL index outside ``[0, D)`` adds 0 (pad slots
``(0, 0.0)`` are inert); duplicate ids in a row accumulate.

For CPU tensors each wrapper takes its plain PyTorch version below. For
CUDA tensors it launches the hand-written kernel
(``csrc/fused_value_grad.cu``: fixed grid of per-block partials reduced
in a fixed order, so reruns are bitwise equal) and raises on what the
kernel does not take; there is no quiet fall back to the plain version on
the card. Which evaluations reach a wrapper is decided by structure in
``ops/aggregators.value_and_gradient``.

``dense_launches`` / ``sparse_launches`` count kernel launches (one per
wrapper call; the plain version is not counted).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops.features import SparseFeatures
from photon_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

KERNEL = "fused_value_grad"
#: largest coefficient dimension K2 takes (its [D] coef and gradient
#: accumulator live in shared memory); the TPU kernel's VMEM limit too
MAX_SPARSE_DIM = 4096
#: feature storage types the kernels read
STORAGE = (torch.float32, torch.bfloat16)

#: K1 launches in this process
dense_launches = 0
#: K2 launches in this process
sparse_launches = 0


def _row_vectors(n: int, labels: Tensor, offsets: Optional[Tensor],
                 weights: Optional[Tensor]):
    f32 = lambda t: t.to(torch.float32)
    y = f32(labels)
    off = None if offsets is None else f32(offsets)
    w = None if weights is None else f32(weights)
    for name, t in (("labels", y), ("offsets", off), ("weights", w)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"fused value+grad: {name} {tuple(t.shape)} "
                             f"!= ({n},)")
    return y, off, w


def _finish(loss: PointwiseLoss, m: Tensor, y: Tensor,
            off: Optional[Tensor], w: Optional[Tensor]):
    z = m if off is None else m + off
    l, dz = loss.loss_and_dz(z, y)
    if w is not None:
        l, dz = l * w, dz * w
    return l.sum(), dz


def fused_dense_value_grad_reference(
        loss: PointwiseLoss, x: Tensor, labels: Tensor,
        offsets: Optional[Tensor], weights: Optional[Tensor],
        coef: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K1 in f32: matvec, loss, rmatvec."""
    n = x.shape[0]
    y, off, w = _row_vectors(n, labels, offsets, weights)
    xf = x.to(torch.float32)
    value, r = _finish(loss, xf @ coef.to(torch.float32), y, off, w)
    return value, r @ xf


def fused_sparse_value_grad_reference(
        loss: PointwiseLoss, x: SparseFeatures, labels: Tensor,
        offsets: Optional[Tensor], weights: Optional[Tensor],
        coef: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K2 in f32: gather, loss, ``index_add_``.
    Indices outside ``[0, D)`` add 0, as in the kernel."""
    n = x.indices.shape[0]
    d = coef.shape[0]
    y, off, w = _row_vectors(n, labels, offsets, weights)
    cols = x.indices.to(torch.int64)
    keep = (cols >= 0) & (cols < d)
    vals = torch.where(keep, x.values.to(torch.float32),
                       torch.zeros((), device=cols.device))
    safe = cols.clamp(0, max(d - 1, 0))
    c32 = coef.to(torch.float32)
    gathered = c32[safe] if d else torch.zeros_like(vals)
    value, r = _finish(loss, (vals * gathered).sum(dim=-1), y, off, w)
    grad = torch.zeros(d, dtype=torch.float32, device=cols.device)
    if d:
        grad.index_add_(0, safe.reshape(-1), (vals * r[:, None]).reshape(-1))
    return value, grad


def _check(name: str, t: Tensor, dtypes, device: torch.device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"fused value+grad: {name} must be one of {dtypes}, "
                        f"got {t.dtype}")
    if t.device != device:
        raise ValueError(f"fused value+grad: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"fused value+grad: {name} must be contiguous")


def _bind(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_longlong] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _scratch(lib: ctypes.CDLL, n: int, d: int, device) -> Tensor:
    fn = lib.fused_value_grad_scratch_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
        fn.restype = ctypes.c_longlong
    return torch.empty(int(fn(n, d)), dtype=torch.float32, device=device)


def _launch(symbol: str, n_ptr: int, loss: PointwiseLoss, storage: Tensor,
            ptrs, ints, n: int, d: int) -> Tuple[Tensor, Tensor]:
    device = storage.device
    lib = cuda_build.load_library(KERNEL)
    fn = _bind(lib, symbol, n_ptr, len(ints))
    scratch = _scratch(lib, n, d, device)
    value = torch.empty((), dtype=torch.float32, device=device)
    grad = torch.empty(d, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(loss.kernel_id, int(storage.dtype == torch.bfloat16),
                 *ptrs, scratch.data_ptr(), value.data_ptr(),
                 grad.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return value, grad


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def fused_dense_value_grad(
        loss: PointwiseLoss, x: Tensor, labels: Tensor,
        offsets: Optional[Tensor], weights: Optional[Tensor],
        coef: Tensor) -> Tuple[Tensor, Tensor]:
    """K1: weighted loss value (0-d f32) and gradient ([D] f32) over dense
    rows ``x`` [n, D] stored as f32 or bf16, X read from device memory
    once. CPU tensors: the plain version. CUDA tensors: one launch."""
    global dense_launches
    if x.dim() != 2 or coef.dim() != 1 or coef.shape[0] != x.shape[1]:
        raise ValueError(f"fused_dense_value_grad: x {tuple(x.shape)} and "
                         f"coef {tuple(coef.shape)} do not match")
    n, d = x.shape
    y, off, w = _row_vectors(n, labels, offsets, weights)
    if x.device.type != "cuda":
        return fused_dense_value_grad_reference(loss, x, y, off, w, coef)
    device = x.device
    _check("x", x, STORAGE, device)
    _check("coef", coef, (torch.float32,), device)
    for name, t in (("labels", y), ("offsets", off), ("weights", w)):
        if t is not None:
            _check(name, t, (torch.float32,), device)
    if n == 0:
        return (torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros(d, dtype=torch.float32, device=device))
    out = _launch("fused_dense_value_grad_launch", 8, loss, x,
                  (x.data_ptr(), y.data_ptr(), _ptr(off), _ptr(w),
                   coef.data_ptr()), (n, d), n, d)
    dense_launches += 1
    return out


def fused_sparse_value_grad(
        loss: PointwiseLoss, x: SparseFeatures, labels: Tensor,
        offsets: Optional[Tensor], weights: Optional[Tensor],
        coef: Tensor) -> Tuple[Tensor, Tensor]:
    """K2: weighted loss value and gradient over padded-ELL rows
    (``indices`` [n, K] int32, ``values`` [n, K] f32 or bf16), the nnz
    stream read once; ``coef`` [D <= 4096] f32. CPU tensors: the plain
    version. CUDA tensors: one launch."""
    global sparse_launches
    idx, val = x.indices, x.values
    if idx.dim() != 2 or val.shape != idx.shape or coef.dim() != 1:
        raise ValueError(f"fused_sparse_value_grad: indices "
                         f"{tuple(idx.shape)}, values {tuple(val.shape)} "
                         f"and coef {tuple(coef.shape)} do not match")
    n, k = idx.shape
    d = coef.shape[0]
    y, off, w = _row_vectors(n, labels, offsets, weights)
    if idx.device.type != "cuda":
        return fused_sparse_value_grad_reference(loss, x, y, off, w, coef)
    if d > MAX_SPARSE_DIM:
        raise ValueError(f"fused_sparse_value_grad: D={d} > "
                         f"{MAX_SPARSE_DIM}, the kernel's shared-memory "
                         f"limit")
    device = idx.device
    _check("indices", idx, (torch.int32,), device)
    _check("values", val, STORAGE, device)
    _check("coef", coef, (torch.float32,), device)
    for name, t in (("labels", y), ("offsets", off), ("weights", w)):
        if t is not None:
            _check(name, t, (torch.float32,), device)
    if n == 0:
        return (torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros(d, dtype=torch.float32, device=device))
    out = _launch("fused_sparse_value_grad_launch", 9, loss, val,
                  (idx.data_ptr(), val.data_ptr(), y.data_ptr(), _ptr(off),
                   _ptr(w), coef.data_ptr()), (n, k, d), n, d)
    sparse_launches += 1
    return out
