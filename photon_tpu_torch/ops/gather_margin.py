"""Fixed-effect serving margins: ``off + sum_j val[:, j] * theta[idx[:, j]]``.

The port of ``photon_tpu/ops/pallas_glm.py::fused_gather_margin`` (TPU
kernel ``_fused_margin``, K3). The serving scorer concatenates every
fixed shard's padded (index, value) slots against one coefficient vector,
so the whole fixed-effect term is ONE kernel launch per batch.

``gather_margin`` keeps the JAX wrapper's contract: ``n == 0`` gives an
empty result, ``K == 0`` gives the offsets, ``offsets=None`` means zeros,
and an index outside ``[0, D)`` adds 0. For CPU tensors it takes the
plain version, :func:`gather_margin_reference`. For CUDA tensors it
launches the hand-written kernel (``csrc/gather_margin.cu``) and raises
on what the kernel does not take (dtype, device, contiguity, shape);
there is no quiet fall back to the plain version on the card.

``launches`` counts kernel launches in this process.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from photon_tpu_torch.ops import cuda_build

KERNEL = "gather_margin"
#: kernel launches in this process (the plain version is not counted)
launches = 0


def gather_margin_reference(idx: torch.Tensor, val: torch.Tensor,
                            offsets: Optional[torch.Tensor],
                            theta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: mask, gather, multiply, sum, add. Runs on
    any device; the CPU path of :func:`gather_margin` and the yardstick
    the kernel is held against."""
    n, _ = idx.shape
    d = theta.shape[0]
    off = (torch.zeros(n, dtype=torch.float32, device=idx.device)
           if offsets is None else offsets.to(torch.float32))
    cols = idx.to(torch.int64)
    valid = (cols >= 0) & (cols < d)
    if d == 0:
        return off.clone()
    picked = theta.to(torch.float32)[cols.clamp(0, d - 1)]
    contrib = torch.where(valid, val.to(torch.float32) * picked,
                          torch.zeros((), dtype=torch.float32,
                                      device=idx.device))
    return off + contrib.sum(dim=-1)


def _bind(lib: ctypes.CDLL):
    fn = lib.gather_margin_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"gather_margin: {name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"gather_margin: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"gather_margin: {name} must be contiguous")


def gather_margin(idx: torch.Tensor, val: torch.Tensor,
                  offsets: Optional[torch.Tensor],
                  theta: torch.Tensor) -> torch.Tensor:
    """Margins ``offsets + sum_j val[:, j] * theta[idx[:, j]]`` as [n] f32.

    ``idx`` [n, K] int32, ``val`` [n, K] f32, ``offsets`` [n] f32 or
    None, ``theta`` [D] f32. CPU tensors: the plain version. CUDA
    tensors: one launch of the kernel."""
    global launches
    if idx.dim() != 2 or val.shape != idx.shape:
        raise ValueError(f"gather_margin: idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} must be the same [n, K]")
    n = idx.shape[0]
    if offsets is not None and offsets.shape != (n,):
        raise ValueError(f"gather_margin: offsets {tuple(offsets.shape)} "
                         f"!= ({n},)")
    if theta.dim() != 1:
        raise ValueError(f"gather_margin: theta must be 1-D, got "
                         f"{tuple(theta.shape)}")
    if idx.device.type != "cuda":
        if n == 0:
            return torch.zeros(0, dtype=torch.float32, device=idx.device)
        return gather_margin_reference(idx, val, offsets, theta)

    device = idx.device
    _check("idx", idx, torch.int32, device)
    _check("val", val, torch.float32, device)
    _check("theta", theta, torch.float32, device)
    if offsets is not None:
        _check("offsets", offsets, torch.float32, device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return out
    fn = _bind(cuda_build.load_library(KERNEL))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(idx.data_ptr(), val.data_ptr(),
                 None if offsets is None else offsets.data_ptr(),
                 theta.data_ptr(), out.data_ptr(),
                 n, idx.shape[1], theta.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"gather_margin kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
