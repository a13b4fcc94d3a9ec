"""Serving margins, one kernel (K3) for the fixed term and the whole GLMix
margin.

The port of ``photon_tpu/ops/pallas_glm.py::fused_gather_margin`` (TPU
kernel ``_fused_margin``, K3), extended by the random-effect terms that
the JAX scorer adds in the same XLA program
(``photon_tpu/serving/scorer.py::build_scorer_fn``)::

    out[b] = off[b] + sum_j val[b, j] * theta[idx[b, j]]
           + sum_c sum_k sval_c[b, k] * T_c[ent_c[b], sidx_c[b, k]]

Two wrappers launch the one kernel (``csrc/gather_margin.cu``):

* ``gather_margin(idx, val, offsets, theta)`` — the fixed term alone,
  with the JAX wrapper's contract: ``n == 0`` gives an empty result,
  ``K == 0`` gives the offsets, ``offsets=None`` means zeros, and an index
  outside ``[0, D)`` adds 0;
* ``glmix_margin(state, B, with_random)`` — the serving scorer's call:
  the batch is packed into the pinned staging buffer of a
  :class:`MarginState`, and one C call copies it in, launches the kernel
  and copies the [B] result back; the wrapper then waits for it.

Both take the plain versions (:func:`gather_margin_reference`,
:func:`glmix_margin_reference`) for CPU tensors, launch the kernel for
CUDA tensors, and raise on what the kernel does not take; there is no
quiet fall back to the plain version on the card.

``launches`` counts kernel launches in this process.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_tpu_torch.ops import cuda_build

KERNEL = "gather_margin"
#: kernel launches in this process (the plain versions are not counted)
launches = 0
#: int64 words of one coordinate's descriptor: table pointer, table rows
#: (E + 1), slot width K, and the word offsets of ent / sidx / sval in the
#: staged layout divided by the batch's row count
DESC_WORDS = 6
_INT32_MAX = 2**31 - 1


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


def glmix_margin_reference(idx: torch.Tensor, val: torch.Tensor,
                           offsets: Optional[torch.Tensor],
                           theta: torch.Tensor,
                           tables: Sequence[torch.Tensor],
                           ents: Sequence[torch.Tensor],
                           sidxs: Sequence[torch.Tensor],
                           svals: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the whole margin, in the kernel's term
    order: the fixed term plus the offsets, then each coordinate's sum in
    coordinate order. ``tables[c]`` is [E_c + 1, K_c] f32, ``ents[c]``
    [B], ``sidxs[c]`` / ``svals[c]`` [B, K_c]. An ``ent`` outside
    ``[0, E_c]`` or an ``sidx`` outside ``[0, K_c)`` adds 0. Runs on any
    device; the CPU path of :func:`glmix_margin` and its yardstick."""
    total = gather_margin_reference(idx, val, offsets, theta)
    zero = torch.zeros((), dtype=torch.float32, device=idx.device)
    for table, ent, sidx, sval in zip(tables, ents, sidxs, svals):
        rows, k = table.shape
        e = ent.to(torch.int64)
        s = sidx.to(torch.int64)
        ok = (((e >= 0) & (e < rows))[:, None] & (s >= 0) & (s < k))
        picked = torch.gather(table.to(torch.float32)[e.clamp(0, rows - 1)],
                              1, s.clamp(0, max(k - 1, 0)))
        total = total + torch.where(ok, sval.to(torch.float32) * picked,
                                    zero).sum(dim=-1)
    return total


def _bind(lib: ctypes.CDLL):
    fn = lib.glmix_margin_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p])
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
    tensors: one launch of the kernel, with no random-effect terms."""
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
        err = fn(None, None, 0, idx.data_ptr(), val.data_ptr(),
                 None if offsets is None else offsets.data_ptr(),
                 theta.data_ptr(), None, 0, out.data_ptr(), None,
                 n, idx.shape[1], theta.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"gather_margin kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


Arrays = Tuple[object, object, object, List[Tuple[object, object, object]]]


class MarginState:
    """One model's GLMix margin on its device, for :func:`glmix_margin`.

    Built once at model load: ``theta`` [D] f32 (every fixed shard's
    coefficients side by side), the random-effect gather ``tables``
    ([E_c + 1, K_c] f32, last row zero) and their descriptors, a small
    device array the kernel reads (``desc``, [C, DESC_WORDS] int64). The
    descriptors hold the tables' addresses, so a table must not be
    replaced while the state lives.

    It also owns one batch's staging buffers, grown by :meth:`reserve`:
    a host buffer (pinned on the card) of 4-byte words in the kernel's
    layout, and on the card a device buffer of the same layout and the
    [rows] f32 result in device and pinned host memory. The layout for B
    rows, ``k_fixed`` fixed slots and coordinates c = 0..C-1::

        idx [B, k_fixed] int32 | val [B, k_fixed] f32 | off [B] f32 |
        per c: ent_c [B] int32 | sidx_c [B, K_c] int32 | sval_c [B, K_c] f32

    :meth:`layout` gives where each array lies in it (the descriptors
    carry the same offsets to the kernel). One batch at a time: a caller holds ``lock`` from packing a batch
    through its :func:`glmix_margin` call (``scorer.dispatch`` does), and
    the call returns only once its copies are done, so the next batch may
    be packed right away."""

    def __init__(self, theta: torch.Tensor, tables: Sequence[torch.Tensor],
                 k_fixed: int):
        self.device = theta.device
        _check("theta", theta, torch.float32, self.device)
        if theta.dim() != 1:
            raise ValueError(f"glmix_margin: theta must be 1-D, got "
                             f"{tuple(theta.shape)}")
        self.theta = theta
        self.tables = tuple(tables)
        self.k_fixed = int(k_fixed)
        self.slot_widths = tuple(int(t.shape[1]) for t in self.tables)
        words = 2 * self.k_fixed + 1          # per row, fixed part
        #: words per row of the layout holding the first c coordinates
        self.row_words = [words]
        self.units: List[Tuple[int, int, int]] = []
        desc = []
        for t in self.tables:
            _check("table", t, torch.float32, self.device)
            if t.dim() != 2 or t.shape[0] < 1:
                raise ValueError(f"glmix_margin: a table must be "
                                 f"[E + 1, K], got {tuple(t.shape)}")
            rows, k = t.shape
            if rows > _INT32_MAX or k > _INT32_MAX:
                # ent / sidx are packed as int32 (see the scorer's pack)
                raise ValueError(f"glmix_margin: table {tuple(t.shape)} "
                                 f"past int32 rows or slots")
            unit = (words, words + 1, words + 1 + k)
            self.units.append(unit)
            desc.append((t.data_ptr(), rows, k) + unit)
            words += 1 + 2 * k
            self.row_words.append(words)
        self.desc = torch.tensor(desc, dtype=torch.int64).reshape(
            -1, DESC_WORDS).to(self.device)
        self.rows = 0
        self.host = self.host_np = None
        self.dev = self.out = self.host_out = self.host_out_np = None
        self._done = None
        self.lock = threading.Lock()

    def reserve(self, rows: int) -> None:
        """Staging buffers for batches of up to ``rows`` rows, with every
        coordinate. Allocates only when ``rows`` is past what it holds."""
        if rows <= self.rows:
            return
        words = rows * self.row_words[-1]
        on_card = self.device.type == "cuda"
        self.host = torch.empty(words, dtype=torch.int32, pin_memory=on_card)
        self.host_np = self.host.numpy()
        if on_card:
            self.dev = torch.empty(words, dtype=torch.int32,
                                   device=self.device)
            self.out = torch.empty(rows, dtype=torch.float32,
                                   device=self.device)
            self.host_out = torch.empty(rows, dtype=torch.float32,
                                        pin_memory=True)
            self.host_out_np = self.host_out.numpy()
            self._done = torch.cuda.Event()
        self.rows = rows

    def layout(self, B: int, with_random: bool):
        """Word offsets of one staged batch of B rows: (idx, val, off,
        [(ent, sidx, sval) per coordinate, none without ``with_random``],
        words in all)."""
        kf = self.k_fixed
        n = len(self.units) if with_random else 0
        coords = [tuple(B * u for u in unit) for unit in self.units[:n]]
        return 0, B * kf, 2 * B * kf, coords, B * self.row_words[n]

    def arrays(self, buf, B: int, with_random: bool) -> Arrays:
        """Views of one staged batch in ``buf`` (the int32 host array, its
        torch tensor, or the device buffer): (idx, val, off, [(ent, sidx,
        sval) per coordinate, none without ``with_random``])."""
        f = (buf.view(np.float32) if isinstance(buf, np.ndarray)
             else buf.view(torch.float32))
        kf = self.k_fixed
        i, v, o, spans, _ = self.layout(B, with_random)
        coords = [(buf[e:e + B], buf[s:s + B * k].reshape(B, k),
                   f[w:w + B * k].reshape(B, k))
                  for (e, s, w), k in zip(spans, self.slot_widths)]
        return (buf[i:i + B * kf].reshape(B, kf),
                f[v:v + B * kf].reshape(B, kf), f[o:o + B], coords)

    def launch_args(self, B: int, with_random: bool):
        """The C launcher's view of one staged batch in the device buffer:
        (bytes to copy in, idx / val / off addresses, the descriptors'
        address or None, the coordinate count)."""
        i, v, o, spans, words = self.layout(B, with_random)
        dev = self.dev.data_ptr()
        return (4 * words, dev + 4 * i, dev + 4 * v, dev + 4 * o,
                self.desc.data_ptr() if spans else None, len(spans))


def glmix_margin(state: MarginState, B: int,
                 with_random: bool) -> torch.Tensor:
    """Margins of the batch packed in ``state``'s host buffer (B rows,
    with every random-effect coordinate, or none for fixed-only) as a new
    [B] f32 CPU tensor. The caller holds ``state.lock`` from the pack.

    CPU state: the plain version on the packed arrays. On the card: one
    C call issues the copy of the packed words in, the kernel and the
    copy of the result back, on the current stream; the wrapper then
    waits for an event recorded after them (also when the call failed,
    so no copy of the staging buffer is left in flight), raises on a
    CUDA error, and returns a copy of the result, which no later batch
    overwrites."""
    global launches
    if not 1 <= B <= state.rows:
        raise ValueError(f"glmix_margin: {B} rows, staging holds "
                         f"{state.rows}")
    if state.device.type != "cuda":
        idx, val, off, coords = state.arrays(state.host, B, with_random)
        return glmix_margin_reference(
            idx, val, off, state.theta, state.tables[:len(coords)],
            [c[0] for c in coords], [c[1] for c in coords],
            [c[2] for c in coords])
    fn = _bind(cuda_build.load_library(KERNEL))
    nbytes, idx, val, off, desc, n = state.launch_args(B, with_random)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device)
        err = fn(state.host.data_ptr(), state.dev.data_ptr(), nbytes,
                 idx, val, off, state.theta.data_ptr(), desc, n,
                 state.out.data_ptr(), state.host_out.data_ptr(),
                 B, state.k_fixed, state.theta.shape[0], stream.cuda_stream)
        state._done.record(stream)
        state._done.synchronize()
    if err != 0:
        raise RuntimeError(f"glmix_margin: copy or kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return torch.from_numpy(state.host_out_np[:B].copy())
