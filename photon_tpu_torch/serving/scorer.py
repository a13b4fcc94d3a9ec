"""Batch scorers for the serving engine.

The port of ``photon_tpu/serving/scorer.py`` for the modes ``full`` and
``fixed_only``. One scoring call per batch, ONE call of the GLMix margin
wrapper (ops/gather_margin.py) for the whole margin, always, with no
switch:

* the fixed-effect term: every fixed shard's padded (index, value) slots
  side by side against the model's one coefficient vector, each shard's
  columns shifted by its offset (the JAX scorer's
  ``_fused_fixed_margin``), offsets included;
* the random-effect terms (``full`` only): per coordinate, the entity's
  row of the gather table, the slot-aligned values along it, multiplied
  and summed. Unknown entities and pad rows gather the explicit zero row.

``dispatch`` packs the host arrays ``DeviceResidentModel.assemble``
builds into the model's staging buffer (``pack``); on the card the
wrapper then makes one C call — one copy in, one kernel launch, one copy
out — and waits for it. On the CPU it runs the plain version on the
packed arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops import gather_margin as _gm
from photon_tpu_torch.serving.model_state import DeviceResidentModel

#: scoring modes; "fixed_only" is the SLO-shed ladder (random-effect
#: gathers skipped) and is warmed alongside "full" so entering shed mode
#: under load never builds anything
MODES = ("full", "fixed_only")


def _same_shape(dst: np.ndarray, src: np.ndarray, what: str) -> None:
    # numpy would broadcast a short array over the rows
    if src.shape != dst.shape:
        raise ValueError(f"scorer: {what} {src.shape} != {dst.shape}")


def pack(model: DeviceResidentModel, with_random: bool, args) -> int:
    """Pack one assembled batch into ``model.margin``'s staging buffer
    (the kernel's layout, ``MarginState``): every fixed shard's slots side
    by side, each shifted by its shard's column offset, the offsets, then
    (``with_random``) every coordinate's entity rows and slots. The int64
    entity rows and slot ids become int32, clipped to [-1, E + 1] and
    [-1, K]: a value out of range stays out of range (and adds 0), so no
    size wraps. Returns the batch's row count. The caller holds
    ``model.margin.lock`` through the kernel call that reads the batch."""
    fixed_idx, fixed_val, re_sidx, re_sval, re_ent, offsets = args
    B = offsets.shape[0]
    state = model.margin
    state.reserve(B)
    idx, val, off, coords = state.arrays(state.host_np, B, with_random)
    col = 0
    for p, shift in zip(model.fixed_pos, model.fixed_col_off):
        w = fixed_idx[p].shape[-1]
        _same_shape(idx[:, col:col + w], fixed_idx[p], "fixed idx")
        _same_shape(val[:, col:col + w], fixed_val[p], "fixed val")
        np.add(fixed_idx[p], np.int32(shift), out=idx[:, col:col + w])
        val[:, col:col + w] = fixed_val[p]
        col += w
    if col != state.k_fixed:
        raise ValueError(f"scorer: {col} fixed slots, model has "
                         f"{state.k_fixed}")
    _same_shape(off, offsets, "offsets")
    off[:] = offsets
    for (ent, sidx, sval), rs, e, s, v in zip(coords, model.random, re_ent,
                                              re_sidx, re_sval):
        _same_shape(ent, e, "entity rows")
        _same_shape(sidx, s, "slot ids")
        _same_shape(sval, v, "slot values")
        np.clip(e, -1, rs.num_entities + 1, out=ent, casting="unsafe")
        np.clip(s, -1, rs.slot_width, out=sidx, casting="unsafe")
        sval[:] = v
    return B


def dispatch(model: DeviceResidentModel, mode: str, args) -> torch.Tensor:
    """Score one assembled batch in ``mode``; returns a new [bucket] f32
    tensor on the host (on the card, once the batch's copies are done).

    The model has one staging buffer, so dispatches on one model take
    turns: each holds ``model.margin.lock`` from its pack through its
    kernel call, and callers on several threads get their own scores."""
    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}")
    with_random = mode == "full"
    with model.margin.lock:
        B = pack(model, with_random, args)
        return _gm.glmix_margin(model.margin, B, with_random)


def warmup_scorers(model: DeviceResidentModel,
                   buckets: Sequence[int]) -> int:
    """Load the kernel library (building it from source if needed), size
    the staging buffers for the largest bucket, and dispatch every (mode,
    bucket) once on zero inputs, so steady-state traffic builds and
    allocates nothing. Returns the number of dispatches."""
    if model.device.type == "cuda":
        cuda_build.load_library(_gm.KERNEL)
    model.margin.reserve(max(buckets, default=0))
    warmed = 0
    for bucket in buckets:
        args = model.dummy_args(bucket)
        for mode in MODES:
            dispatch(model, mode, args)
            warmed += 1
    return warmed
