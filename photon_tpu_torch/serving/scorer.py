"""Batch scorers for the serving engine.

The port of ``photon_tpu/serving/scorer.py`` for the modes ``full`` and
``fixed_only``. One scoring call per batch:

* the fixed-effect term: every fixed shard's padded (index, value) slots
  are concatenated against the model's one coefficient vector, each
  shard's columns shifted by its offset (the JAX scorer's
  ``_fused_fixed_margin``), and the whole term, offsets included, is ONE
  call of the gather+margin kernel wrapper (ops/gather_margin.py) —
  always, with no switch: on the card that is one kernel launch;
* the random-effect term (``full`` only) stays plain PyTorch, as the JAX
  package leaves it to XLA: an entity-row gather from the table, a
  slot-aligned gather along the row, a multiply and a sum. Unknown
  entities and pad rows gather the explicit zero row.

Arguments arrive as the host arrays ``DeviceResidentModel.assemble``
packs; ``dispatch`` moves them to the model's device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops import gather_margin as _gm
from photon_tpu_torch.serving.model_state import DeviceResidentModel

#: scoring modes; "fixed_only" is the SLO-shed ladder (random-effect
#: gathers skipped) and is warmed alongside "full" so entering shed mode
#: under load never builds anything
MODES = ("full", "fixed_only")


def fixed_slots(model: DeviceResidentModel, fixed_idx, fixed_val
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate every fixed coordinate's shard slots into one
    ([B, k_total] int32 columns of ``model.theta_all``, [B, k_total]
    f32 values). Pad slots (0, 0.0) stay inert after the shift."""
    if not model.fixed_pos:
        b = fixed_idx[0].shape[0] if fixed_idx else 0
        return np.zeros((b, 0), np.int32), np.zeros((b, 0), np.float32)
    idx = np.concatenate(
        [fixed_idx[p] + np.int32(off)
         for p, off in zip(model.fixed_pos, model.fixed_col_off)], axis=1)
    val = np.concatenate([fixed_val[p] for p in model.fixed_pos], axis=1)
    return idx, val


def dispatch(model: DeviceResidentModel, mode: str, args) -> torch.Tensor:
    """Score one assembled batch in ``mode``; returns [bucket] f32 on the
    model's device (asynchronous on the card)."""
    if mode not in MODES:
        raise ValueError(f"unknown serving mode {mode!r}")
    fixed_idx, fixed_val, re_sidx, re_sval, re_ent, offsets = args
    dev = model.device

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    idx, val = fixed_slots(model, fixed_idx, fixed_val)
    total = _gm.gather_margin(put(idx), put(val), put(offsets),
                              model.theta_all)
    if mode == "full":
        for rs, sidx, sval, ent in zip(model.random, re_sidx, re_sval,
                                       re_ent):
            rows = rs.coef.index_select(0, put(ent))
            total = total + (put(sval)
                             * torch.gather(rows, 1, put(sidx))).sum(dim=-1)
    return total


def warmup_scorers(model: DeviceResidentModel,
                   buckets: Sequence[int]) -> int:
    """Load the kernel library (building it from source if needed) and
    dispatch every (mode, bucket) once on zero inputs, so steady-state
    traffic builds nothing. Returns the number of dispatches."""
    if model.device.type == "cuda":
        cuda_build.load_library(_gm.KERNEL)
    warmed = 0
    for bucket in buckets:
        args = model.dummy_args(bucket)
        for mode in MODES:
            dispatch(model, mode, args)
            warmed += 1
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return warmed
