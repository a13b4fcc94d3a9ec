"""Device-resident GAME model state + host-side batch assembly.

The port of ``photon_tpu/serving/model_state.py`` (full-resident tables
on one device). Coefficient arrays go to the device exactly once at
model load — the fixed-effect vectors, and the per-entity random-effect
blocks laid out as gather tables with one explicit zero row for unknown
entities, described to the scorer's kernel by a small device array —
and every request batch only ships its own [B, k] feature arrays, in one
staged copy. Per-request work is a gather + dot, never a model
re-stage.

Host side, the model keeps the lookup tables that turn a request into
arrays: per-shard feature IndexMaps (request (name, term) -> column),
per-coordinate entity rows (REId string -> block row), and the
(entity, feature) -> local-slot tables that replay the offline
projection per batch, so serving scores match offline scoring.

The mesh placement, two-tier coefficient store, int8 and Thompson
mirrors and the nearline append reserve are not carried over yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_tpu_torch.device import DeviceLike, resolve_device
from photon_tpu_torch.io.model_io import ServingGameModel
from photon_tpu_torch.ops.gather_margin import MarginState
from photon_tpu_torch.serving.types import (Fallback, FallbackReason,
                                            ScoreRequest)


@dataclasses.dataclass
class _FixedState:
    coordinate_id: str
    feature_shard_id: str
    theta: torch.Tensor               # device [D] float32


@dataclasses.dataclass
class _RandomState:
    coordinate_id: str
    random_effect_type: str
    feature_shard_id: str
    coef: torch.Tensor                # device [E + 1, K] gather table
    num_entities: int                 # E (the zero row is row E)
    unknown_row: int                  # index scoring as all-zeros
    slot_width: int                   # K
    entity_rows: Dict[str, int]       # REId -> row
    # (entity * D + global_col) -> local slot, as sorted parallel arrays
    # (the project_for_scoring lookup, built once at load)
    pkeys_sorted: np.ndarray          # [P] int64
    pslots_sorted: np.ndarray         # [P] int64


def _pad_width(dim: int, requested: Optional[int]) -> int:
    if requested is not None:
        return max(int(requested), 1)
    p = 1
    while p < dim and p < 256:
        p *= 2
    return p


class DeviceResidentModel:
    """A ServingGameModel staged onto one device, plus assembly.

    ``device=None`` stages on the card and raises ``RuntimeError`` when
    there is none; ``device="cpu"`` stages on the host."""

    def __init__(self, model: ServingGameModel,
                 feature_pad: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.task = model.task
        self.index_maps = model.index_maps

        # one request-feature column space per shard, shared by every
        # coordinate on that shard
        self.shard_order: Tuple[str, ...] = tuple(sorted(model.index_maps))
        self.shard_dims = {sid: m.feature_dimension
                           for sid, m in model.index_maps.items()}
        self.shard_pad = {sid: _pad_width(self.shard_dims[sid], feature_pad)
                          for sid in self.shard_order}

        self.fixed: List[_FixedState] = []
        for fe in model.fixed:
            theta = np.asarray(fe.coefficients, np.float32)
            # gather indices are always < shard dim; pad the vector up so
            # a shard whose map grew (external index maps) still gathers
            dim = max(self.shard_dims.get(fe.feature_shard_id, 0),
                      len(theta), 1)
            if len(theta) < dim:
                theta = np.concatenate(
                    [theta, np.zeros(dim - len(theta), np.float32)])
            self.fixed.append(_FixedState(
                fe.coordinate_id, fe.feature_shard_id, self._put(theta)))
        # the scorer's one coefficient vector: every fixed shard's theta
        # concatenated, with each shard's columns shifted by its offset
        shard_pos = {sid: i for i, sid in enumerate(self.shard_order)}
        self.fixed_pos: Tuple[int, ...] = tuple(
            shard_pos[f.feature_shard_id] for f in self.fixed)
        col_off, total = [], 0
        for f in self.fixed:
            col_off.append(total)
            total += int(f.theta.shape[0])
        self.fixed_col_off: Tuple[int, ...] = tuple(col_off)
        self.theta_all = (torch.cat([f.theta for f in self.fixed])
                          if self.fixed
                          else torch.zeros(1, dtype=torch.float32,
                                           device=self.device))

        self.random: List[_RandomState] = []
        for re in model.random:
            coef = np.asarray(re.coefficients, np.float32)
            E, K = coef.shape
            D = max(self.shard_dims.get(re.feature_shard_id, 1), 1)
            proj = np.asarray(re.projection)
            pe, ps = np.nonzero(proj >= 0)
            pkeys = pe.astype(np.int64) * D + proj[pe, ps].astype(np.int64)
            order = np.argsort(pkeys, kind="stable")
            # one explicit zero row after the real entities: unknown
            # entities gather it and contribute exactly nothing
            coef = np.concatenate([coef, np.zeros((1, K), np.float32)])
            self.random.append(_RandomState(
                re.coordinate_id, re.random_effect_type, re.feature_shard_id,
                self._put(coef), E, E, K, dict(re.entity_rows),
                pkeys[order], ps[order].astype(np.int64)))

        # the scorer's kernel state: theta_all, the gather tables and their
        # descriptors, and the staging buffers. The descriptors hold the
        # tables' addresses, fixed for the model's life: nothing here
        # swaps a table yet, and a coefficient store that does must
        # rebuild them
        self.margin = MarginState(
            self.theta_all, [rs.coef for rs in self.random],
            sum(self.shard_pad[self.shard_order[p]] for p in self.fixed_pos))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- batch assembly (host) ----------------------------------------------

    def assemble(self, requests: Sequence[ScoreRequest], bucket: int,
                 shed_random: bool = False):
        """Pack <=bucket requests into the padded host arrays one scorer
        call consumes. Returns (args tuple, per-request fallback lists,
        counters dict). Pad rows beyond ``len(requests)`` carry zero
        features and the unknown-entity row, so they score to their
        (zero) offset and are discarded by the engine.

        ``args`` = (fixed_idx per shard [bucket, pad] int32, fixed_val per
        shard [bucket, pad] f32, slot idx per random coordinate
        [bucket, K] int64, slot val per random coordinate [bucket, K] f32,
        entity row per random coordinate [bucket] int64, offsets
        [bucket] f32)."""
        n = len(requests)
        if n > bucket:
            raise ValueError(f"{n} requests > bucket {bucket}")
        fallbacks: List[List[Fallback]] = [[] for _ in range(n)]
        counters = {"unknown_features": 0, "truncated_features": 0,
                    "unknown_entities": 0, "padded_rows": bucket - n}

        offsets = np.zeros(bucket, np.float32)
        for i, r in enumerate(requests):
            offsets[i] = r.offset

        # per-shard global-column views, reused by every coordinate below
        shard_cols: Dict[str, List[np.ndarray]] = {}
        shard_vals: Dict[str, List[np.ndarray]] = {}
        for sid in self.shard_order:
            imap = self.index_maps[sid]
            cols_l, vals_l = [], []
            for i, r in enumerate(requests):
                feats = r.features.get(sid) or ()
                cols = np.fromiter(
                    (imap.index_of(name, term) for name, term, _ in feats),
                    np.int64, count=len(feats))
                vals = np.fromiter((v for _, _, v in feats), np.float64,
                                   count=len(feats))
                keep = cols >= 0
                dropped = int(len(cols) - keep.sum())
                if dropped:
                    counters["unknown_features"] += dropped
                    cols, vals = cols[keep], vals[keep]
                pad = self.shard_pad[sid]
                if len(cols) > pad:
                    counters["truncated_features"] += len(cols) - pad
                    fallbacks[i].append(Fallback(
                        FallbackReason.FEATURE_OVERFLOW, coordinate=sid,
                        detail=f"{len(cols)} features > pad {pad}"))
                    cols, vals = cols[:pad], vals[:pad]
                cols_l.append(cols)
                vals_l.append(vals)
            shard_cols[sid] = cols_l
            shard_vals[sid] = vals_l

        fixed_idx, fixed_val = [], []
        for sid in self.shard_order:
            pad = self.shard_pad[sid]
            idx = np.zeros((bucket, pad), np.int32)
            val = np.zeros((bucket, pad), np.float32)
            for i in range(n):
                c, v = shard_cols[sid][i], shard_vals[sid][i]
                idx[i, :len(c)] = c
                val[i, :len(c)] = v
            fixed_idx.append(idx)
            fixed_val.append(val)

        re_slot_idx, re_slot_val, re_ent = [], [], []
        for rs in self.random:
            ent = np.full(bucket, rs.unknown_row, np.int64)
            sidx = np.zeros((bucket, rs.slot_width), np.int64)
            sval = np.zeros((bucket, rs.slot_width), np.float32)
            if not shed_random:
                D = max(self.shard_dims.get(rs.feature_shard_id, 1), 1)
                for i, r in enumerate(requests):
                    re_id = r.entity_ids.get(rs.random_effect_type)
                    e = rs.entity_rows.get(re_id) if re_id is not None else None
                    if e is None:
                        counters["unknown_entities"] += 1
                        fallbacks[i].append(Fallback(
                            FallbackReason.UNKNOWN_ENTITY,
                            coordinate=rs.coordinate_id,
                            detail=str(re_id)))
                        continue
                    ent[i] = e
                    cols = shard_cols[rs.feature_shard_id][i]
                    if not len(cols) or not len(rs.pkeys_sorted):
                        continue
                    # replay project_for_scoring: (e, g) -> local slot via
                    # binary search over the load-time sorted key table
                    keys = e * D + cols
                    rank = np.searchsorted(rs.pkeys_sorted, keys)
                    rank = np.minimum(rank, len(rs.pkeys_sorted) - 1)
                    kept = rs.pkeys_sorted[rank] == keys
                    k = int(kept.sum())
                    sidx[i, :k] = rs.pslots_sorted[rank[kept]]
                    sval[i, :k] = shard_vals[rs.feature_shard_id][i][kept]
            re_slot_idx.append(sidx)
            re_slot_val.append(sval)
            re_ent.append(ent)

        args = (tuple(fixed_idx), tuple(fixed_val), tuple(re_slot_idx),
                tuple(re_slot_val), tuple(re_ent), offsets)
        return args, fallbacks, counters

    def dummy_args(self, bucket: int):
        """Zero-filled arrays of the exact shapes/dtypes ``assemble``
        produces for this bucket — warmup dispatches these."""
        args, _, _ = self.assemble([], bucket)
        return args

    def describe(self) -> dict:
        return {
            "task": self.task.value,
            "device": str(self.device),
            "fixed": [{"coordinate": f.coordinate_id,
                       "shard": f.feature_shard_id,
                       "dim": int(self.shard_dims.get(f.feature_shard_id, 0))}
                      for f in self.fixed],
            "random": [{"coordinate": r.coordinate_id,
                        "type": r.random_effect_type,
                        "shard": r.feature_shard_id,
                        "entities": r.num_entities,
                        "slot_width": r.slot_width}
                       for r in self.random],
            "shard_pad": dict(self.shard_pad),
        }
