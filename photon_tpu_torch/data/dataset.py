"""The training batch: struct-of-arrays over one device.

The port of ``photon_tpu/data/dataset.py`` (reference: photon-lib
data/LabeledPoint.scala:62 — label, features, offset, weight; margin =
x.theta + offset). A whole RDD[LabeledPoint] becomes one DataBatch on the
card.

``DataBatch.from_numpy`` is the constructor from host arrays. Like every
entry point of the port it takes ``device=None``, meaning the card, and
raises ``RuntimeError`` without one; the CPU is used only when the caller
names it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch.device import DeviceLike, resolve_device
from photon_tpu_torch.ops import features as F

Tensor = torch.Tensor


def _tensor(a, dtype: torch.dtype, device: torch.device) -> Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype).contiguous()


class DataBatch(NamedTuple):
    """Struct-of-arrays equivalent of RDD[LabeledPoint]. ``offsets`` also
    carries coordinate-descent residual scores."""

    features: F.FeatureMatrix
    labels: Tensor                      # [n]
    offsets: Optional[Tensor] = None    # [n]
    weights: Optional[Tensor] = None    # [n]

    @classmethod
    def from_numpy(cls, features, labels, offsets=None, weights=None, *,
                   device: DeviceLike = None,
                   dtype: torch.dtype = torch.float32,
                   feature_dtype: Optional[torch.dtype] = None
                   ) -> "DataBatch":
        """A batch on ``device`` from numpy arrays or tensors.

        ``features`` is a dense [n, d] array or a ``SparseFeatures``
        (indices become int32). Labels, offsets and weights take
        ``dtype``; feature values take ``feature_dtype`` (``dtype`` when
        None), so ``feature_dtype=torch.bfloat16`` stores features at
        half width while the solve runs in ``dtype``."""
        dev = resolve_device(device)
        fdt = dtype if feature_dtype is None else feature_dtype
        if isinstance(features, F.SparseFeatures):
            feats = F.SparseFeatures(
                _tensor(features.indices, torch.int32, dev),
                _tensor(features.values, fdt, dev))
        else:
            feats = _tensor(features, fdt, dev)
        opt = lambda a: None if a is None else _tensor(a, dtype, dev)
        return cls(feats, _tensor(labels, dtype, dev), opt(offsets),
                   opt(weights))

    @property
    def num_samples(self) -> int:
        return F.num_samples(self.features)

    def to(self, device: torch.device) -> "DataBatch":
        """This batch on ``device`` (itself when already there)."""
        if self.labels.device == device:
            return self
        move = lambda t: None if t is None else t.to(device)
        return DataBatch(self.features.to(device), self.labels.to(device),
                         move(self.offsets), move(self.weights))
