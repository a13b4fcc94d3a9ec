"""Entity vocabulary: string REId <-> dense entity row, per type.

The port's copy of ``EntityVocabulary`` from
``photon_tpu/game/dataset.py``; the training data frames arrive with the
training slice.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class EntityVocabulary:
    """String REId <-> dense entity index, per random-effect type.

    Unseen entities map to -1 (zero score contribution — matching the
    reference, where a missing per-entity model contributes nothing).
    """

    def __init__(self):
        self._maps: Dict[str, Dict[str, int]] = {}
        self._names: Dict[str, List[str]] = {}

    def build(self, re_type: str, ids: Sequence[str]) -> np.ndarray:
        m = self._maps.setdefault(re_type, {})
        names = self._names.setdefault(re_type, [])
        out = np.empty(len(ids), np.int32)
        for i, s in enumerate(ids):
            j = m.get(s)
            if j is None:
                j = len(names)
                m[s] = j
                names.append(s)
            out[i] = j
        return out

    def lookup(self, re_type: str, ids: Sequence[str]) -> np.ndarray:
        m = self._maps.get(re_type, {})
        return np.asarray([m.get(s, -1) for s in ids], np.int32)

    def names(self, re_type: str) -> List[str]:
        return list(self._names.get(re_type, []))

    def size(self, re_type: str) -> int:
        return len(self._names.get(re_type, []))
