"""Feature index maps: (name, term) string keys <-> dense column indices.

Reference: photon-api index/IndexMap.scala:22 (Map[String,Int] +
getFeatureName), DefaultIndexMap.scala:27 (in-heap), PalDBIndexMap.scala:43
(partitioned off-heap stores with offset arithmetic),
PalDBIndexMapBuilder.scala:27, loaders (DefaultIndexMapLoader,
PalDBIndexMapLoader); key construction photon-client util/Utils.scala:58,
Constants.scala:31-42.

Re-design: the index map is a host-side concern — device code only
ever sees dense int32 columns. The PalDB off-heap store (a JVM workaround
for executor heap pressure) is replaced by a flat binary store
(index_store.py) that memory-maps for O(1)-ish lookups without
deserializing the whole vocabulary, plus this in-memory map for
host-side building.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

# Reference: Constants.scala:31-42
DELIMITER = "\u0001"
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""
INTERCEPT_KEY = INTERCEPT_NAME + DELIMITER + INTERCEPT_TERM


def feature_key(name: str, term: str = "") -> str:
    """Reference: Utils.getFeatureKey (util/Utils.scala:58)."""
    return name + DELIMITER + term


def split_feature_key(key: str) -> Tuple[str, str]:
    """Reference: Utils.getFeatureNameFromKey/getFeatureTermFromKey."""
    name, _, term = key.partition(DELIMITER)
    return name, term


class IndexMap:
    """Bidirectional feature-key <-> index map (reference: IndexMap.scala:22)."""

    def __init__(self, key_to_idx: Optional[Dict[str, int]] = None):
        self._map: Dict[str, int] = dict(key_to_idx or {})
        self._names: Optional[List[str]] = None
        self._dim: Optional[int] = None

    # -- Map behavior --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def items(self):
        return self._map.items()

    def get_index(self, key: str) -> int:
        """Index for a feature key, -1 if absent (reference convention:
        IndexMap.NULL_KEY = -1)."""
        return self._map.get(key, -1)

    def index_of(self, name: str, term: str = "") -> int:
        return self.get_index(feature_key(name, term))

    def get_feature_name(self, idx: int) -> Optional[str]:
        """Feature key for an index (reference: IndexMap.getFeatureName)."""
        if self._names is None:
            names: List[Optional[str]] = [None] * self.feature_dimension
            for k, i in self._map.items():
                names[i] = k
            self._names = names  # type: ignore[assignment]
        if 0 <= idx < len(self._names):
            return self._names[idx]
        return None

    @property
    def feature_dimension(self) -> int:
        """Number of columns = max index + 1. Cached: the map is frozen
        after construction, and the model-load path reads this once per
        coordinate (each read was a full value scan)."""
        if self._dim is None:
            self._dim = (max(self._map.values()) + 1) if self._map else 0
        return self._dim

    @property
    def has_intercept(self) -> bool:
        return INTERCEPT_KEY in self._map

    # -- building ------------------------------------------------------------

    @staticmethod
    def from_keys(keys: Iterable[str], add_intercept: bool = False) -> "IndexMap":
        """Deterministic map: sorted unique keys -> 0..d-1, intercept last
        (the reference appends the intercept too —
        DefaultIndexMapLoader via AvroDataReader.generateIndexMapLoaders)."""
        key_set = set(keys)
        if add_intercept:
            key_set.discard(INTERCEPT_KEY)
        uniq = sorted(key_set)
        m = {k: i for i, k in enumerate(uniq)}
        if add_intercept:
            m[INTERCEPT_KEY] = len(uniq)
        return IndexMap(m)

    @staticmethod
    def from_name_terms(name_terms: Iterable[Tuple[str, str]],
                        add_intercept: bool = False) -> "IndexMap":
        return IndexMap.from_keys(
            (feature_key(n, t) for n, t in name_terms), add_intercept)


class IndexMapBuilder:
    """Incremental builder (reference: PalDBIndexMapBuilder.scala:27):
    feeds observed keys, assigns stable first-seen indices."""

    def __init__(self):
        self._map: Dict[str, int] = {}

    def put(self, key: str) -> int:
        idx = self._map.get(key)
        if idx is None:
            idx = len(self._map)
            self._map[key] = idx
        return idx

    def put_all(self, keys: Iterable[str]) -> "IndexMapBuilder":
        for k in keys:
            self.put(k)
        return self

    def build(self) -> IndexMap:
        return IndexMap(self._map)
