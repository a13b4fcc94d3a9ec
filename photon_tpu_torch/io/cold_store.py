"""Host-RAM cold tier for per-entity coefficient tables (v1 layout).

The port of the v1 part of ``photon_tpu/io/cold_store.py``: one columnar
file per random-effect coordinate, holding ALL entity rows sorted by
entity id, read zero-copy via ``np.memmap``. ``save_game_model`` writes
it beside the Avro records, and ``load_for_serving`` reads a coordinate's
table from it instead of replaying the per-entity Avro records.

On-disk layout (``photon_tpu.coldstore.v1``), byte-identical to the JAX
package's writer on the same inputs::

    magic      8 bytes   b"PHOTCOLD"
    header     u32 little-endian JSON length, then the JSON header
    sections   each 64-byte aligned, offsets recorded in the header:
        coef   float32 [num_entities, slot_width]   dense coefficients
        proj   int32   [num_entities, slot_width]   global col per local
                                                    slot, -1 padded
        ids    entity-id table: fixed-width byte rows (id_width > 0) or
               u64 offsets[num_entities + 1] + utf-8 blob (id_width == 0)
    footer     u32 crc32 of every preceding byte

The updatable v2 layout, the v3/v4 variance column, in-place deltas and
upgrades are not carried over yet: the reader refuses those files with
:class:`ColdStoreSchemaUnsupported`.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

MAGIC = b"PHOTCOLD"
SCHEMA = "photon_tpu.coldstore.v1"
#: schemas the JAX package writes that this reader recognizes but refuses
LATER_SCHEMAS = ("photon_tpu.coldstore.v2", "photon_tpu.coldstore.v3",
                 "photon_tpu.coldstore.v4")
COLD_STORE_DIR = "cold-store"
COLD_STORE_SUFFIX = ".coldstore"
_ALIGN = 64
_SENTINEL = 10 ** 14  # 15-digit placeholder reserving header field width


class ColdStoreCorruptError(RuntimeError):
    """A cold-store file failed magic/header/crc validation."""

    def __init__(self, path: str, detail: str):
        self.path = path
        super().__init__(f"corrupt cold store at {path}: {detail}")


class ColdStoreSchemaUnsupported(RuntimeError):
    """A well-formed cold-store file in a layout this package does not
    read yet (v2 updatable, v3/v4 with the variance column)."""

    def __init__(self, path: str, schema: str):
        self.path = path
        self.schema = schema
        super().__init__(f"cold store at {path} has schema {schema!r}; "
                         f"only {SCHEMA!r} is supported")


def cold_store_path(model_dir: str, coordinate_id: str) -> str:
    """Canonical location of a coordinate's cold-tier file in a model
    directory, alongside the reference per-coordinate Avro layout."""
    return os.path.join(model_dir, COLD_STORE_DIR,
                        coordinate_id + COLD_STORE_SUFFIX)


def _encode_ids(entity_ids) -> Tuple[np.ndarray, int]:
    """(bytes array [E] dtype S*, fixed width or 0). Ids are compared and
    sorted as utf-8 bytes — the same order ``ColdStore.entity_row``'s
    binary search uses."""
    arr = np.asarray(entity_ids)
    if arr.dtype.kind == "U":
        arr = np.char.encode(arr, "utf-8")
    elif arr.dtype.kind != "S":
        arr = np.asarray([str(e).encode("utf-8") for e in entity_ids],
                         dtype=bytes)
    lengths = np.char.str_len(arr)
    if arr.size and lengths.min() == lengths.max() == arr.dtype.itemsize:
        return arr, int(arr.dtype.itemsize)
    return arr, 0


def _aligned(pos: int) -> int:
    return pos + ((-pos) % _ALIGN)


def normalize_slot_rows(coefficients: np.ndarray, projection: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize coefficient/projection rows to the canonical on-disk
    form: valid slots sorted ascending by global column, -1 pads last.
    Rows already normalized pass through unchanged (stable sort)."""
    coefficients = np.asarray(coefficients, dtype=np.float32)
    projection = np.asarray(projection, dtype=np.int32)
    if coefficients.size and coefficients.shape[-1] > 1:
        key = np.where(projection < 0, np.iinfo(np.int32).max, projection)
        slot_order = np.argsort(key, axis=-1, kind="stable")
        projection = np.take_along_axis(projection, slot_order, axis=-1)
        coefficients = np.take_along_axis(coefficients, slot_order, axis=-1)
    return coefficients, projection


def write_cold_store(
    path: str,
    coordinate_id: str,
    random_effect_type: str,
    feature_shard_id: str,
    coefficients: np.ndarray,
    projection: np.ndarray,
    entity_ids: Union[Sequence[str], np.ndarray],
    chunk_rows: int = 262144,
) -> str:
    """Write one coordinate's v1 cold-tier file; returns its path.

    Rows are re-sorted by entity id internally, so callers pass arrays in
    any order. Streams in ``chunk_rows`` chunks and publishes atomically
    (tmp + fsync + rename)."""
    coefficients = np.asarray(coefficients, dtype=np.float32)
    projection = np.asarray(projection, dtype=np.int32)
    ids, id_width = _encode_ids(entity_ids)
    num_entities, slot_width = coefficients.shape
    if projection.shape != coefficients.shape:
        raise ValueError(f"projection shape {projection.shape} != "
                         f"coefficients shape {coefficients.shape}")
    if ids.shape != (num_entities,):
        raise ValueError(f"{ids.shape[0]} entity ids for "
                         f"{num_entities} rows")
    coefficients, projection = normalize_slot_rows(coefficients, projection)
    order = np.argsort(ids, kind="stable")
    ids = ids[order]

    header = {
        "schema": SCHEMA,
        "coordinate_id": coordinate_id,
        "random_effect_type": random_effect_type,
        "feature_shard_id": feature_shard_id,
        "num_entities": int(num_entities),
        "slot_width": int(slot_width),
        "coef_dtype": "<f4",
        "proj_dtype": "<i4",
        "id_width": id_width,
    }
    # one-pass header layout: reserve maximal-width offset fields, measure
    # the serialized length, then fill real offsets and pad back to the
    # reserved length — the header's byte length never depends on the
    # offset values
    for key in ("coef_off", "proj_off", "id_offsets_off", "id_blob_off",
                "id_blob_len"):
        header[key] = _SENTINEL
    reserved = len(json.dumps(header).encode())
    base = len(MAGIC) + 4 + reserved

    coef_off = _aligned(base)
    proj_off = _aligned(coef_off + num_entities * slot_width * 4)
    id_offsets_off = _aligned(proj_off + num_entities * slot_width * 4)
    if id_width:
        id_blob_off = id_offsets_off
        id_offsets_off = 0
        id_blob_len = num_entities * id_width
    else:
        id_blob_off = _aligned(id_offsets_off + (num_entities + 1) * 8)
        id_blob_len = int(np.char.str_len(ids).sum()) if num_entities else 0
    header.update(coef_off=coef_off, proj_off=proj_off,
                  id_offsets_off=id_offsets_off, id_blob_off=id_blob_off,
                  id_blob_len=id_blob_len)
    header_bytes = json.dumps(header).encode()
    header_bytes += b" " * (reserved - len(header_bytes))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    crc = 0
    pos = 0
    with open(tmp, "wb") as f:

        def put(data: bytes) -> None:
            nonlocal crc, pos
            f.write(data)
            crc = zlib.crc32(data, crc)
            pos += len(data)

        def pad() -> None:
            gap = (-pos) % _ALIGN
            if gap:
                put(b"\x00" * gap)

        put(MAGIC)
        put(len(header_bytes).to_bytes(4, "little"))
        put(header_bytes)
        pad()
        for lo in range(0, num_entities, chunk_rows):
            sel = order[lo:lo + chunk_rows]
            put(np.ascontiguousarray(coefficients[sel]).tobytes())
        pad()
        for lo in range(0, num_entities, chunk_rows):
            sel = order[lo:lo + chunk_rows]
            put(np.ascontiguousarray(projection[sel]).tobytes())
        pad()
        if id_width:
            put(ids.tobytes())
        else:
            lengths = np.char.str_len(ids).astype(np.uint64)
            offsets = np.zeros(num_entities + 1, dtype=np.uint64)
            np.cumsum(lengths, out=offsets[1:])
            put(offsets.tobytes())
            pad()
            for lo in range(0, num_entities, chunk_rows):
                put(b"".join(bytes(s) for s in ids[lo:lo + chunk_rows]))
        f.write(crc.to_bytes(4, "little"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class ColdStore:
    """Zero-copy reader over one coordinate's v1 cold-tier file.

    ``coef``/``proj`` are read-only ``np.memmap`` views — opening a store
    touches only the header. ``entity_row`` binary searches the mmapped
    sorted-id table. ``verify()`` streams the whole file against the crc
    footer.
    """

    def __init__(self, path: str, *, verify: bool = False):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise ColdStoreCorruptError(path, f"bad magic {magic!r}")
            hlen = int.from_bytes(f.read(4), "little")
            if hlen <= 0 or hlen > 1 << 20:
                raise ColdStoreCorruptError(path, f"bad header length {hlen}")
            try:
                h = json.loads(f.read(hlen))
            except (ValueError, UnicodeDecodeError) as e:
                raise ColdStoreCorruptError(path, f"unparseable header: {e}")
        schema = h.get("schema")
        if schema in LATER_SCHEMAS:
            raise ColdStoreSchemaUnsupported(path, schema)
        if schema != SCHEMA:
            raise ColdStoreCorruptError(path, f"schema {schema!r}")
        self.coordinate_id: str = h["coordinate_id"]
        self.random_effect_type: str = h["random_effect_type"]
        self.feature_shard_id: str = h["feature_shard_id"]
        self.num_entities: int = h["num_entities"]
        self.slot_width: int = h["slot_width"]
        self._id_width: int = h["id_width"]
        self.file_bytes = os.path.getsize(path)
        shape = (self.num_entities, self.slot_width)
        self.coef = np.memmap(path, dtype=np.dtype(h["coef_dtype"]),
                              mode="r", offset=h["coef_off"], shape=shape)
        self.proj = np.memmap(path, dtype=np.dtype(h["proj_dtype"]),
                              mode="r", offset=h["proj_off"], shape=shape)
        if self._id_width:
            self._id_blob = np.memmap(
                path, dtype=np.uint8, mode="r", offset=h["id_blob_off"],
                shape=(self.num_entities * self._id_width,))
            self._id_offsets = None
        else:
            self._id_offsets = np.memmap(
                path, dtype=np.uint64, mode="r",
                offset=h["id_offsets_off"], shape=(self.num_entities + 1,))
            self._id_blob = np.memmap(
                path, dtype=np.uint8, mode="r", offset=h["id_blob_off"],
                shape=(h["id_blob_len"],))
        if verify:
            self.verify()

    def _id_bytes(self, row: int) -> bytes:
        if self._id_width:
            lo = row * self._id_width
            return bytes(self._id_blob[lo:lo + self._id_width])
        lo = int(self._id_offsets[row])
        hi = int(self._id_offsets[row + 1])
        return bytes(self._id_blob[lo:hi])

    def entity_id(self, row: int) -> str:
        return self._id_bytes(row).decode("utf-8")

    def entity_row(self, entity_id: str) -> Optional[int]:
        """Row index of ``entity_id`` (binary search over the sorted id
        table), or None when the entity is not in the model."""
        key = entity_id.encode("utf-8")
        if self._id_width and len(key) != self._id_width:
            return None
        lo, hi = 0, self.num_entities
        while lo < hi:
            mid = (lo + hi) // 2
            if self._id_bytes(mid) < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < self.num_entities and self._id_bytes(lo) == key:
            return lo
        return None

    def verify(self, chunk_bytes: int = 4 << 20) -> None:
        """Stream the file against its crc32 footer; raises
        ``ColdStoreCorruptError`` on mismatch or truncation."""
        size = os.path.getsize(self.path)
        if size < len(MAGIC) + 4 + 4:
            raise ColdStoreCorruptError(self.path, f"truncated ({size}B)")
        crc = 0
        remaining = size - 4
        with open(self.path, "rb") as f:
            while remaining > 0:
                chunk = f.read(min(chunk_bytes, remaining))
                if not chunk:
                    raise ColdStoreCorruptError(
                        self.path, "short read during verify")
                crc = zlib.crc32(chunk, crc)
                remaining -= len(chunk)
            footer = int.from_bytes(f.read(4), "little")
        if crc != footer:
            raise ColdStoreCorruptError(
                self.path,
                f"crc mismatch: computed {crc:#010x}, footer {footer:#010x}")
