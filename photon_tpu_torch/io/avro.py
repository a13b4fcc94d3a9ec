"""Pure-Python Avro object-container codec.

The reference's layer-0 data contract is Avro (photon-avro-schemas/
src/main/avro/*.avsc; files written/read via Spark + avro-mapred,
reference: photon-client data/avro/AvroUtils.scala:47). This build has
no JVM, so this module implements the Avro 1.x binary encoding and the
object-container file format from the specification directly: enough to
read the reference's training data and write/read models the reference
can consume byte-for-byte.

Supported: null/boolean/int/long/float/double/bytes/string, records,
enums, arrays, maps, unions, fixed; container codecs ``null`` and
``deflate``. Each file decodes under its writer schema; ``read_merged``
then resolves a cross-file reader schema (top-level field union, numeric
precedence INT < LONG < FLOAT < DOUBLE, absent -> nullable) the way the
reference's AvroDataReader.readMerged does (:246).

The port's copy of ``photon_tpu/io/avro.py``: the pure-Python codec
only. The JAX package's C block decoder (``photon_tpu/native``) is host
code and is not carried over yet, so every block decodes here.
"""

from __future__ import annotations

import io as _io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterable, Iterator, List, Optional, Tuple

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

# ---------------------------------------------------------------------------
# Schema handling: schemas are plain parsed-JSON values (dict/list/str).
# Named types may be referenced by full name after first definition.
# ---------------------------------------------------------------------------

_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}


class SchemaError(ValueError):
    pass


def _full_name(schema: dict, enclosing_ns: Optional[str]) -> str:
    name = schema["name"]
    if "." in name:
        return name
    ns = schema.get("namespace", enclosing_ns)
    return f"{ns}.{name}" if ns else name


class _Names:
    """Registry of named types seen while walking a schema."""

    def __init__(self):
        self.types: Dict[str, dict] = {}

    def register_all(self, schema: Any, enclosing_ns: Optional[str] = None) -> None:
        """Eagerly register every named type in a schema tree, so by-name
        references resolve even when the defining field's data is empty."""
        if isinstance(schema, str):
            return
        if isinstance(schema, list):
            for s in schema:
                self.register_all(s, enclosing_ns)
            return
        t = schema.get("type")
        if t in ("record", "enum", "fixed"):
            self.types[_full_name(schema, enclosing_ns)] = schema
        if t == "record":
            ns = schema.get("namespace", enclosing_ns)
            for f in schema["fields"]:
                self.register_all(f["type"], ns)
        elif t == "array":
            self.register_all(schema["items"], enclosing_ns)
        elif t == "map":
            self.register_all(schema["values"], enclosing_ns)

    def resolve(self, schema: Any, enclosing_ns: Optional[str] = None) -> Any:
        """Return the concrete schema for ``schema``, registering named types."""
        if isinstance(schema, str):
            if schema in _PRIMITIVES:
                return schema
            for cand in (schema, f"{enclosing_ns}.{schema}" if enclosing_ns else None):
                if cand and cand in self.types:
                    return self.types[cand]
            raise SchemaError(f"unknown type reference: {schema!r}")
        if isinstance(schema, list):
            return schema
        t = schema.get("type")
        if t in ("record", "enum", "fixed"):
            self.types[_full_name(schema, enclosing_ns)] = schema
        return schema


# ---------------------------------------------------------------------------
# Binary decoder
# ---------------------------------------------------------------------------


class BinaryDecoder:
    def __init__(self, buf: bytes):
        self._buf = buf
        self._pos = 0

    def eof(self) -> bool:
        return self._pos >= len(self._buf)

    def read(self, n: int) -> bytes:
        b = self._buf[self._pos:self._pos + n]
        if len(b) != n:
            raise EOFError("truncated avro data")
        self._pos += n
        return b

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self._buf[self._pos]
            self._pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    read_int = read_long

    def read_boolean(self) -> bool:
        return self.read(1) != b"\x00"

    def read_float(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def read_double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")


class BinaryEncoder:
    def __init__(self):
        self._out = _io.BytesIO()

    def getvalue(self) -> bytes:
        return self._out.getvalue()

    def write(self, b: bytes):
        self._out.write(b)

    def write_long(self, v: int):
        v = (v << 1) ^ (v >> 63) if v >= 0 else (((-v - 1) << 1) | 1)
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        self._out.write(bytes(out))

    write_int = write_long

    def write_boolean(self, v: bool):
        self._out.write(b"\x01" if v else b"\x00")

    def write_float(self, v: float):
        self._out.write(struct.pack("<f", v))

    def write_double(self, v: float):
        self._out.write(struct.pack("<d", v))

    def write_bytes(self, v: bytes):
        self.write_long(len(v))
        self._out.write(v)

    def write_string(self, v: str):
        self.write_bytes(v.encode("utf-8"))


# ---------------------------------------------------------------------------
# Datum reader / writer (schema-driven)
# ---------------------------------------------------------------------------


def _read_datum(dec: BinaryDecoder, schema: Any, names: _Names,
                ns: Optional[str] = None) -> Any:
    schema = names.resolve(schema, ns)
    if isinstance(schema, list):  # union: long index then value
        idx = dec.read_long()
        return _read_datum(dec, schema[idx], names, ns)
    if isinstance(schema, str):
        if schema == "null":
            return None
        if schema == "boolean":
            return dec.read_boolean()
        if schema in ("int", "long"):
            return dec.read_long()
        if schema == "float":
            return dec.read_float()
        if schema == "double":
            return dec.read_double()
        if schema == "bytes":
            return dec.read_bytes()
        if schema == "string":
            return dec.read_string()
        raise SchemaError(f"bad primitive {schema!r}")
    t = schema["type"]
    if t in _PRIMITIVES:
        return _read_datum(dec, t, names, ns)
    if t == "record":
        rec_ns = schema.get("namespace", ns)
        return {f["name"]: _read_datum(dec, f["type"], names, rec_ns)
                for f in schema["fields"]}
    if t == "enum":
        return schema["symbols"][dec.read_long()]
    if t == "fixed":
        return dec.read(schema["size"])
    if t == "array":
        out: List[Any] = []
        while True:
            count = dec.read_long()
            if count == 0:
                break
            if count < 0:  # block with byte size
                dec.read_long()
                count = -count
            for _ in range(count):
                out.append(_read_datum(dec, schema["items"], names, ns))
        return out
    if t == "map":
        m: Dict[str, Any] = {}
        while True:
            count = dec.read_long()
            if count == 0:
                break
            if count < 0:
                dec.read_long()
                count = -count
            for _ in range(count):
                k = dec.read_string()
                m[k] = _read_datum(dec, schema["values"], names, ns)
        return m
    raise SchemaError(f"unsupported schema {schema!r}")


def _union_branch(schema_list: list, datum: Any, names: _Names, ns) -> int:
    """Pick the union branch for a Python datum (null/record/primitive)."""
    for i, branch in enumerate(schema_list):
        b = names.resolve(branch, ns)
        bt = b if isinstance(b, str) else b.get("type")
        if datum is None and bt == "null":
            return i
        if datum is not None and bt != "null":
            if isinstance(datum, bool) and bt == "boolean":
                return i
            if isinstance(datum, int) and not isinstance(datum, bool) \
                    and bt in ("int", "long"):
                return i
            # ints promote to float/double (Avro numeric promotion) when no
            # integral branch exists
            if isinstance(datum, (int, float)) and not isinstance(datum, bool) \
                    and bt in ("float", "double"):
                return i
            if isinstance(datum, str) and bt in ("string", "enum"):
                return i
            if isinstance(datum, bytes) and bt in ("bytes", "fixed"):
                return i
            if isinstance(datum, dict) and bt in ("record", "map"):
                return i
            if isinstance(datum, (list, tuple)) and bt == "array":
                return i
    raise SchemaError(f"no union branch for {type(datum)} in {schema_list}")


def _write_datum(enc: BinaryEncoder, schema: Any, datum: Any, names: _Names,
                 ns: Optional[str] = None):
    schema = names.resolve(schema, ns)
    if isinstance(schema, list):
        idx = _union_branch(schema, datum, names, ns)
        enc.write_long(idx)
        _write_datum(enc, schema[idx], datum, names, ns)
        return
    if isinstance(schema, str):
        if schema == "null":
            return
        if schema == "boolean":
            enc.write_boolean(bool(datum))
        elif schema in ("int", "long"):
            enc.write_long(int(datum))
        elif schema == "float":
            enc.write_float(float(datum))
        elif schema == "double":
            enc.write_double(float(datum))
        elif schema == "bytes":
            enc.write_bytes(datum)
        elif schema == "string":
            enc.write_string(datum)
        else:
            raise SchemaError(f"bad primitive {schema!r}")
        return
    t = schema["type"]
    if t in _PRIMITIVES:
        _write_datum(enc, t, datum, names, ns)
        return
    if t == "record":
        rec_ns = schema.get("namespace", ns)
        for f in schema["fields"]:
            name = f["name"]
            if name in datum:
                val = datum[name]
            elif "default" in f:
                val = f["default"]
            else:
                raise SchemaError(f"missing field {name} for {schema['name']}")
            _write_datum(enc, f["type"], val, names, rec_ns)
        return
    if t == "enum":
        enc.write_long(schema["symbols"].index(datum))
        return
    if t == "fixed":
        enc.write(datum)
        return
    if t == "array":
        if datum:
            enc.write_long(len(datum))
            for item in datum:
                _write_datum(enc, schema["items"], item, names, ns)
        enc.write_long(0)
        return
    if t == "map":
        if datum:
            enc.write_long(len(datum))
            for k, v in datum.items():
                enc.write_string(k)
                _write_datum(enc, schema["values"], v, names, ns)
        enc.write_long(0)
        return
    raise SchemaError(f"unsupported schema {schema!r}")


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------


class AvroFileReader:
    """Iterate records of one Avro object-container file."""

    def __init__(self, fileobj: BinaryIO):
        self._f = fileobj
        header = fileobj.read(4)
        if header != MAGIC:
            raise SchemaError(f"not an avro container file (magic={header!r})")
        meta_dec = BinaryDecoder(fileobj.read())  # rest of file
        self._meta = _read_datum(meta_dec, {"type": "map", "values": "bytes"},
                                 _Names())
        self._sync = meta_dec.read(SYNC_SIZE)
        self._body = meta_dec  # positioned at first block
        self.schema = json.loads(self._meta[b"avro.schema"]
                                 if b"avro.schema" in self._meta
                                 else self._meta["avro.schema"])
        codec = self._meta.get(b"avro.codec", self._meta.get("avro.codec", b"null"))
        self.codec = codec.decode() if isinstance(codec, bytes) else codec
        self._names = _Names()
        self._names.register_all(self.schema)

    def __iter__(self) -> Iterator[Any]:
        dec = self._body
        while not dec.eof():
            count = dec.read_long()
            nbytes = dec.read_long()
            raw = dec.read(nbytes)
            if self.codec == "deflate":
                raw = zlib.decompress(raw, -15)
            elif self.codec != "null":
                raise SchemaError(f"unsupported codec {self.codec}")
            block = BinaryDecoder(raw)
            for _ in range(count):
                yield _read_datum(block, self.schema, self._names)
            sync = dec.read(SYNC_SIZE)
            if sync != self._sync:
                raise SchemaError("sync marker mismatch")


def read_avro(path: str) -> Tuple[Any, List[Any]]:
    """Read one container file -> (writer schema, list of records).

    The bytes are fetched through the retrying reader (resilience/retry.py)
    in one shot — a transient storage error costs a backoff, never the
    run — and decoded from memory."""
    from photon_tpu_torch.resilience import io as rio

    r = AvroFileReader(_io.BytesIO(rio.read_bytes(path, op="avro_read")))
    return r.schema, list(r)


def list_avro_files(path: str) -> List[str]:
    """``*.avro`` files under a directory (or the file itself), name
    order — the reference reads part-files the same way (AvroUtils:47)."""
    if os.path.isfile(path):
        return [path]
    return sorted(
        os.path.join(path, n) for n in os.listdir(path)
        if n.endswith(".avro") and not n.startswith("."))


def iter_avro_dir(path: str) -> Iterator[Any]:
    """Iterate records across all ``*.avro`` files in a directory (or a
    single file) in name order."""
    from photon_tpu_torch.resilience import io as rio

    for fp in list_avro_files(path):
        yield from AvroFileReader(
            _io.BytesIO(rio.read_bytes(fp, op="avro_read")))


# -- cross-file reader-schema resolution -------------------------------------

_NUMERIC_WIDTH = {"int": 0, "long": 1, "float": 2, "double": 3}


def _field_core_type(t) -> Tuple[Any, bool]:
    """(non-null branch, nullable) of a field type; a multi-branch union
    stays as-is."""
    if isinstance(t, list):
        non_null = [x for x in t if x != "null"]
        return (non_null[0] if len(non_null) == 1 else non_null,
                "null" in t)
    return t, False


def _merge_field_types(a, b, name: str):
    """Widest numeric type wins (INT < LONG < FLOAT < DOUBLE); identical
    types pass through; anything else is a schema conflict (reference:
    AvroDataReader.checkAndConvertTypes / numeric precedence :246)."""
    if a == b:
        return a
    if isinstance(a, str) and isinstance(b, str) \
            and a in _NUMERIC_WIDTH and b in _NUMERIC_WIDTH:
        return a if _NUMERIC_WIDTH[a] >= _NUMERIC_WIDTH[b] else b
    raise ValueError(
        f"incompatible Avro schemas across files for field {name!r}: "
        f"{a!r} vs {b!r}")


def merge_schemas(schemas: List[Any]) -> Any:
    """Reader-schema resolution across container files: the union of all
    top-level fields, numeric types widened by precedence, a field
    nullable when any writer declares it nullable OR omits it entirely
    (reference: AvroDataReader.readMerged field merge :246)."""
    merged: Dict[str, list] = {}     # name -> [type, nullable, seen_count]
    order: List[str] = []
    for s in schemas:
        for f in s["fields"]:
            t, nullable = _field_core_type(f["type"])
            slot = merged.get(f["name"])
            if slot is None:
                merged[f["name"]] = [t, nullable, 1]
                order.append(f["name"])
            else:
                slot[0] = _merge_field_types(slot[0], t, f["name"])
                slot[1] = slot[1] or nullable
                slot[2] += 1
    fields = []
    for name in order:
        t, nullable, seen = merged[name]
        if nullable or seen < len(schemas):
            t = ["null", t] if not isinstance(t, list) else ["null"] + t
        fields.append({"name": name, "type": t})
    base = schemas[0]
    return {"type": "record", "name": base.get("name", "Merged"),
            "namespace": base.get("namespace", ""), "fields": fields}


def read_merged(paths: List[str]) -> Tuple[Any, List[Any]]:
    """Read many files/directories under ONE resolved reader schema:
    records gain None for fields their writer omitted, and integer values
    of numerically-widened fields are coerced to the merged float type
    (the reference's readMerged contract)."""
    per_file: List[Tuple[Any, List[Any]]] = []
    for p in paths:
        for fp in list_avro_files(p):
            per_file.append(read_avro(fp))
    if not per_file:
        return None, []
    schemas = [s for s, _ in per_file]
    first = json.dumps(schemas[0], sort_keys=True)
    if all(json.dumps(s, sort_keys=True) == first for s in schemas[1:]):
        return schemas[0], [r for _, recs in per_file for r in recs]

    merged = merge_schemas(schemas)
    float_fields = set()
    all_names = []
    for f in merged["fields"]:
        t, _ = _field_core_type(f["type"])
        all_names.append(f["name"])
        if t in ("float", "double"):
            float_fields.add(f["name"])
    out: List[Any] = []
    for schema, recs in per_file:
        local = {f["name"] for f in schema["fields"]}
        missing = [n for n in all_names if n not in local]
        coerce = [n for n in float_fields if n in local]
        for r in recs:
            for n in missing:
                r[n] = None
            for n in coerce:
                v = r[n]
                if isinstance(v, int) and not isinstance(v, bool):
                    r[n] = float(v)
            out.append(r)
    return merged, out


def write_avro(path: str, schema: Any, records: Iterable[Any],
               codec: str = "deflate", sync_interval: int = 4000) -> None:
    """Write records to one Avro object-container file.

    The container is encoded into memory once, then published with the
    retrying atomic writer (fsync + tmp-rename). Encoding first matters
    beyond atomicity: callers pass ``records`` as generators, which can
    only be consumed once — a retry loop around a streaming write would
    silently produce an empty file on the second attempt."""
    names = _Names()
    names.register_all(schema)
    sync = os.urandom(SYNC_SIZE)
    with _io.BytesIO() as f:
        f.write(MAGIC)
        meta_enc = BinaryEncoder()
        meta = {"avro.schema": json.dumps(schema).encode(),
                "avro.codec": codec.encode()}
        _write_datum(meta_enc, {"type": "map", "values": "bytes"}, meta, names)
        f.write(meta_enc.getvalue())
        f.write(sync)

        buf = BinaryEncoder()
        count = 0

        def flush():
            nonlocal buf, count
            if count == 0:
                return
            raw = buf.getvalue()
            if codec == "deflate":
                comp = zlib.compressobj(6, zlib.DEFLATED, -15)
                raw = comp.compress(raw) + comp.flush()
            head = BinaryEncoder()
            head.write_long(count)
            head.write_long(len(raw))
            f.write(head.getvalue())
            f.write(raw)
            f.write(sync)
            buf = BinaryEncoder()
            count = 0

        for rec in records:
            _write_datum(buf, schema, rec, names)
            count += 1
            if count >= sync_interval:
                flush()
        flush()
        payload = f.getvalue()

    from photon_tpu_torch.resilience import io as rio

    rio.atomic_write_bytes(path, payload, op="avro_write")
