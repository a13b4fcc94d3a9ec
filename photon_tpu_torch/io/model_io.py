"""GAME model persistence in the reference's on-disk layout, and the
serving-shaped model loader.

The port of ``photon_tpu/io/model_io.py`` (save, metadata, feature-index
sidecars, ``load_for_serving``). Reference: photon-client
data/avro/ModelProcessingUtils.scala (saveGameModelToHDFS :40 — layout
``<out>/fixed-effect/<coord>/coefficients/part-*.avro`` + ``id-info``,
``random-effect/<coord>/...``, ``model-metadata.json`` :314-372),
data/avro/AvroUtils.scala:344 (GLM <-> BayesianLinearModelAvro with
sparsity threshold).

A model dir written here reads back in the JAX package and vice versa:
the same Avro records, directory layout, metadata JSON, feature-index
sidecars and v1 cold-store files. ``serving_model_from_arrays`` carries
an already-loaded model's arrays across without touching disk.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from photon_tpu_torch.game.dataset import EntityVocabulary
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel)
from photon_tpu_torch.io import avro as avro_io
from photon_tpu_torch.io.cold_store import (ColdStore, cold_store_path,
                                            write_cold_store)
from photon_tpu_torch.io.index_map import (IndexMap, IndexMapBuilder,
                                           feature_key, split_feature_key)
from photon_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_AVRO
from photon_tpu_torch.resilience import io as rio
from photon_tpu_torch.types import TaskType

FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
COEFFICIENTS = "coefficients"
ID_INFO = "id-info"
METADATA_FILE = "model-metadata.json"
#: per-shard serving column space sidecar, written alongside cold-store
#: files: without it a lazy (avro-skipping) load could not reproduce the
#: column numbering the cold store's projection table was written in
FEATURE_INDEX_DIR = "feature-index"
FEATURE_INDEX_SCHEMA = "photon_tpu.featureindex.v1"

# Reference: VectorUtils.DEFAULT_SPARSITY_THRESHOLD
DEFAULT_SPARSITY_THRESHOLD = 1e-4

# modelClass strings the reference writes (AvroUtils.scala:359) and
# dispatches on at load (:405) — kept verbatim for interchange.
_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}


def _host(x) -> np.ndarray:
    """A torch tensor (any device) or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# vector <-> NameTermValue record lists
# ---------------------------------------------------------------------------


def _vector_to_ntvs(vec: np.ndarray, index_map: IndexMap,
                    indices: Optional[np.ndarray] = None,
                    sparsity_threshold: float = DEFAULT_SPARSITY_THRESHOLD,
                    ) -> List[dict]:
    """Nonzero (name, term, value) records for a coefficient vector.
    ``indices``: optional global column per vector slot (projected models);
    None = slot i IS global column i."""
    out = []
    for slot, v in enumerate(vec):
        v = float(v)
        if abs(v) <= sparsity_threshold:
            continue
        g = int(indices[slot]) if indices is not None else slot
        if g < 0:
            continue
        key = index_map.get_feature_name(g)
        if key is None:
            raise KeyError(f"no feature name for column {g}")
        name, term = split_feature_key(key)
        out.append({"name": name, "term": term, "value": v})
    return out


# ---------------------------------------------------------------------------
# metadata JSON (reference: ModelProcessingUtils.gameOptConfigToJson :314)
# ---------------------------------------------------------------------------


def save_model_metadata(output_dir: str, task: TaskType,
                        model_name: str = "photon_tpu GAME model") -> None:
    """The reference's metadata JSON. The per-coordinate optimization
    configurations arrive with the training slice; until then both
    configuration lists are empty, as the JAX package writes them for a
    model saved without ``coordinate_configs``."""
    meta = {
        "modelType": task.value,
        "modelName": model_name,
        "fixedEffectOptimizationConfigurations": {
            "configurations": FIXED_EFFECT, "values": []},
        "randomEffectOptimizationConfigurations": {
            "configurations": RANDOM_EFFECT, "values": []},
    }
    rio.atomic_write_bytes(os.path.join(output_dir, METADATA_FILE),
                           json.dumps(meta, indent=2).encode("utf-8"),
                           op="model_write")


def load_model_metadata(model_dir: str) -> dict:
    with open(os.path.join(model_dir, METADATA_FILE)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def save_feature_index(output_dir: str, shard_id: str,
                       index_map: IndexMap) -> str:
    """Persist one shard's column space (feature key per column) so lazy
    loads can reproduce it without replaying every Avro record."""
    fdir = os.path.join(output_dir, FEATURE_INDEX_DIR)
    os.makedirs(fdir, exist_ok=True)
    keys = [index_map.get_feature_name(i)
            for i in range(index_map.feature_dimension)]
    path = os.path.join(fdir, shard_id + ".json")
    doc = {"schema": FEATURE_INDEX_SCHEMA, "feature_shard_id": shard_id,
           "features": keys}
    rio.atomic_write_bytes(path, json.dumps(doc).encode("utf-8"),
                           op="model_write")
    return path


def load_feature_indexes(model_dir: str) -> Dict[str, IndexMap]:
    """Read every feature-index sidecar in ``model_dir``; {} when the
    model predates them (pure Avro layout)."""
    fdir = os.path.join(model_dir, FEATURE_INDEX_DIR)
    out: Dict[str, IndexMap] = {}
    if not os.path.isdir(fdir):
        return out
    for name in sorted(os.listdir(fdir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(fdir, name)) as f:
            doc = json.load(f)
        if doc.get("schema") != FEATURE_INDEX_SCHEMA:
            raise ValueError(f"unknown feature-index schema "
                             f"{doc.get('schema')!r} in {name}")
        out[doc["feature_shard_id"]] = IndexMap(
            {k: i for i, k in enumerate(doc["features"]) if k is not None})
    return out


def save_game_model(
    output_dir: str,
    model: GameModel,
    index_maps: Dict[str, IndexMap],
    vocab: Optional[EntityVocabulary] = None,
    projections: Optional[Dict[str, np.ndarray]] = None,
    sparsity_threshold: float = DEFAULT_SPARSITY_THRESHOLD,
    records_per_file: Optional[int] = None,
    write_cold_stores: bool = True,
) -> None:
    """Write a GAME model in the reference layout.

    ``index_maps``: feature shard id -> IndexMap (global columns).
    ``vocab`` + ``projections``: required when the model has random
    effects (entity row -> REId string; local slot -> global column).
    ``records_per_file``: max per-entity records per part file (the
    reference's randomEffectModelFileLimit).
    ``write_cold_stores``: also write each random-effect coordinate's
    v1 cold-tier file plus the per-shard feature-index sidecars — the
    pair ``load_for_serving`` reads instead of the per-entity records.
    Random-effect variances go to the Avro records only; the cold-store
    variance column (v3) is not written by this package yet, so a model
    with random-effect variances needs ``write_cold_stores=False``.
    """
    os.makedirs(output_dir, exist_ok=True)
    save_model_metadata(output_dir, model.task)
    has_random = any(isinstance(model[cid], RandomEffectModel)
                     for cid in model.coordinate_ids)
    if write_cold_stores and has_random:
        for sid, imap in index_maps.items():
            save_feature_index(output_dir, sid, imap)

    for cid in model.coordinate_ids:
        m = model[cid]
        if isinstance(m, FixedEffectModel):
            cdir = os.path.join(output_dir, FIXED_EFFECT, cid)
            os.makedirs(os.path.join(cdir, COEFFICIENTS), exist_ok=True)
            rio.atomic_write_bytes(os.path.join(cdir, ID_INFO),
                                   (m.feature_shard_id + "\n").encode("utf-8"),
                                   op="model_write")
            imap = index_maps[m.feature_shard_id]
            coefs = m.model.coefficients
            rec = {
                "modelId": FIXED_EFFECT,
                "modelClass": _MODEL_CLASS[m.task],
                "means": _vector_to_ntvs(
                    _host(coefs.means), imap,
                    sparsity_threshold=sparsity_threshold),
                "variances": None if coefs.variances is None else
                    _vector_to_ntvs(_host(coefs.variances), imap,
                                    sparsity_threshold=0.0),
                "lossFunction": "",
            }
            avro_io.write_avro(
                os.path.join(cdir, COEFFICIENTS, "part-00000.avro"),
                BAYESIAN_LINEAR_MODEL_AVRO, [rec])
        elif isinstance(m, RandomEffectModel):
            if vocab is None or projections is None or cid not in projections:
                raise ValueError(
                    f"random-effect coordinate {cid} needs vocab + projection")
            var = None if m.variances is None else _host(m.variances)
            if write_cold_stores and var is not None:
                raise ValueError(
                    f"random-effect coordinate {cid} carries variances: the "
                    f"cold-store variance column is not supported here; "
                    f"save with write_cold_stores=False")
            cdir = os.path.join(output_dir, RANDOM_EFFECT, cid)
            os.makedirs(os.path.join(cdir, COEFFICIENTS), exist_ok=True)
            rio.atomic_write_bytes(
                os.path.join(cdir, ID_INFO),
                (m.random_effect_type + "\n"
                 + m.feature_shard_id + "\n").encode("utf-8"),
                op="model_write")
            imap = index_maps[m.feature_shard_id]
            names = vocab.names(m.random_effect_type)
            proj = np.asarray(projections[cid])
            coef = _host(m.coefficients)

            recs = [{
                "modelId": re_id,
                "modelClass": _MODEL_CLASS[m.task],
                "means": _vector_to_ntvs(
                    coef[e], imap, indices=proj[e],
                    sparsity_threshold=sparsity_threshold),
                "variances": None if var is None else
                    _vector_to_ntvs(var[e], imap, indices=proj[e],
                                    sparsity_threshold=0.0),
                "lossFunction": "",
            } for e, re_id in enumerate(names)]
            per_file = records_per_file or max(len(recs), 1)
            nfiles = max((len(recs) + per_file - 1) // per_file, 1)
            for p in range(nfiles):
                avro_io.write_avro(
                    os.path.join(cdir, COEFFICIENTS, f"part-{p:05d}.avro"),
                    BAYESIAN_LINEAR_MODEL_AVRO,
                    recs[p * per_file:(p + 1) * per_file])
            if write_cold_stores:
                write_cold_store(
                    cold_store_path(output_dir, cid), cid,
                    m.random_effect_type, m.feature_shard_id,
                    coef, proj.astype(np.int32, copy=False),
                    np.asarray(list(names)))
        else:
            raise TypeError(f"unknown model type for coordinate {cid}: {type(m)}")


# ---------------------------------------------------------------------------
# serving-shaped model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingFixedEffect:
    """One fixed-effect coordinate as a flat coefficient vector (plus the
    optional posterior-variance vector a Bayesian save carries)."""

    coordinate_id: str
    feature_shard_id: str
    coefficients: np.ndarray          # [D_shard] in the serving index space
    variances: Optional[np.ndarray] = None   # [D_shard] or None (mean-only)


class ServingRandomEffect:
    """One random-effect coordinate as a gather table + entity lookup.

    Eager — ``coefficients`` [E, K] float32, ``projection`` [E, K] int32
    (-1 pad), ``entity_rows`` {REId -> row} passed at construction — or
    cold-backed: only ``cold_store_path`` is set and the dense arrays
    materialize from the mmap-backed v1 cold store on FIRST attribute
    access.
    """

    def __init__(self, coordinate_id: str, random_effect_type: str,
                 feature_shard_id: str,
                 coefficients: Optional[np.ndarray] = None,
                 projection: Optional[np.ndarray] = None,
                 entity_rows: Optional[Dict[str, int]] = None,
                 cold_store_path: Optional[str] = None,
                 variances: Optional[np.ndarray] = None):
        if coefficients is None and cold_store_path is None:
            raise ValueError(
                f"random effect {coordinate_id!r} needs either eager "
                f"arrays or a cold_store_path")
        self.coordinate_id = coordinate_id
        self.random_effect_type = random_effect_type
        self.feature_shard_id = feature_shard_id
        self.cold_store_path = cold_store_path
        self._coefficients = coefficients
        self._projection = projection
        self._entity_rows = entity_rows
        self.variances = variances

    def _materialize(self) -> None:
        cs = ColdStore(self.cold_store_path)
        self._coefficients = np.asarray(cs.coef, dtype=np.float32)
        self._projection = np.asarray(cs.proj, dtype=np.int32)
        self._entity_rows = {cs.entity_id(r): r
                             for r in range(cs.num_entities)}

    @property
    def coefficients(self) -> np.ndarray:
        if self._coefficients is None:
            self._materialize()
        return self._coefficients

    @property
    def projection(self) -> np.ndarray:
        if self._projection is None:
            self._materialize()
        return self._projection

    @property
    def entity_rows(self) -> Dict[str, int]:
        if self._entity_rows is None:
            self._materialize()
        return self._entity_rows

    @property
    def num_entities(self) -> int:
        return int(self.coefficients.shape[0])


@dataclasses.dataclass
class ServingGameModel:
    """Serving-shaped GAME model: flat arrays + lookup dicts only — exactly
    what the online scorer consumes."""

    task: TaskType
    fixed: List[ServingFixedEffect]
    random: List[ServingRandomEffect]
    index_maps: Dict[str, IndexMap]   # serving column space, per shard
    metadata: dict

    @property
    def shard_dims(self) -> Dict[str, int]:
        return {sid: m.feature_dimension for sid, m in self.index_maps.items()}


def load_for_serving(
    model_dir: str,
    index_maps: Optional[Dict[str, IndexMap]] = None,
    coordinates_to_load: Optional[Sequence[str]] = None,
    dtype=np.float32,
) -> ServingGameModel:
    """Load a GAME model for online scoring: one pass over every record.

    Without ``index_maps`` the serving column space is built from the
    model's own support (a feature the model never weights scores zero
    either way) — unless the model dir carries feature-index sidecars, in
    which case those fix the column space up front (the numbering the
    cold-store projection tables were written in).

    Random-effect coordinates with a cold-store file are opened LAZILY:
    their per-entity Avro records are never read. Only v1 cold stores
    are read; later layouts raise ``ColdStoreSchemaUnsupported`` when the
    table is first materialized.
    """
    metadata = load_model_metadata(model_dir)
    task = TaskType(metadata["modelType"])
    wanted = set(coordinates_to_load) if coordinates_to_load else None
    external = index_maps is not None
    sidecars = {} if external else load_feature_indexes(model_dir)
    builders: Dict[str, IndexMapBuilder] = {}

    def col_of(shard_id: str, name: str, term: str) -> int:
        if external:
            return index_maps[shard_id].index_of(name, term)
        if shard_id in sidecars:
            return sidecars[shard_id].index_of(name, term)
        return builders.setdefault(shard_id, IndexMapBuilder()).put(
            feature_key(name, term))

    def slots_of(shard_id: str, ntvs) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for r in ntvs:
            g = col_of(shard_id, str(r["name"]), str(r["term"]))
            if g >= 0:
                out[g] = float(r["value"])
        return out

    # pass 1 (and only): records -> {global column: value} slot dicts;
    # dense packing waits until every coordinate has grown the builders
    fixed_raw: List[Tuple[str, str, Dict[int, float],
                          Optional[Dict[int, float]]]] = []
    random_raw: List[Tuple[str, str, str, List[str], List[Dict[int, float]],
                           Optional[List[Dict[int, float]]]]] = []
    cold_raw: List[Tuple[str, str, str, str]] = []  # cid, type, shard, path

    fixed_dir = os.path.join(model_dir, FIXED_EFFECT)
    if os.path.isdir(fixed_dir):
        for cid in sorted(os.listdir(fixed_dir)):
            if wanted is not None and cid not in wanted:
                continue
            cdir = os.path.join(fixed_dir, cid)
            with open(os.path.join(cdir, ID_INFO)) as f:
                shard_id = f.read().split()[0]
            if external and shard_id not in index_maps:
                raise KeyError(f"no index map for feature shard {shard_id!r}")
            recs = list(avro_io.iter_avro_dir(os.path.join(cdir, COEFFICIENTS)))
            if len(recs) != 1:
                raise ValueError(
                    f"expected 1 fixed-effect record, got {len(recs)}")
            slots = slots_of(shard_id, recs[0]["means"])
            var_recs = recs[0].get("variances")
            var_slots = (None if var_recs is None
                         else slots_of(shard_id, var_recs))
            fixed_raw.append((cid, shard_id, slots, var_slots))

    random_dir = os.path.join(model_dir, RANDOM_EFFECT)
    if os.path.isdir(random_dir):
        for cid in sorted(os.listdir(random_dir)):
            if wanted is not None and cid not in wanted:
                continue
            cdir = os.path.join(random_dir, cid)
            with open(os.path.join(cdir, ID_INFO)) as f:
                re_type, shard_id = f.read().split()[:2]
            if external and shard_id not in index_maps:
                raise KeyError(f"no index map for feature shard {shard_id!r}")
            cold_path = cold_store_path(model_dir, cid)
            if not external and os.path.exists(cold_path):
                # lazy: the cold file IS the coefficient table (its
                # projection columns are the sidecar column space), so
                # the per-entity Avro records never get read
                cold_raw.append((cid, re_type, shard_id, cold_path))
                continue
            names: List[str] = []
            per_entity: List[Dict[int, float]] = []
            per_entity_var: List[Dict[int, float]] = []
            have_var = False
            for rec in avro_io.iter_avro_dir(os.path.join(cdir, COEFFICIENTS)):
                var_recs = rec.get("variances") or ()
                have_var = have_var or bool(var_recs)
                names.append(str(rec["modelId"]))
                per_entity.append(slots_of(shard_id, rec["means"]))
                per_entity_var.append(slots_of(shard_id, var_recs))
            random_raw.append((cid, re_type, shard_id, names, per_entity,
                               per_entity_var if have_var else None))

    maps = dict(index_maps) if external else {
        **{sid: b.build() for sid, b in builders.items()},
        **sidecars}

    def dense(slots: Dict[int, float], dim: int) -> np.ndarray:
        vec = np.zeros(max(dim, 1), dtype)
        for g, v in slots.items():
            vec[g] = v
        return vec

    fixed = []
    for cid, shard_id, slots, var_slots in fixed_raw:
        dim = maps[shard_id].feature_dimension if shard_id in maps else 0
        fixed.append(ServingFixedEffect(
            cid, shard_id, dense(slots, dim),
            None if var_slots is None else dense(var_slots, dim)))

    random_ = []
    for cid, re_type, shard_id, names, per_entity, per_entity_var \
            in random_raw:
        E = len(per_entity)
        # slot space per entity = union of the means + variances supports
        unions = [sorted(set(s) | set(per_entity_var[e]
                                      if per_entity_var else ()))
                  for e, s in enumerate(per_entity)]
        K = max((len(u) for u in unions), default=1) or 1
        coef = np.zeros((E, K), dtype)
        proj = np.full((E, K), -1, np.int32)
        var = None if per_entity_var is None else np.zeros((E, K), dtype)
        for e, cols in enumerate(unions):
            for s, g in enumerate(cols):
                proj[e, s] = g
                coef[e, s] = per_entity[e].get(g, 0.0)
                if var is not None:
                    var[e, s] = per_entity_var[e].get(g, 0.0)
        random_.append(ServingRandomEffect(
            cid, re_type, shard_id, coef, proj,
            {name: i for i, name in enumerate(names)}, variances=var))
    for cid, re_type, shard_id, cold_path in cold_raw:
        random_.append(ServingRandomEffect(
            cid, re_type, shard_id, cold_store_path=cold_path))
    random_.sort(key=lambda r: r.coordinate_id)

    return ServingGameModel(task, fixed, random_, maps, metadata)


def serving_model_from_arrays(
    task: Union[TaskType, str],
    fixed: Sequence[Tuple[str, str, np.ndarray]],
    random: Sequence[Tuple[str, str, str, np.ndarray, np.ndarray,
                           Union[Mapping[str, int], Sequence[str]]]],
    index_maps: Mapping[str, Sequence[Optional[Tuple[str, str]]]],
    metadata: Optional[dict] = None,
) -> ServingGameModel:
    """Build the port's :class:`ServingGameModel` from plain arrays — the
    way weights cross from a JAX ``ServingGameModel`` (or any other
    source) without a trip through disk.

    ``fixed``: ``(coordinate_id, feature_shard_id, theta [D])`` per fixed
    coordinate. ``random``: ``(coordinate_id, random_effect_type,
    feature_shard_id, coefficients [E, K], projection [E, K] (-1 pad),
    entity rows)`` per random coordinate, where entity rows is a
    ``{REId: row}`` map or the REIds in row order. ``index_maps``: per
    shard, the ``(name, term)`` of each column in column order (None for
    a column with no name).
    """
    maps = {
        sid: IndexMap({feature_key(*nt): col for col, nt in enumerate(cols)
                       if nt is not None})
        for sid, cols in index_maps.items()}
    fixed_ = [ServingFixedEffect(cid, sid, np.asarray(theta, np.float32))
              for cid, sid, theta in fixed]
    random_ = []
    for cid, re_type, sid, coef, proj, rows in random:
        if not isinstance(rows, Mapping):
            rows = {str(name): i for i, name in enumerate(rows)}
        random_.append(ServingRandomEffect(
            cid, re_type, sid, np.asarray(coef, np.float32),
            np.asarray(proj, np.int32), dict(rows)))
    random_.sort(key=lambda r: r.coordinate_id)
    return ServingGameModel(TaskType(task), fixed_, random_, maps,
                            dict(metadata or {}))
