"""Model dirs cross between the JAX package and the port, both ways.

One seeded GAME model (two fixed-effect coordinates on two feature
shards, two random-effect coordinates) is saved by the JAX package's
``save_game_model`` and by the port's. Each package's
``load_for_serving`` reads the other's dir and must return the same
arrays and index maps as the writer's own loader. The files themselves
are compared too: Avro containers differ only in their random 16-byte
sync marker, and the v1 cold-store writer is deterministic, so those
files are byte-identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.game.dataset import EntityVocabulary as JEntityVocabulary
from photon_tpu.game.model import FixedEffectModel as JFixed
from photon_tpu.game.model import GameModel as JGameModel
from photon_tpu.game.model import RandomEffectModel as JRandom
from photon_tpu.io import model_io as jmio
from photon_tpu.io.index_map import IndexMap as JIndexMap
from photon_tpu.models.glm import Coefficients as JCoefficients
from photon_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_tpu.types import TaskType as JTaskType
from photon_tpu_torch.game.dataset import EntityVocabulary
from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                         RandomEffectModel)
from photon_tpu_torch.io import avro, cold_store
from photon_tpu_torch.io import model_io as pmio
from photon_tpu_torch.io.index_map import IndexMap, feature_key
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.types import TaskType

SHARDS = {"g": 12, "i": 7}
FIXED = {"fixed_g": "g", "fixed_i": "i"}
RANDOM = {"per_user": ("userId", "g", 9, 4), "per_item": ("itemId", "i", 5, 3)}


def _arrays(seed=3):
    rng = np.random.default_rng(seed)
    # zero-padded terms: IndexMap.from_keys sorts keys, so column j is
    # keys[sid][j]
    keys = {sid: [(f"{sid}f", f"{j:02d}") for j in range(d)]
            for sid, d in SHARDS.items()}
    thetas = {cid: rng.normal(size=SHARDS[sid]) for cid, sid in FIXED.items()}
    rand = {}
    for cid, (re_type, sid, E, K) in RANDOM.items():
        proj = np.stack([np.sort(rng.choice(SHARDS[sid], K, replace=False))
                         for _ in range(E)]).astype(np.int32)
        # one entity with a pad slot, to exercise -1 projections
        proj[1, -1] = -1
        coef = rng.normal(size=(E, K))
        coef[1, -1] = 0.0
        ids = [f"{re_type}-{e:02d}" for e in range(E)]
        rand[cid] = (re_type, sid, coef, proj, ids)
    return keys, thetas, rand


def _save_jax(d, write_cold_stores=True):
    keys, thetas, rand = _arrays()
    imaps = {sid: JIndexMap.from_keys(feature_key(n, t) for n, t in ks)
             for sid, ks in keys.items()}
    task = JTaskType.LOGISTIC_REGRESSION
    models = {cid: JFixed(JGLM(JCoefficients(jnp.asarray(thetas[cid])), task),
                          sid) for cid, sid in FIXED.items()}
    vocab = JEntityVocabulary()
    projs = {}
    for cid, (re_type, sid, coef, proj, ids) in rand.items():
        models[cid] = JRandom(jnp.asarray(coef), re_type, sid, task)
        vocab.build(re_type, ids)
        projs[cid] = proj
    jmio.save_game_model(d, JGameModel(models), imaps, vocab, projs,
                         sparsity_threshold=0.0,
                         write_cold_stores=write_cold_stores)


def _save_port(d, write_cold_stores=True):
    keys, thetas, rand = _arrays()
    imaps = {sid: IndexMap.from_keys(feature_key(n, t) for n, t in ks)
             for sid, ks in keys.items()}
    task = TaskType.LOGISTIC_REGRESSION
    models = {cid: FixedEffectModel(GeneralizedLinearModel(
        Coefficients(torch.from_numpy(thetas[cid])), task), sid)
        for cid, sid in FIXED.items()}
    vocab = EntityVocabulary()
    projs = {}
    for cid, (re_type, sid, coef, proj, ids) in rand.items():
        models[cid] = RandomEffectModel(torch.from_numpy(coef), re_type, sid,
                                        task)
        vocab.build(re_type, ids)
        projs[cid] = proj
    pmio.save_game_model(d, GameModel(models), imaps, vocab, projs,
                         sparsity_threshold=0.0,
                         write_cold_stores=write_cold_stores)


def _canon(sm):
    """A ServingGameModel from either package as plain comparable data."""
    fixed = {f.coordinate_id: (f.feature_shard_id,
                               np.asarray(f.coefficients))
             for f in sm.fixed}
    rand = {r.coordinate_id: (r.random_effect_type, r.feature_shard_id,
                              np.asarray(r.coefficients),
                              np.asarray(r.projection), dict(r.entity_rows))
            for r in sm.random}
    maps = {sid: dict(m.items()) for sid, m in sm.index_maps.items()}
    return sm.task.value, fixed, rand, maps


def _assert_same(a, b):
    task_a, fixed_a, rand_a, maps_a = _canon(a)
    task_b, fixed_b, rand_b, maps_b = _canon(b)
    assert task_a == task_b
    assert maps_a == maps_b
    assert fixed_a.keys() == fixed_b.keys()
    for cid in fixed_a:
        assert fixed_a[cid][0] == fixed_b[cid][0]
        assert fixed_a[cid][1].dtype == fixed_b[cid][1].dtype
        np.testing.assert_array_equal(fixed_a[cid][1], fixed_b[cid][1])
    assert list(rand_a) == list(rand_b)
    for cid in rand_a:
        ta, tb = rand_a[cid], rand_b[cid]
        assert ta[:2] == tb[:2]
        np.testing.assert_array_equal(ta[2], tb[2])
        np.testing.assert_array_equal(ta[3], tb[3])
        assert ta[4] == tb[4]


@pytest.fixture(scope="module", params=[True, False],
                ids=["cold_store", "avro_only"])
def dirs(request, tmp_path_factory):
    base = tmp_path_factory.mktemp("xload")
    jdir, pdir = str(base / "jax"), str(base / "port")
    _save_jax(jdir, write_cold_stores=request.param)
    _save_port(pdir, write_cold_stores=request.param)
    return jdir, pdir, request.param


def test_port_reads_jax_dir(dirs):
    jdir, _, _ = dirs
    _assert_same(pmio.load_for_serving(jdir), jmio.load_for_serving(jdir))


def test_jax_reads_port_dir(dirs):
    jdir, pdir, _ = dirs
    _assert_same(jmio.load_for_serving(pdir), jmio.load_for_serving(jdir))
    _assert_same(pmio.load_for_serving(pdir), jmio.load_for_serving(jdir))


def test_loaded_arrays_are_the_saved_ones(dirs):
    """Beyond agreeing with each other, both loaders return the saved
    weights (per entity, keyed by the saved ids and columns)."""
    _, pdir, _ = dirs
    keys, thetas, rand = _arrays()
    sm = pmio.load_for_serving(pdir)
    for f in sm.fixed:
        imap = sm.index_maps[f.feature_shard_id]
        for j, (n, t) in enumerate(keys[f.feature_shard_id]):
            assert f.coefficients[imap.index_of(n, t)] == \
                np.float32(thetas[f.coordinate_id][j])
    for r in sm.random:
        _, sid, coef, proj, ids = rand[r.coordinate_id]
        for e, re_id in enumerate(ids):
            row = r.entity_rows[re_id]
            got = {int(c): float(v) for c, v in
                   zip(r.projection[row], r.coefficients[row]) if c >= 0}
            want = {int(c): float(np.float32(v))
                    for c, v in zip(proj[e], coef[e]) if c >= 0 and v != 0}
            assert {c: v for c, v in got.items() if v != 0} == want


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, d)] = p
    return out


def test_files_identical_but_avro_sync_marker(dirs):
    jdir, pdir, cold = dirs
    jf, pf = _files(jdir), _files(pdir)
    assert sorted(jf) == sorted(pf)
    assert any(k.endswith(cold_store.COLD_STORE_SUFFIX) for k in jf) == cold
    for rel in jf:
        a = open(jf[rel], "rb").read()
        b = open(pf[rel], "rb").read()
        if rel.endswith(".avro"):
            # each container ends with its sync marker; it is the only
            # random part of the file (os.urandom at write time)
            sa, sb = a[-avro.SYNC_SIZE:], b[-avro.SYNC_SIZE:]
            a = a.replace(sa, b"\0" * avro.SYNC_SIZE)
            b = b.replace(sb, b"\0" * avro.SYNC_SIZE)
        assert a == b, rel


def test_cold_store_reader_on_jax_file(tmp_path):
    d = str(tmp_path / "m")
    _save_jax(d)
    from photon_tpu.io.cold_store import ColdStore as JColdStore

    for cid in RANDOM:
        path = cold_store.cold_store_path(d, cid)
        cs = cold_store.ColdStore(path, verify=True)
        js = JColdStore(path)
        np.testing.assert_array_equal(np.asarray(cs.coef), np.asarray(js.coef))
        np.testing.assert_array_equal(np.asarray(cs.proj), np.asarray(js.proj))
        for r in range(cs.num_entities):
            re_id = cs.entity_id(r)
            assert re_id == js.entity_id(r)
            assert cs.entity_row(re_id) == js.entity_row(re_id) == r
        assert cs.entity_row("nobody") is None


def test_later_cold_store_layouts_raise_typed(tmp_path):
    """v2 (updatable) and v3 (variance column) files from the JAX writer
    are refused with a typed error, not misread."""
    from photon_tpu.io.cold_store import write_cold_store as jwrite

    rng = np.random.default_rng(0)
    coef = rng.normal(size=(4, 2)).astype(np.float32)
    proj = np.asarray([[0, 1]] * 4, np.int32)
    ids = [f"e{i}" for i in range(4)]
    v2 = jwrite(str(tmp_path / "v2"), "c", "t", "s", coef, proj, ids,
                updatable=True)
    v3 = jwrite(str(tmp_path / "v3"), "c", "t", "s", coef, proj, ids,
                variances=np.ones_like(coef))
    for path, schema in ((v2, "photon_tpu.coldstore.v2"),
                         (v3, "photon_tpu.coldstore.v3")):
        with pytest.raises(cold_store.ColdStoreSchemaUnsupported) as e:
            cold_store.ColdStore(path)
        assert e.value.schema == schema


def test_corrupt_cold_store_fails_verify(tmp_path):
    d = str(tmp_path / "m")
    _save_port(d)
    path = cold_store.cold_store_path(d, "per_user")
    raw = bytearray(open(path, "rb").read())
    raw[-12] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(cold_store.ColdStoreCorruptError):
        cold_store.ColdStore(path, verify=True)


def test_avro_roundtrip_both_directions(tmp_path):
    """Records written by one codec decode identically in the other."""
    from photon_tpu.io import avro as javro
    from photon_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    recs = [{"uid": f"u{i}", "label": float(i % 2),
             "features": [{"name": "f", "term": str(j), "value": j * 0.5}
                          for j in range(i)],
             "metadataMap": {"k": str(i)} if i % 2 else None,
             "weight": None, "offset": 0.25 * i} for i in range(5)]
    p1, p2 = str(tmp_path / "a.avro"), str(tmp_path / "b.avro")
    avro.write_avro(p1, TRAINING_EXAMPLE_AVRO, recs)
    javro.write_avro(p2, TRAINING_EXAMPLE_AVRO, recs)
    assert javro.read_avro(p1)[1] == recs
    assert avro.read_avro(p2)[1] == recs
