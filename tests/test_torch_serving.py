"""The GLMix serving slice: the JAX engine and the port's, same requests.

One model dir saved by the JAX package (two fixed-effect coordinates on
two feature shards, a per-user and a per-item random effect) is served
by ``photon_tpu.serving.ServingEngine.from_model_dir`` and by the port's
(``device="cpu"``, where the gather+margin wrapper takes its plain
version). Requests cover every bucket with remainders, unknown entities,
unknown features, feature overflow past the padded width, and a forced
SLO shed. Scores agree at atol = rtol = 1e-5 (f32 sums in other orders)
and the typed fallbacks are identical. ``serving_model_from_arrays`` of
the JAX ``ServingGameModel`` serves the same scores too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu import serving as jserving
from photon_tpu.game.dataset import EntityVocabulary as JEntityVocabulary
from photon_tpu.game.model import FixedEffectModel as JFixed
from photon_tpu.game.model import GameModel as JGameModel
from photon_tpu.game.model import RandomEffectModel as JRandom
from photon_tpu.io import model_io as jmio
from photon_tpu.io.index_map import IndexMap as JIndexMap
from photon_tpu.io.index_map import feature_key
from photon_tpu.models.glm import Coefficients as JCoefficients
from photon_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_tpu.types import TaskType as JTaskType
from photon_tpu_torch import serving as pserving
from photon_tpu_torch.io.model_io import serving_model_from_arrays
from photon_tpu_torch.ops import gather_margin as gm

TOL = dict(rtol=1e-5, atol=1e-5)
SHARDS = {"g": 20, "i": 9}
PAD = 8                    # feature_pad below some requests' width
MAX_BATCH = 8
USERS, ITEMS = 12, 5


def _build_model_dir(d):
    rng = np.random.default_rng(11)
    imaps = {sid: JIndexMap.from_keys(feature_key(sid, f"{j:02d}")
                                      for j in range(n))
             for sid, n in SHARDS.items()}
    task = JTaskType.LOGISTIC_REGRESSION
    models = {
        "fixed_g": JFixed(JGLM(JCoefficients(
            jnp.asarray(rng.normal(size=SHARDS["g"]))), task), "g"),
        "fixed_i": JFixed(JGLM(JCoefficients(
            jnp.asarray(rng.normal(size=SHARDS["i"]))), task), "i"),
    }
    vocab = JEntityVocabulary()
    projs = {}
    for cid, re_type, sid, E, K in (("per_user", "userId", "g", USERS, 4),
                                    ("per_item", "itemId", "i", ITEMS, 3)):
        projs[cid] = np.stack([np.sort(rng.choice(SHARDS[sid], K,
                                                  replace=False))
                               for _ in range(E)]).astype(np.int32)
        models[cid] = JRandom(jnp.asarray(rng.normal(size=(E, K))), re_type,
                              sid, task)
        vocab.build(re_type, [f"{re_type}{e}" for e in range(E)])
    jmio.save_game_model(d, JGameModel(models), imaps, vocab, projs,
                         sparsity_threshold=0.0)


def _requests(n, seed):
    """Mixed traffic: every 4th user and every 5th item unknown, some
    requests wider than the pad, some naming a feature no model has."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feats = {}
        for sid, d in SHARDS.items():
            width = int(rng.integers(1, min(d, PAD + 4) + 1))
            cols = rng.choice(d, size=width, replace=False)
            feats[sid] = [(sid, f"{c:02d}", float(rng.normal()))
                          for c in cols]
        if i % 7 == 3:
            feats["g"].append(("nosuch", "x", 1.0))
        ids = {"userId": (f"userId{rng.integers(0, USERS)}" if i % 4
                          else f"stranger{i}"),
               "itemId": (f"itemId{rng.integers(0, ITEMS)}" if i % 5
                          else f"newitem{i}")}
        out.append((f"r{i}", feats, ids, float(rng.normal() * 0.1)))
    return out


def _as(pkg, reqs):
    return [pkg.ScoreRequest(uid, feats, ids, off)
            for uid, feats, ids, off in reqs]


def _fallbacks(resp):
    return [(f.reason.value, f.coordinate) for f in resp.fallbacks]


def _assert_same_responses(got, want):
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert _fallbacks(g) == _fallbacks(w), g.uid
        assert g.degraded == w.degraded
        assert (g.score is None) == (w.score is None)
        if w.score is not None:
            np.testing.assert_allclose(g.score, w.score, **TOL)


def _groups(engine, reqs, sizes):
    """Submit groups of the given sizes and drain each: every bucket of
    the ladder, full and with pad rows."""
    out, pos = [], 0
    for size in sizes:
        for r in reqs[pos:pos + size]:
            assert engine.submit(r) is None
        out.extend(engine.drain())
        pos += size
    return out


SIZES = [1, 2, 3, 4, 5, 7, 8, 13, 16, 6]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serving") / "model")
    _build_model_dir(d)
    jeng = jserving.ServingEngine.from_model_dir(
        d, jserving.ServingConfig(max_batch=MAX_BATCH, feature_pad=PAD,
                                  max_wait_s=0.0))
    peng = pserving.ServingEngine.from_model_dir(
        d, pserving.ServingConfig(max_batch=MAX_BATCH, feature_pad=PAD,
                                  max_wait_s=0.0), device="cpu")
    jeng.warmup()
    winfo = peng.warmup()
    return d, jeng, peng, winfo


def test_warmup_dispatches_every_mode_and_bucket(engines):
    _, _, peng, winfo = engines
    assert winfo["buckets"] == [1, 2, 4, 8]
    assert winfo["modes"] == ["full", "fixed_only"]
    assert winfo["programs"] == 8
    assert winfo["kernel_builds"] == {"warmup": 0, "steady": 0}
    assert peng.model.device == torch.device("cpu")


def test_all_buckets_and_remainders_match_jax(engines):
    _, jeng, peng, _ = engines
    reqs = _requests(sum(SIZES), seed=1)
    want = _groups(jeng, _as(jserving, reqs), SIZES)
    got = _groups(peng, _as(pserving, reqs), SIZES)
    _assert_same_responses(got, want)
    reasons = {f[0] for r in got for f in _fallbacks(r)}
    assert {"unknown_entity", "feature_overflow"} <= reasons
    assert peng.stats()["kernel_builds"]["steady"] == 0


def test_serve_matches_jax(engines):
    _, jeng, peng, _ = engines
    reqs = _requests(19, seed=2)
    _assert_same_responses(peng.serve(_as(pserving, reqs)),
                           jeng.serve(_as(jserving, reqs)))


def test_forced_shed_matches_jax(engines):
    """A queue past the shed depth scores fixed-effect only, typed."""
    d, _, _, _ = engines
    reqs = _requests(20, seed=3)
    out = []
    for pkg, kw in ((jserving, {}), (pserving, {"device": "cpu"})):
        eng = pkg.ServingEngine.from_model_dir(
            d, pkg.ServingConfig(max_batch=MAX_BATCH, feature_pad=PAD,
                                 max_wait_s=0.0,
                                 slo=pkg.SLOConfig(shed_queue_depth=8,
                                                   reject_queue_depth=18)),
            **kw)
        resps = [eng.submit(r) for r in _as(pkg, reqs)]
        refused = [r for r in resps if r is not None]
        out.append(refused + eng.drain())
    want, got = out
    _assert_same_responses(got, want)
    reasons = [f[0] for r in got for f in _fallbacks(r)]
    assert "slo_shed_random_effects" in reasons
    assert "slo_rejected" in reasons


def test_serving_model_from_arrays_matches_jax(engines):
    """Weights carried across as arrays (no disk) serve the same scores."""
    d, jeng, _, _ = engines
    jm = jmio.load_for_serving(d)
    index_maps = {}
    for sid, imap in jm.index_maps.items():
        cols = []
        for c in range(imap.feature_dimension):
            key = imap.get_feature_name(c)
            cols.append(None if key is None else tuple(key.split("\u0001")))
        index_maps[sid] = cols
    pm = serving_model_from_arrays(
        jm.task.value,
        [(f.coordinate_id, f.feature_shard_id, f.coefficients)
         for f in jm.fixed],
        [(r.coordinate_id, r.random_effect_type, r.feature_shard_id,
          r.coefficients, r.projection, r.entity_rows) for r in jm.random],
        index_maps, jm.metadata)
    peng = pserving.ServingEngine(
        pserving.DeviceResidentModel(pm, feature_pad=PAD, device="cpu"),
        pserving.ServingConfig(max_batch=MAX_BATCH, feature_pad=PAD,
                               max_wait_s=0.0))
    peng.warmup()
    reqs = _requests(15, seed=4)
    _assert_same_responses(peng.serve(_as(pserving, reqs)),
                           jeng.serve(_as(jserving, reqs)))


def test_every_batch_goes_through_the_margin_wrapper(engines, monkeypatch):
    """The scorer calls the gather+margin wrapper once per batch, in both
    modes, with every fixed shard concatenated against one theta."""
    _, _, peng, _ = engines
    calls = []
    real = gm.gather_margin

    def spy(idx, val, off, theta):
        calls.append((tuple(idx.shape), int(theta.shape[0])))
        return real(idx, val, off, theta)

    monkeypatch.setattr(gm, "gather_margin", spy)
    reqs = _requests(11, seed=5)
    for r in _as(pserving, reqs):
        peng.submit(r)
    peng.drain()
    assert calls == [((8, 2 * PAD), sum(SHARDS.values())),
                     ((4, 2 * PAD), sum(SHARDS.values()))]


def test_stats_report_stages_and_batches(engines):
    _, _, peng, _ = engines
    s = peng.stats()
    assert {"queue", "assemble", "score", "total"} <= set(s["latency_seconds"])
    assert any(k.startswith("serving.batches") for k in s["counters"])
    assert s["model"]["device"] == "cpu"
    assert s["kernel_builds"] == {"warmup": 0, "steady": 0}


def test_graceful_shutdown_matches_jax(engines):
    """A drain with no budget left refuses the queue with typed
    SHUTTING_DOWN, and admission after it refuses the same way."""
    d, _, _, _ = engines
    reqs = _requests(6, seed=6)
    out = []
    for pkg, kw in ((jserving, {}), (pserving, {"device": "cpu"})):
        eng = pkg.ServingEngine.from_model_dir(
            d, pkg.ServingConfig(max_batch=MAX_BATCH, feature_pad=PAD,
                                 max_wait_s=0.0), **kw)
        batch = _as(pkg, reqs)
        for r in batch[:5]:
            assert eng.submit(r) is None
        resps = eng.shutdown(drain_budget_s=0.0)
        resps.append(eng.submit(batch[5]))
        assert eng.draining
        out.append(resps)
    want, got = out
    assert [_fallbacks(r) for r in got] == [_fallbacks(r) for r in want]
    assert {f[0] for r in got for f in _fallbacks(r)} == {"shutting_down"}
    assert all(r.score is None for r in got)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_deadlines_and_breaker_match_jax(engines):
    """On one injected clock: a budget below the service floor is refused
    at admission, a request that waited past its deadline expires in the
    queue, and a breaker whose latency ceiling every batch breaches goes
    closed -> shed (typed breaker shed) -> open (typed rejection)."""
    d, _, _, _ = engines
    reqs = _requests(4, seed=7)
    out = []
    for pkg, kw in ((jserving, {}), (pserving, {"device": "cpu"})):
        clock = _Clock()
        eng = pkg.ServingEngine.from_model_dir(
            d, pkg.ServingConfig(
                max_batch=MAX_BATCH, feature_pad=PAD, max_wait_s=0.0,
                deadline=pkg.DeadlineConfig(min_service_s=0.01),
                breaker=pkg.BreakerConfig(min_samples=1, latency_p99_s=0.0,
                                          cooldown_s=60.0)),
            clock=clock, **kw)
        batch = _as(pkg, reqs)
        batch[0].timeout_s = 0.001
        batch[1].timeout_s = 1.0
        resps = [eng.submit(batch[0])]               # below the floor
        assert eng.submit(batch[1]) is None
        clock.t += 2.0
        resps += eng.drain()                         # expires batch[1]
        assert eng.submit(batch[2]) is None
        resps += eng.drain()                         # full, trips to shed
        assert eng.submit(batch[3]) is None
        resps += eng.drain()                         # breaker shed -> open
        resps.append(eng.submit(batch[0]))           # open: rejected
        out.append((resps, eng.breaker.state()))
    (want, jstate), (got, pstate) = out
    assert pstate == jstate == "open"
    _assert_same_responses(got, want)
    assert [f[0] for r in got for f in _fallbacks(r)
            if f[0] not in ("unknown_entity", "feature_overflow")] == [
        "deadline_exceeded", "deadline_exceeded",
        "breaker_shed_random_effects", "breaker_rejected"]
