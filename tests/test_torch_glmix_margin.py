"""The whole GLMix serving margin (K3 with the random-effect terms): the
port's plain version and scorer against the JAX scorer program.

One model dir saved by the JAX package (two fixed shards, a per-user
random effect with 4 slots and a per-item one with 3) is loaded by both
packages. The port assembles each batch; the same arrays go through
``photon_tpu.serving.scorer.get_scorer(jmodel, mode, bucket)`` (one XLA
program: the fused fixed margin, then every random-effect gather) and
through the port's ``glmix_margin_reference`` and ``scorer.dispatch``
on the CPU (which packs the batch into the staging layout and runs the
plain version on it). Tolerance atol = rtol = 1e-5: f32 sums in other
orders, as ``tests/test_torch_serving.py``.
"""

import threading

import numpy as np
import pytest
import torch

from photon_tpu import serving as jserving
from photon_tpu.serving import scorer as jscorer
from photon_tpu_torch import serving as pserving
from photon_tpu_torch.ops import gather_margin as gm
from photon_tpu_torch.serving import scorer

from test_torch_serving import MAX_BATCH, PAD, _as, _build_model_dir, _requests

TOL = dict(rtol=1e-5, atol=1e-5)
BUCKETS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("glmix") / "model")
    _build_model_dir(d)
    jm = jserving.ServingEngine.from_model_dir(
        d, jserving.ServingConfig(max_batch=MAX_BATCH, feature_pad=PAD,
                                  max_wait_s=0.0)).model
    pm = pserving.ServingEngine.from_model_dir(
        d, pserving.ServingConfig(max_batch=MAX_BATCH, feature_pad=PAD,
                                  max_wait_s=0.0), device="cpu").model
    return jm, pm


def _batch(pm, bucket, seed, stray_rows=True):
    """Assembled arrays of one bucket: a remainder of pad rows, unknown
    entities (the requests' own), and where ``stray_rows`` an entity row
    past the zero row in each coordinate."""
    n = max(bucket - 1, 1)
    args, _, _ = pm.assemble(_as(pserving, _requests(n, seed)), bucket)
    if stray_rows:
        for c, rs in enumerate(pm.random):
            args[4][c][(c + seed) % n] = rs.num_entities + 1 + c * 4
    return args


def _reference(pm, mode, args):
    """glmix_margin_reference on the assembled arrays, unpacked by hand."""
    fixed_idx, fixed_val, re_sidx, re_sval, re_ent, offsets = args
    idx = np.concatenate([fixed_idx[p] + off for p, off in
                          zip(pm.fixed_pos, pm.fixed_col_off)], axis=1)
    val = np.concatenate([fixed_val[p] for p in pm.fixed_pos], axis=1)
    coords = range(len(pm.random)) if mode == "full" else ()
    return gm.glmix_margin_reference(
        torch.from_numpy(idx), torch.from_numpy(val),
        torch.from_numpy(offsets), pm.theta_all,
        [pm.random[c].coef for c in coords],
        [torch.from_numpy(re_ent[c]) for c in coords],
        [torch.from_numpy(re_sidx[c]) for c in coords],
        [torch.from_numpy(re_sval[c]) for c in coords]).numpy()


@pytest.mark.parametrize("mode", ["full", "fixed_only"])
@pytest.mark.parametrize("bucket", BUCKETS)
def test_reference_and_dispatch_match_the_jax_scorer(models, mode, bucket):
    jm, pm = models
    args = _batch(pm, bucket, seed=bucket)
    want = np.asarray(jscorer.get_scorer(jm, mode, bucket)(
        *jscorer.mode_args(jm, mode, args)))
    np.testing.assert_allclose(_reference(pm, mode, args), want, **TOL)
    before = gm.launches
    got = scorer.dispatch(pm, mode, args)
    assert got.dtype == torch.float32 and got.shape == (bucket,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert gm.launches == before


def test_unknown_and_stray_entities_add_nothing(models):
    """Rows with an unknown entity (the zero row), an entity row past the
    table, or a negative one score their fixed term alone. (A negative
    row wraps in the JAX scorer's indexing; ``assemble`` never emits one.)"""
    _, pm = models
    args = _batch(pm, 8, seed=3, stray_rows=False)
    fixed = scorer.dispatch(pm, "fixed_only", args).numpy()
    for c, rs in enumerate(pm.random):
        args[4][c][:] = [rs.num_entities, rs.num_entities + 1, -1, -2,
                         2**31, -2**31, 2**40, rs.num_entities]
    np.testing.assert_array_equal(scorer.dispatch(pm, "full", args).numpy(),
                                  fixed)


def test_reference_matches_a_loop_oracle():
    """0, 1 and 3 coordinates with K_c = 1, 8, 32 and 33: pad slots,
    unknown-entity rows, entity rows out of range on both sides,
    duplicate and out-of-range slot ids, against a float64 loop."""
    rng = np.random.default_rng(4)
    B, K, D = 37, 6, 20
    idx = rng.integers(-2, D + 2, size=(B, K))
    val = rng.normal(size=(B, K))
    off = rng.normal(size=B)
    theta = rng.normal(size=D)
    for widths in ((), (8,), (1, 32, 33)):
        tables, ents, sidxs, svals = [], [], [], []
        for k in widths:
            E = 9
            t = np.concatenate([rng.normal(size=(E, k)), np.zeros((1, k))])
            ent = rng.integers(-2, E + 3, size=B)
            sidx = rng.integers(-1, k + 1, size=(B, k))
            sidx[:, -1] = sidx[:, 0]                    # duplicates
            sval = rng.normal(size=(B, k))
            sval[::4] = 0.0                             # pad slots
            tables.append(t)
            ents.append(ent)
            sidxs.append(sidx)
            svals.append(sval)
        want = off + np.array([sum(val[b, j] * theta[idx[b, j]]
                                   for j in range(K) if 0 <= idx[b, j] < D)
                               for b in range(B)])
        for t, ent, sidx, sval in zip(tables, ents, sidxs, svals):
            rows, k = t.shape
            want = want + np.array([
                sum(sval[b, j] * t[ent[b], sidx[b, j]] for j in range(k)
                    if 0 <= sidx[b, j] < k) if 0 <= ent[b] < rows else 0.0
                for b in range(B)])
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
        i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)
        got = gm.glmix_margin_reference(
            i32(idx), f32(val), f32(off), f32(theta), [f32(t) for t in tables],
            [i32(e) for e in ents], [i32(s) for s in sidxs],
            [f32(v) for v in svals])
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pack_round_trips_every_array(models):
    """The staged layout gives back every array: the fixed shards side by
    side (each shifted by its column offset), the offsets, and each
    coordinate's entity rows and slots, narrowed to int32 exactly at the
    sizes ``assemble`` emits; a row out of range packs out of range, past
    int32 too, instead of wrapping into the table."""
    _, pm = models
    args = _batch(pm, 8, seed=6, stray_rows=False)
    fixed_idx, fixed_val, re_sidx, re_sval, re_ent, offsets = args
    for with_random in (False, True):
        assert scorer.pack(pm, with_random, args) == 8
        idx, val, off, coords = pm.margin.arrays(pm.margin.host_np, 8,
                                                 with_random)
        assert len(coords) == (len(pm.random) if with_random else 0)
        col = 0
        for p, shift in zip(pm.fixed_pos, pm.fixed_col_off):
            w = fixed_idx[p].shape[1]
            np.testing.assert_array_equal(idx[:, col:col + w],
                                          fixed_idx[p] + shift)
            np.testing.assert_array_equal(val[:, col:col + w], fixed_val[p])
            col += w
        assert col == pm.margin.k_fixed == idx.shape[1]
        np.testing.assert_array_equal(off, offsets)
        for (ent, sidx, sval), rs, e, s, v in zip(coords, pm.random, re_ent,
                                                  re_sidx, re_sval):
            assert ent.dtype == sidx.dtype == np.int32
            np.testing.assert_array_equal(ent, e)
            np.testing.assert_array_equal(sidx, s)
            np.testing.assert_array_equal(sval, v)
    # 2**32 + 1 would wrap to row 1 in int32: it packs past the zero row
    E = pm.random[0].num_entities
    args[4][0][:3] = [2**32 + 1, E + 7, -2**40]
    args[2][0][0, :2] = [2**32 + 1, -5]
    scorer.pack(pm, True, args)
    ent, sidx, _ = pm.margin.arrays(pm.margin.host_np, 8, True)[3][0]
    np.testing.assert_array_equal(ent[:3], [E + 1, E + 1, -1])
    np.testing.assert_array_equal(sidx[0, :2], [pm.random[0].slot_width, -1])


def test_two_dispatches_before_reading_either(models):
    """A second batch packed into the same staging buffer before the
    first result is read leaves the first result as it was."""
    jm, pm = models
    a1, a2 = _batch(pm, 8, seed=7), _batch(pm, 8, seed=8)
    r1 = scorer.dispatch(pm, "full", a1)
    r2 = scorer.dispatch(pm, "full", a2)
    for got, args in ((r1, a1), (r2, a2)):
        want = np.asarray(jscorer.get_scorer(jm, "full", 8)(
            *jscorer.mode_args(jm, "full", args)))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not np.array_equal(r1.numpy(), r2.numpy())


def test_dispatches_from_several_threads_get_their_own_scores(models):
    """Threads dispatching on one model share its staging buffer; each
    dispatch holds the model's lock from its pack through its kernel
    call, so every thread gets the scores of its own batch."""
    jm, pm = models
    batches = [_batch(pm, 8, seed=20 + t) for t in range(4)]
    wants = [np.asarray(jscorer.get_scorer(jm, "full", 8)(
        *jscorer.mode_args(jm, "full", a))) for a in batches]
    got = [[] for _ in batches]

    def serve(t):
        for _ in range(25):
            got[t].append(scorer.dispatch(pm, "full", batches[t]).numpy())

    threads = [threading.Thread(target=serve, args=(t,))
               for t in range(len(batches))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for scores, want in zip(got, wants):
        assert len(scores) == 25
        for s in scores:
            np.testing.assert_allclose(s, want, **TOL)


def test_layout_agrees_with_the_kernel_descriptors(models):
    """The word offsets ``MarginState.layout`` gives are the ones the
    descriptors hand the kernel (scaled by the batch's rows), the
    coordinates follow the fixed part without gaps, and fixed-only
    batches stage the fixed part alone."""
    _, pm = models
    state = pm.margin
    kf = state.k_fixed
    for B in (1, 5, 8):
        i, v, o, spans, words = state.layout(B, True)
        assert (i, v, o) == (0, B * kf, 2 * B * kf)
        end = o + B
        for c, ((e, s, w), k) in enumerate(zip(spans, state.slot_widths)):
            assert [B * int(x) for x in state.desc[c, 3:]] == [e, s, w]
            assert (e, s, w) == (end, end + B, end + B + B * k)
            assert int(state.desc[c, 2]) == k
            end = w + B * k
        assert words == end
        assert state.layout(B, False)[3:] == ([], o + B)


def test_wrapper_and_pack_reject_what_they_do_not_take(models):
    _, pm = models
    state = pm.margin
    with pytest.raises(ValueError):
        gm.glmix_margin(state, state.rows + 1, False)
    with pytest.raises(ValueError):
        gm.glmix_margin(state, 0, True)
    with pytest.raises(TypeError):
        gm.MarginState(pm.theta_all, [pm.random[0].coef.double()], 1)
    args = list(_batch(pm, 4, seed=9))
    args[5] = args[5][:3]                   # offsets one row short
    with pytest.raises(ValueError):
        scorer.dispatch(pm, "full", tuple(args))
    args = list(_batch(pm, 4, seed=9))
    args[0] = (args[0][0][:, :-1],) + args[0][1:]     # a slot short
    with pytest.raises(ValueError):
        scorer.dispatch(pm, "fixed_only", tuple(args))
