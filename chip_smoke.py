#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (photon_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing lines tagged [k/6]:
  1. the device: torch/CUDA versions, the card's name and power limit;
  2. building every kernel from ``photon_tpu_torch/csrc``, one ``nvcc``
     per source, all started together;
  3. each kernel against its plain PyTorch version on the card, over edge
     shapes, plus a bitwise check of a second launch: K3 gather+margin
     (pad slots, duplicate and out-of-range indices, no offsets, empty
     batches); K3's fused GLMix form (B = 1, each bucket of 1..64 and +- 1
     of an 8-row block; 0, 1 and 3 random coordinates of 1, 8, 32 and 33
     slots and fixed-only; pad slots, unknown-entity rows, entity rows and
     slot ids out of range, duplicate slot ids); K1 dense and K2
     padded-ELL value+gradient (every loss,
     None offsets/weights, zero-weight rows, n = 0, 1 and a tile +- 1,
     bf16 storage; K1 at D = 1 to 65,537 (each form and loader, a
     cluster's rows in flight +- 1, X not on a 16-byte boundary); K2 at
     D = 1, 2048, 4096 and ELL widths 0, 5, 32, 33, 64, n a warp's run
     of rows +- 1, a block's +- 1 and the grid's +- 1, with empty
     segments, duplicate and out-of-range ids, every entry in one
     column, and Zipf-skewed columns);
  4. the serving main path at the width of the repo's serving benchmark
     model (one fixed-effect shard of 256 features, a per-user random
     effect over 10,000 users with 8 slots, 32 features per request, 10%
     unknown users, buckets 1..64): write the model dir, load it with
     ``ServingEngine.from_model_dir`` on the card, ``warmup()``, then
     2,000 requests through submit/pump/drain, 100 single-request
     ``serve()`` calls, a forced-shed pass and 60 ladder-top batches
     under ``torch.profiler``, every score checked against a float64
     numpy oracle built from the saved arrays; exactly one kernel launch
     per batch, and in the profiled window one kernel, one copy in and
     one copy out per batch and nothing else on the device; per-stage
     latency and throughput;
  5. the training main path, through ``GlmOptimizationProblem.run`` and
     ``train_generalized_linear_model`` on the card: dense L-BFGS at
     ``bench.py::config_fe_throughput``'s width (1,000,000 x 1024, f32
     then bf16 storage, cold then warm), ELL L-BFGS at ``run_fused_bench``'s
     (65,536 x 32 slots, D = 2048, lambda 10 -> 1 -> 0.1 warm-started),
     dense NEWTON at the flagship's fixed-effect width (100,000 x 256,
     scored on 20,000 validation rows). Every evaluation of these f32 fits
     must be one K1 or K2 launch and none two-pass; the L-BFGS fits are
     held to a float64 solve of the same problem on the card, the NEWTON
     fit to scipy's L-BFGS-B in float64 (coefficients and validation AUC);
  6. times: each kernel at the main-path shapes (and a throughput shape;
     for K1 also the main shape plus an intercept column and widths 4096,
     10,000, 10,001 and 65,537; for K2 also Zipf-skewed columns) beside
     its plain version, its byte bound and one PyTorch library call
     computing the same function (a yardstick only; the port never calls
     it), in CUDA-graph replay (the card's time per call) and as
     back-to-back eager calls (the host's issue rate where that is slower).
     For the fused margin, which no one library call computes:
     ``embedding_bag`` for its fixed term, the parent's chain of K3 and
     torch ops, the launch floor (an empty kernel in graph replay, and one
     C-call round trip: copy in, empty kernel, copy out, wait), and
     ``scorer.dispatch`` through to the host result, p50/p99 over 2,000
     calls a mode.

``--times-only`` runs phases 1, 2 and 6 alone, on fresh data, and
prints no ``ok`` line: for timing another tree's kernels and scorer with
this script in one call (the fused kernel's times only where that tree
has it).

Any failure raises and exits non-zero. The line before the last is the
kernels' JSON record; the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result.
Imports nothing of JAX or photon_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, ".chip_smoke")

#: H100 SXM device memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, flop/s
F32_FLOPS = 67e12
#: kernel vs plain version: f32 sums taken in another order
ATOL = RTOL = 1e-5
#: K1/K2 vs plain version, relative to the terms' magnitude sums with
#: each margin's own rounding carried through (``_vg_scales``): the sums
#: run in other orders than cuBLAS / index_add_. Largest readings on an
#: H100 over two runs (chip_smoke.py, seed 0): 5.1e-7 and 6.1e-7 (K2
#: cases, both at D = 1: every term into one column, which index_add_
#: sums in no fixed order), 1.7e-7 (K1 cases), 2.2e-7 (timing shapes);
#: the limit is about 3x the largest
VG_RTOL = 2e-6
#: rows per block in the grid sizing of K1/K2 and per K1 tile
#: (csrc/fused_value_grad.cu kTileRows)
VG_TILE = 32
#: K1 widths: each form of csrc/fused_value_grad.cu. Rows in registers
#: (D <= 8192) with 16-byte pieces, 1 warp a row (1024), 2 (2000: the last
#: columns of each lane's pieces unused), 8 (5000); with one element a
#: piece (rows not a whole number of 16-byte vectors: 1, 7, 257, 1025,
#: 4097, 5001); a cluster of 2 blocks a row (8193, 10,000, 10,001, 12,001,
#: 12,008), of 4 (16,385) and of 8 (65,536); the tile form (65,537)
VG_DENSE_DS = (1, 7, 257, 1024, 1025, 2000, 4097, 5000, 5001, 8193,
               10_000, 10_001, 12_001, 12_008, 16_385, 65_536, 65_537)
#: K1 row counts: 0, 1, a tile +- 1, and the cluster form's rows in flight
#: +- 1 (a full grid of 264 blocks is 132, 66 or 33 clusters of 2, 4 or 8
#: blocks, each taking a row at a time: 8448 = 64 x 132 = 128 x 66 =
#: 256 x 33), and one more
VG_DENSE_NS = (0, 1, VG_TILE - 1, VG_TILE + 1, 8447, 8449, 8453)
#: K2's row assignment (csrc/fused_value_grad.cu kSparseRows, kGridBlocks
#: and the warps a block, 8 for D <= 2048, else 4): a warp takes runs of 8
#: rows, a block 8 runs a step (64 rows) where D <= 2048, the grid 264
#: blocks' worth (16,896 rows, or 8,448 with 4 warps)
K2_RUN, VG_GRID = 8, 264
#: K1 timing shapes past the main path's width, (n, D, storage), each
#: about as many bytes as its 1M x 1024: the main shape plus an intercept
#: column (D = 1025, rows not a whole number of 16-byte vectors), 4 warps
#: a row (D = 4096), rows wider than one block (D = 10,000 and 10,001),
#: and past D = 65,536 (the tile form)
K1_WIDE_SHAPES = ((1_000_000, 1025, torch.float32),
                  (1_000_000, 1025, torch.bfloat16),
                  (250_000, 4096, torch.float32),
                  (100_000, 10_000, torch.float32),
                  (100_000, 10_001, torch.float32),
                  (15_000, 65_537, torch.float32))
#: K2 timing shapes (n, K, D, column draw): the ELL main path, a
#: throughput shape, and the same with Zipf(1.1) column ids, the skew of
#: real sparse features
K2_SHAPES = ((65_536, 32, 2048, "uniform"), (1_000_000, 32, 4096, "uniform"),
             (1_000_000, 32, 4096, "zipf"))
ZIPF_S = 1.1
#: training main path widths
FE_N, FE_D = 1_000_000, 1024                      # config_fe_throughput
ELL_N, ELL_K, ELL_D = 65_536, 32, 2048            # run_fused_bench
ELL_LAMBDAS = (10.0, 1.0, 0.1)
NEWTON_N, NEWTON_N_VAL, NEWTON_D = 100_000, 20_000, 256  # flagship FE
#: L-BFGS fits against their float64 solve: relative objective gap and
#: relative L2 coefficient distance, per fit, each about 10x the largest
#: reading on an H100 (chip_smoke.py, seed 0), given beside it. The ELL
#: fits stop at tolerance 1e-7, short of the optimum, hence their wider
#: coefficient limit
ORACLE_LIMITS = {"dense f32": (1e-11, 2e-5),    # 3.3e-13, 1.6e-6
                 "dense bf16": (5e-9, 4e-4),    # 2.4e-10, 3.9e-5
                 "ELL": (5e-7, 9e-3)}           # 5.1e-8, 9.0e-4
#: NEWTON against scipy's L-BFGS-B: coefficient distance (reading 6.5e-8),
#: AUC bar (bench.py:641's bar against sklearn)
NEWTON_COEF_REL, AUC_BAR = 1e-6, 0.005

# serving benchmark model width (bench.py's serving mode)
D_GLOBAL, N_USERS, K_USER, NNZ = 256, 10_000, 8, 32
N_REQUESTS, N_SINGLE, N_SHED = 2_000, 100, 256
MAX_BATCH = 64
#: ladder-top batches served under torch.profiler in phase 4
PROFILED_BATCHES = 60
#: the launch floor's library (timing only; csrc/launch_floor.cu)
FLOOR_KERNEL = "launch_floor"


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def check_close(got: torch.Tensor, want: torch.Tensor, what: str,
                scale: torch.Tensor = None, rtol: float = RTOL) -> float:
    """|got - want| <= ATOL + rtol * scale, elementwise; ``scale`` is
    |want| by default. Where many terms are summed, pass the sum of the
    terms' magnitudes: a reordered f32 sum errs relative to that, not to
    a result that may have cancelled to near zero."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    g, w = got.double().cpu(), want.double().cpu()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (g - w).abs()
    ref = w.abs() if scale is None else scale.double().cpu()
    bad = err > ATOL + rtol * ref
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} values outside "
                             f"atol {ATOL} rtol {rtol}, max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def time_ms(fn, iters: int, warm: int = 5) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back eager calls,
    CUDA events. Where a call's host work outlasts its device work, this
    is the host's issue rate, not the card's time."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int, replays: int) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events. A replay
    does no host work per call, so this reads the card's time (each
    launch plus the gap between graph nodes) even where ``time_ms``
    reads the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def margin_case(rng, B: int, K: int, D: int, dev, *, pads=True,
                stray=True):
    """Seeded gather+margin inputs: ~25% pad slots (0, 0.0), duplicate
    indices in a row, ~5% indices outside [0, D)."""
    idx = rng.integers(0, D, size=(B, K))
    val = rng.normal(size=(B, K))
    if pads and K:
        pad = rng.random((B, K)) < 0.25
        idx[pad], val[pad] = 0, 0.0
    if K > 1:
        dup = rng.random(B) < 0.5
        idx[dup, 1] = idx[dup, 0]
    if stray and K:
        out = rng.random((B, K)) < 0.05
        idx[out] = rng.choice([-1, -7, D, D + 3, 2**31 - 1], size=int(out.sum()))
    off = rng.normal(size=B)
    theta = rng.normal(size=D) * 0.5
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    return (t(idx, torch.int32), t(val, torch.float32),
            t(off, torch.float32), t(theta, torch.float32))


def check_gather_margin(gm, rng, dev):
    worst = 0.0
    cases = 0
    for B in (1, 5, 64, 127, 129, 4096):
        for K in (0, 1, 6, 256):
            for D in (8, 256, 8192):
                idx, val, off, theta = margin_case(rng, B, K, D, dev)
                for offsets in (off, None):
                    got = gm.gather_margin(idx, val, offsets, theta)
                    again = gm.gather_margin(idx, val, offsets, theta)
                    want = gm.gather_margin_reference(idx, val, offsets,
                                                      theta)
                    torch.cuda.synchronize()
                    what = f"gather_margin B={B} K={K} D={D} " \
                           f"off={'none' if offsets is None else 'yes'}"
                    worst = max(worst, check_close(got, want, what))
                    if not torch.equal(got, again):
                        raise AssertionError(f"{what}: second launch is "
                                             f"not bitwise equal")
                    cases += 1
    empty = gm.gather_margin(torch.zeros((0, 3), dtype=torch.int32,
                                         device=dev),
                             torch.zeros((0, 3), device=dev), None,
                             torch.zeros(8, device=dev))
    if empty.shape != (0,):
        raise AssertionError(f"gather_margin n=0 gave shape {empty.shape}")
    return worst, cases + 1


def fill_margin(rng, state, B: int, with_random: bool, live: int = None,
                stray: bool = True) -> None:
    """Seeded GLMix inputs packed into ``state``'s staging buffer: the
    fixed slots as ``margin_case`` draws them (or ``live`` real slots a
    row, the rest pads), and per coordinate ~20% unknown-entity rows (the
    zero row E), ~25% pad slots, duplicate slot ids in half the rows and,
    where ``stray``, ~5% entity rows and slot ids out of range."""
    state.reserve(B)
    idx, val, off, coords = state.arrays(state.host_np, B, with_random)
    D, K = state.theta.shape[0], state.k_fixed
    if live is None:
        i, v, o, _ = margin_case(rng, B, K, D, "cpu", stray=stray)
        idx[:], val[:], off[:] = i.numpy(), v.numpy(), o.numpy()
    else:
        idx[:], val[:] = 0, 0.0
        idx[:, :live] = rng.random((B, D)).argsort(axis=1)[:, :live]
        val[:, :live] = rng.normal(size=(B, live))
        off[:] = rng.normal(size=B)
    for (ent, sidx, sval), table in zip(coords, state.tables):
        rows, k = table.shape
        ent[:] = rng.integers(0, rows - 1, size=B)
        ent[rng.random(B) < 0.2] = rows - 1
        sidx[:] = rng.integers(0, k, size=(B, k))
        sval[:] = rng.normal(size=(B, k))
        pad = rng.random((B, k)) < 0.25
        sidx[pad], sval[pad] = 0, 0.0
        if k > 1:
            dup = rng.random(B) < 0.5
            sidx[dup, -1] = sidx[dup, 0]
        if stray:
            out = rng.random(B) < 0.05
            ent[out] = rng.choice([-1, -5, rows, rows + 8, 2**31 - 1],
                                  size=int(out.sum()))
            out = rng.random((B, k)) < 0.05
            sidx[out] = rng.choice([-1, k, k + 3], size=int(out.sum()))


def margin_reference(gm, state, buf, B: int, with_random: bool,
                     magnitude: bool = False) -> torch.Tensor:
    """The plain version, on the card, on one staged batch in ``buf``
    (the host buffer as packed, moved to the card, or the device buffer
    after a launch); with ``magnitude`` the sum of the terms' magnitudes,
    the scale a reordered f32 sum errs relative to."""
    idx, val, off, coords = state.arrays(buf.to(state.device), B,
                                         with_random)
    f = torch.abs if magnitude else (lambda t: t)
    return gm.glmix_margin_reference(
        idx, f(val), f(off), f(state.theta),
        [f(t) for t in state.tables[:len(coords)]], [c[0] for c in coords],
        [c[1] for c in coords], [f(c[2]) for c in coords])


#: phase-3 shapes of the fused margin: B = 1, each bucket of the ladder
#: 1..64 and +- 1 of an 8-row block; coordinate slot widths (0, 1 and 3
#: coordinates); fixed slot widths
GLMIX_BS = (1, 2, 4, 7, 8, 9, 15, 16, 17, 32, 63, 64, 65)
GLMIX_COORDS = ((), (1,), (8,), (32,), (33,), (1, 8, 33), (33, 32, 8))
GLMIX_KF = (0, 7, 256)


def check_glmix_margin(gm, rng, dev):
    """The fused kernel against its plain version on the card, each case
    launched twice (bitwise equal), in full and fixed-only mode. The
    plain version reads the batch as packed on the host, so the whole
    wrapper (the copy in, the launch, the copy out) is held to it; the
    words the copy left in the device buffer must equal the packed ones."""
    worst, cases = 0.0, 0
    theta = torch.as_tensor(rng.normal(size=D_GLOBAL) * 0.5,
                            dtype=torch.float32, device=dev)
    for ci, widths in enumerate(GLMIX_COORDS):
        tables = [torch.as_tensor(
            np.concatenate([rng.normal(size=(50, k)), np.zeros((1, k))]),
            dtype=torch.float32, device=dev) for k in widths]
        state = gm.MarginState(theta, tables, GLMIX_KF[ci % len(GLMIX_KF)])
        for B in GLMIX_BS:
            for full in dict.fromkeys((bool(widths), False)):
                fill_margin(rng, state, B, full)
                got = gm.glmix_margin(state, B, full)
                again = gm.glmix_margin(state, B, full)
                want = margin_reference(gm, state, state.host, B, full)
                mag = margin_reference(gm, state, state.host, B, full, True)
                what = (f"glmix_margin B={B} K_f={state.k_fixed} slot "
                        f"widths {widths if full else ()}")
                worst = max(worst, check_close(got, want, what, mag))
                words = state.launch_args(B, full)[0] // 4
                if not torch.equal(state.dev[:words].cpu(),
                                   state.host[:words]):
                    raise AssertionError(f"{what}: the staged copy differs "
                                         f"from the packed words")
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: second launch is not "
                                         f"bitwise equal")
                cases += 1
    return worst, cases


# ---------------------------------------------------------------------------
# phase 4: the serving main path
# ---------------------------------------------------------------------------


def write_model(model_dir: str, rng):
    from photon_tpu_torch.game.dataset import EntityVocabulary
    from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                             RandomEffectModel)
    from photon_tpu_torch.io.index_map import IndexMapBuilder, feature_key
    from photon_tpu_torch.io.model_io import save_game_model
    from photon_tpu_torch.models.glm import (Coefficients,
                                             GeneralizedLinearModel)
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    b = IndexMapBuilder()
    for j in range(D_GLOBAL):
        b.put(feature_key(f"g{j}", ""))
    imap = b.build()
    theta = rng.normal(size=D_GLOBAL).astype(np.float32)
    coef = rng.normal(size=(N_USERS, K_USER)).astype(np.float32)
    proj = np.stack([np.sort(rng.choice(D_GLOBAL, size=K_USER,
                                        replace=False))
                     for _ in range(N_USERS)]).astype(np.int32)
    vocab = EntityVocabulary()
    vocab.build("userId", [f"u{e}" for e in range(N_USERS)])
    model = GameModel({
        "global": FixedEffectModel(GeneralizedLinearModel(
            Coefficients(torch.from_numpy(theta)), task), "global"),
        "per_user": RandomEffectModel(torch.from_numpy(coef), "userId",
                                      "global", task),
    })
    save_game_model(model_dir, model, {"global": imap}, vocab,
                    {"per_user": proj})
    # the Avro fixed-effect record drops |theta| <= 1e-4 (the reference's
    # sparsity threshold); the cold store keeps coef exactly
    theta_saved = np.where(np.abs(theta) <= 1e-4, 0.0, theta)
    return theta_saved.astype(np.float64), coef.astype(np.float64), proj


def make_requests(rng, prefix: str, n: int):
    from photon_tpu_torch.serving import ScoreRequest

    reqs = []
    for i in range(n):
        cols = rng.choice(D_GLOBAL, size=NNZ, replace=False)
        user = (f"u{int(rng.integers(0, N_USERS))}" if i % 10
                else f"cold{i}")
        reqs.append(ScoreRequest(
            f"{prefix}{i}",
            {"global": [(f"g{c}", "", float(rng.normal())) for c in cols]},
            {"userId": user}))
    return reqs


def oracle(req, theta, coef, proj, with_random: bool) -> float:
    x = np.zeros(D_GLOBAL)
    for name, _, v in req.features["global"]:
        x[int(name[1:])] = np.float32(v)
    s = float(theta @ x) + req.offset
    user = req.entity_ids["userId"]
    if with_random and user.startswith("u"):
        e = int(user[1:])
        s += float(coef[e] @ x[proj[e]])
    return s


def check_responses(reqs, resps, theta, coef, proj) -> dict:
    from photon_tpu_torch.serving import FallbackReason

    if len(resps) != len(reqs):
        raise AssertionError(f"{len(resps)} responses for {len(reqs)} "
                             f"requests")
    by_uid = {r.uid: r for r in reqs}
    seen = {"shed": 0, "unknown": 0, "full": 0}
    worst = 0.0
    for resp in resps:
        req = by_uid[resp.uid]
        reasons = {f.reason for f in resp.fallbacks}
        if resp.score is None:
            raise AssertionError(f"{resp.uid} refused: {resp.fallbacks}")
        shed = FallbackReason.SLO_SHED_RANDOM_EFFECTS in reasons
        known = req.entity_ids["userId"].startswith("u")
        if not shed and (FallbackReason.UNKNOWN_ENTITY in reasons) == known:
            raise AssertionError(f"{resp.uid}: unknown_entity flag "
                                 f"{reasons} for user "
                                 f"{req.entity_ids['userId']}")
        want = oracle(req, theta, coef, proj, with_random=not shed)
        err = abs(resp.score - want)
        if err > ATOL + RTOL * abs(want):
            raise AssertionError(f"{resp.uid}: score {resp.score} vs "
                                 f"oracle {want} (shed={shed})")
        worst = max(worst, err)
        seen["shed" if shed else ("full" if known else "unknown")] += 1
    seen["max_abs_err"] = worst
    return seen


def batch_count(stats: dict) -> int:
    return int(sum(v for k, v in stats["counters"].items()
                   if k.startswith("serving.batches")))


def serving_main_path(gm, rng, card: str) -> dict:
    from photon_tpu_torch.obs.metrics import registry
    from photon_tpu_torch.serving import (SLOConfig, ServingConfig,
                                          ServingEngine)

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    model_dir = os.path.join(WORK_DIR, "model")
    t0 = time.perf_counter()
    theta, coef, proj = write_model(model_dir, rng)
    write_s = time.perf_counter() - t0
    reqs = make_requests(rng, "q", N_REQUESTS)
    singles = make_requests(rng, "s", N_SINGLE)
    shed_reqs = make_requests(rng, "shed", N_SHED)

    # the main path's launch count: from zero, just before loading
    gm.launches = 0
    registry.clear()
    t0 = time.perf_counter()
    engine = ServingEngine.from_model_dir(
        model_dir, ServingConfig(
            max_batch=MAX_BATCH, max_wait_s=0.001,
            slo=SLOConfig(shed_queue_depth=2 * MAX_BATCH,
                          reject_queue_depth=4096)))
    load_s = time.perf_counter() - t0
    if engine.model.device.type != "cuda":
        raise AssertionError(f"engine staged on {engine.model.device}")
    winfo = engine.warmup()
    after_warmup = gm.launches
    print(f"[4/6] model dir written in {write_s:.2f}s, loaded+staged in "
          f"{load_s:.2f}s, warmup {winfo['programs']} dispatches in "
          f"{winfo['seconds']:.3f}s, kernel builds {winfo['kernel_builds']}",
          flush=True)

    # pass A: submit/pump/drain, queue kept at most one ladder top deep
    registry.clear()
    out = []
    t0 = time.perf_counter()
    for r in reqs:
        refused = engine.submit(r)
        if refused is not None:
            raise AssertionError(f"{r.uid} refused: {refused.fallbacks}")
        if engine.batcher.depth() >= MAX_BATCH:
            out.extend(engine.pump())
    out.extend(engine.drain())
    torch.cuda.synchronize()
    pass_a_s = time.perf_counter() - t0
    stats_a = engine.stats()
    batches = batch_count(stats_a)
    seen_a = check_responses(reqs, out, theta, coef, proj)
    if seen_a["shed"]:
        raise AssertionError(f"{seen_a['shed']} shed responses in the "
                             f"unloaded pass")

    # pass B: single-request serve() calls, host clock each
    single_s = []
    single_out = []
    for r in singles:
        t0 = time.perf_counter()
        single_out.extend(engine.serve([r]))
        single_s.append(time.perf_counter() - t0)
    seen_b = check_responses(singles, single_out, theta, coef, proj)

    # pass C: forced shed — the queue is past the shed depth at the first
    # pops, so those batches score fixed-effect only
    for r in shed_reqs:
        refused = engine.submit(r)
        if refused is not None:
            raise AssertionError(f"{r.uid} refused: {refused.fallbacks}")
    shed_out = engine.drain()
    seen_c = check_responses(shed_reqs, shed_out, theta, coef, proj)
    if not seen_c["shed"]:
        raise AssertionError("forced-shed pass produced no "
                             "slo_shed_random_effects response")

    # pass D: submit/pump at the ladder top under torch.profiler, every
    # batch one kernel, one copy in and one copy out on the card
    prof_reqs = make_requests(rng, "p", PROFILED_BATCHES * MAX_BATCH)
    window = profile_serving(engine, gm, prof_reqs)
    seen_d = check_responses(prof_reqs, window.pop("responses"), theta,
                             coef, proj)

    torch.cuda.synchronize()
    stats = engine.stats()
    launches = gm.launches
    all_batches = batch_count(stats)
    traffic_launches = launches - after_warmup
    if traffic_launches != all_batches:
        raise AssertionError(f"glmix_margin launched {traffic_launches} "
                             f"times for {all_batches} batches")
    if stats["kernel_builds"]["steady"] != 0:
        raise AssertionError(f"kernel library built/loaded after warmup: "
                             f"{stats['kernel_builds']}")
    seen = (seen_a, seen_b, seen_c, seen_d)
    print(f"[4/6] served {len(out)} + {len(single_out)} + {len(shed_out)} "
          f"+ {len(prof_reqs)} requests in {all_batches} batches; oracle "
          f"rtol/atol {RTOL}/{ATOL}: max abs err "
          f"{max(x['max_abs_err'] for x in seen):.3e}; unknown users "
          f"{sum(x['unknown'] for x in seen)}, shed {seen_c['shed']}; "
          f"glmix_margin launches {launches} ({traffic_launches} for "
          f"traffic: one a batch); kernel builds {stats['kernel_builds']}",
          flush=True)
    print(f"[4/6] [{card}] profiled window: {window['batches']} batches, "
          f"device events {window['events']}; kernel time "
          f"{window['kernel_ms']:.4f} ms, copies "
          f"{window['copy_ms']:.4f} ms", flush=True)

    lat = stats_a["latency_seconds"]
    stage_ms = {stage: {q: (None if lat[stage].get(q) is None
                            else lat[stage][q] * 1e3)
                        for q in ("p50", "p99")}
                for stage in ("queue", "assemble", "score", "total")}
    serving = {
        "requests": N_REQUESTS, "batches": batches,
        "seconds": pass_a_s, "requests_per_s": N_REQUESTS / pass_a_s,
        "stage_ms": stage_ms,
        "serve_single_ms": {"p50": float(np.percentile(single_s, 50)) * 1e3,
                            "p99": float(np.percentile(single_s, 99)) * 1e3},
    }
    for stage, q in stage_ms.items():
        print(f"[4/6] [{card}] serving latency {stage}: p50 "
              f"{q['p50']:.4f} ms, p99 {q['p99']:.4f} ms", flush=True)
    print(f"[4/6] [{card}] serving throughput {serving['requests_per_s']:.1f} "
          f"requests/s ({N_REQUESTS} requests, {batches} batches, "
          f"{pass_a_s:.3f}s); serve() single request p50 "
          f"{serving['serve_single_ms']['p50']:.4f} ms, p99 "
          f"{serving['serve_single_ms']['p99']:.4f} ms", flush=True)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return {"launches": launches, "serving": serving, "profiled": window}


def profile_serving(engine, gm, reqs) -> dict:
    """Serve ``reqs`` through submit/pump/drain under torch.profiler and
    hold the device's events to the batches: exactly one
    ``glmix_margin_kernel`` launch, one host-to-device copy and one
    device-to-host copy a batch, nothing else on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = gm.launches
    out = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in reqs:
            refused = engine.submit(r)
            if refused is not None:
                raise AssertionError(f"{r.uid} refused: {refused.fallbacks}")
            if engine.batcher.depth() >= MAX_BATCH:
                out.extend(engine.pump())
        out.extend(engine.drain())
        torch.cuda.synchronize()
    batches = gm.launches - before
    events = {"kernel": 0, "htod": 0, "dtoh": 0}
    other, kernel_ms, copy_ms = {}, 0.0, 0.0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time", None)
        us = evt.cuda_time if us is None else us
        name = evt.name
        if name.startswith("Memcpy HtoD"):
            events["htod"] += 1
            copy_ms += us / 1e3
        elif name.startswith("Memcpy DtoH"):
            events["dtoh"] += 1
            copy_ms += us / 1e3
        elif "glmix_margin_kernel" in name:
            events["kernel"] += 1
            kernel_ms += us / 1e3
        else:
            other[name[:60]] = other.get(name[:60], 0) + 1
    want = {"kernel": batches, "htod": batches, "dtoh": batches}
    if batches < PROFILED_BATCHES or events != want or other:
        raise AssertionError(
            f"profiled serving window: {batches} batches, device events "
            f"{events}, others {other}; want one kernel, one copy in and "
            f"one copy out a batch over >= {PROFILED_BATCHES} batches")
    return {"batches": batches, "events": events, "kernel_ms": kernel_ms,
            "copy_ms": copy_ms, "responses": out}


# ---------------------------------------------------------------------------
# phase 6: kernel times (K3)
# ---------------------------------------------------------------------------


def time_gather_margin(gm, rng, dev, B: int, K: int, D: int, live: int,
                       iters: int, reps: int, replays: int) -> dict:
    """Kernel, plain version and ``F.embedding_bag`` on the same inputs:
    ``live`` real slots per row, the rest pad slots (0, 0.0), as the
    serving assembler packs them. Each is timed twice: in CUDA-graph
    replay (device time per call, the ``ms`` keys) and as back-to-back
    eager calls (what a caller issuing one call at a time sees)."""
    idx = np.zeros((B, K), np.int64)
    val = np.zeros((B, K))
    for_rows = rng.random((B, D)).argsort(axis=1)[:, :live] if live < K \
        else rng.integers(0, D, size=(B, K))
    idx[:, :live] = for_rows[:, :live]
    val[:, :live] = rng.normal(size=(B, live))
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    idx_t, val_t = t(idx, torch.int32), t(val, torch.float32)
    off_t = t(rng.normal(size=B), torch.float32)
    theta_t = t(rng.normal(size=D), torch.float32)
    emb = theta_t[:, None]

    def kernel():
        return gm.gather_margin(idx_t, val_t, off_t, theta_t)

    def plain():
        return gm.gather_margin_reference(idx_t, val_t, off_t, theta_t)

    def library():
        return torch.nn.functional.embedding_bag(
            idx_t, emb, per_sample_weights=val_t, mode="sum")[:, 0] + off_t

    before = gm.launches
    want = plain()
    mag = off_t.abs() + (val_t * theta_t[idx_t.long()]).abs().sum(dim=-1)
    err = check_close(kernel(), want, f"gather_margin timing shape B={B}",
                      mag)
    check_close(library(), want, f"embedding_bag B={B}", mag)
    out = {"B": B, "K": K, "D": D, "live_slots": live, "max_abs_err": err}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        out[key] = graph_ms(fn, reps, replays)
        out["eager_" + key] = time_ms(fn, iters)
    gm.launches = before   # timing launches are not main-path launches
    nbytes = B * K * 8 + B * 8 + D * 4
    flops = 2 * B * K
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    out.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=nbytes)
    return out


def _margin_fns(gm):
    """The C launchers: the one the wrappers call (here with no copies,
    to time the kernel alone on the staged device buffer) and the launch
    floor's (``csrc/launch_floor.cu``), which the port never calls."""
    from photon_tpu_torch.ops import cuda_build

    empty = cuda_build.load_library(FLOOR_KERNEL).empty_margin_launch
    if empty.argtypes is None:
        empty.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p]
        empty.restype = ctypes.c_int
    return gm._bind(cuda_build.load_library(gm.KERNEL)), empty


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def host_ms(fn, iters: int, warm: int = 50) -> dict:
    """p50 / p99 / mean host milliseconds of calls that each wait for
    their own result (perf_counter around each call)."""
    for _ in range(warm):
        fn()
    t = np.empty(iters)
    for i in range(iters):
        t0 = time.perf_counter()
        fn()
        t[i] = time.perf_counter() - t0
    t *= 1e3
    return {"p50": float(np.percentile(t, 50)),
            "p99": float(np.percentile(t, 99)), "mean": float(t.mean())}


def glmix_bound(B: int, K: int, D: int, widths) -> dict:
    """Bytes a call must move (idx, val, off in and out, per coordinate
    ent, sidx, sval and at most K_c table values a row, theta) and its
    flops, against the card's rates."""
    nbytes = (B * K * 8 + B * 8 + sum(B * (4 + k * 12) for k in widths)
              + D * 4)
    return _bound(nbytes, 2 * B * (K + sum(widths)), F32_FLOPS)


def time_glmix_margin(gm, rng, dev, B: int, K: int, D: int, live: int,
                      widths, entities: int, reps: int, replays: int,
                      iters: int) -> dict:
    """The fused kernel alone (on the staged device buffer), its plain
    version, ``F.embedding_bag`` for the fixed term, and the parent's
    chain (K3's launch, then per coordinate ``index_select``, ``gather``,
    multiply, sum, add: what its scorer ran after its copies), on the
    same inputs, in CUDA-graph replay and eager. The eager kernel time is
    the wrapper's whole call: copy in, launch, copy out, wait."""
    import torch.nn.functional as Fn

    theta = torch.as_tensor(rng.normal(size=D), dtype=torch.float32,
                            device=dev)
    tables = [torch.as_tensor(np.concatenate(
        [rng.normal(size=(entities, k)), np.zeros((1, k))]),
        dtype=torch.float32, device=dev) for k in widths]
    state = gm.MarginState(theta, tables, K)
    full = bool(widths)
    fill_margin(rng, state, B, full, live=live, stray=False)
    before = gm.launches
    got = gm.glmix_margin(state, B, full)
    idx, val, off, coords = state.arrays(state.dev, B, full)
    want = margin_reference(gm, state, state.host, B, full)
    mag = margin_reference(gm, state, state.host, B, full, magnitude=True)
    what = f"B={B} K={K} D={D} slot widths {widths}"
    err = check_close(got, want, f"glmix_margin timing shape {what}", mag)
    launch, _ = _margin_fns(gm)
    _, i_ptr, v_ptr, o_ptr, desc, n = state.launch_args(B, full)
    dptr, out_ptr = state.dev.data_ptr(), state.out.data_ptr()

    def kernel():
        _raise_on(launch(None, dptr, 0, i_ptr, v_ptr, o_ptr,
                         theta.data_ptr(), desc, n, out_ptr, None, B, K, D,
                         torch.cuda.current_stream().cuda_stream),
                  "glmix_margin kernel")

    def plain():
        return margin_reference(gm, state, state.dev, B, full)

    emb = theta[:, None]

    def library():
        return Fn.embedding_bag(idx, emb, per_sample_weights=val,
                                mode="sum")[:, 0] + off

    ents = [c[0].long() for c in coords]
    sidxs = [c[1].long() for c in coords]

    def chain():
        total = gm.gather_margin(idx, val, off, theta)
        for t, e, s, c in zip(tables, ents, sidxs, coords):
            total = total + (c[2] * torch.gather(t.index_select(0, e), 1,
                                                 s)).sum(dim=-1)
        return total

    kernel()
    check_close(state.out[:B], want, f"glmix_margin kernel alone {what}",
                mag)
    check_close(chain(), want, f"parent chain {what}", mag)
    check_close(library(), margin_reference(gm, state, state.host, B,
                                            False),
                f"embedding_bag {what}",
                margin_reference(gm, state, state.host, B, False, True))
    out = {"B": B, "K": K, "D": D, "live_slots": live,
           "slot_widths": list(widths), "max_abs_err": err,
           "library_ms": None, "eager_library_ms": None}
    out["ms"] = graph_ms(kernel, reps, replays)
    out["kernel_only_eager_ms"] = time_ms(kernel, iters)
    out["eager_ms"] = time_ms(lambda: gm.glmix_margin(state, B, full),
                              iters)
    for key, fn in (("plain_ms", plain), ("embedding_bag_fixed_ms", library),
                    ("parent_chain_ms", chain)):
        out[key] = graph_ms(fn, reps, replays)
        out["eager_" + key] = time_ms(fn, iters)
    gm.launches = before   # timing launches are not main-path launches
    out.update(glmix_bound(B, K, D, widths))
    return out


def time_launch_floor(gm, rng, dev, iters: int) -> dict:
    """At the serving bucket (B 64, the serving model's layout: K_f 256,
    one coordinate of 8 slots): the empty kernel on the same grid in
    graph replay, and one C-call round trip around it (copy in, empty
    kernel, copy out, the wait), the result copied back into pinned
    memory by the call itself or by ``.cpu()`` after it, taken in turns;
    beside them the fused wrapper's own call on the same batch."""
    theta = torch.zeros(D_GLOBAL, device=dev)
    state = gm.MarginState(theta, [torch.zeros(N_USERS + 1, K_USER,
                                               device=dev)], 256)
    B = MAX_BATCH
    fill_margin(rng, state, B, True, live=NNZ, stray=False)
    _, empty = _margin_fns(gm)
    dptr, out_ptr = state.dev.data_ptr(), state.out.data_ptr()
    host, host_out = state.host.data_ptr(), state.host_out.data_ptr()
    nbytes = state.launch_args(B, True)[0]
    done = torch.cuda.Event()
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def empty_kernel():
        _raise_on(empty(None, dptr, 0, out_ptr, None, B, stream()), "empty")

    def pinned():
        _raise_on(empty(host, dptr, nbytes, out_ptr, host_out, B, stream()),
                  "empty round trip")
        done.record()
        done.synchronize()

    def cpu():
        _raise_on(empty(host, dptr, nbytes, out_ptr, None, B, stream()),
                  "empty round trip")
        state.out[:B].cpu()

    before = gm.launches
    out = {"B": B, "bytes_in": nbytes,
           "empty_graph_ms": graph_ms(empty_kernel, 200, 20)}
    turns = {"round_trip_pinned": [], "round_trip_cpu": []}
    for key, fn in (("round_trip_pinned", pinned), ("round_trip_cpu", cpu),
                    ("round_trip_cpu", cpu), ("round_trip_pinned", pinned)):
        turns[key].append(host_ms(fn, iters // 2))
    for key, runs in turns.items():
        out[key] = {q: float(np.mean([r[q] for r in runs]))
                    for q in ("p50", "p99", "mean")}
    out["glmix_margin_call"] = host_ms(
        lambda: gm.glmix_margin(state, B, True), iters)
    gm.launches = before
    return out


def time_scorer(rng, iters: int) -> dict:
    """``scorer.dispatch(model, mode, args)`` through to the host result,
    p50 / p99 over ``iters`` back-to-back calls in each mode, and over
    ``iters / 4`` calls each after a batch's assembly, on a DeviceResidentModel
    of the serving width staged on the card, one batch of 64 requests
    (the same public call on any tree of the port; its scores are held
    to the float64 oracle first)."""
    from photon_tpu_torch.serving import ServingConfig, ServingEngine
    from photon_tpu_torch.serving import scorer

    model_dir = os.path.join(WORK_DIR, "scorer_model")
    shutil.rmtree(model_dir, ignore_errors=True)
    theta, coef, proj = write_model(model_dir, rng)
    engine = ServingEngine.from_model_dir(
        model_dir, ServingConfig(max_batch=MAX_BATCH))
    engine.warmup()
    model = engine.model
    reqs = make_requests(rng, "t", MAX_BATCH)
    out = {}
    for mode in ("full", "fixed_only"):
        args, _, _ = model.assemble(reqs, MAX_BATCH,
                                    shed_random=mode != "full")
        scores = scorer.dispatch(model, mode, args).cpu().numpy()
        for r, got in zip(reqs, scores):
            want = oracle(r, theta, coef, proj, with_random=mode == "full")
            if abs(got - want) > ATOL + RTOL * abs(want):
                raise AssertionError(f"scorer.dispatch {mode} {r.uid}: "
                                     f"{got} vs oracle {want}")
        out[mode] = host_ms(lambda: scorer.dispatch(model, mode, args).cpu(),
                            iters)
        # the engine's cadence: each call after a batch's host assembly
        # (~2 ms of Python, the card idle meanwhile), only the call timed
        t = np.empty(iters // 4)
        for i in range(len(t)):
            model.assemble(reqs, MAX_BATCH, shed_random=mode != "full")
            t0 = time.perf_counter()
            scorer.dispatch(model, mode, args).cpu()
            t[i] = (time.perf_counter() - t0) * 1e3
        out[mode + " after assemble"] = {
            "p50": float(np.percentile(t, 50)),
            "p99": float(np.percentile(t, 99)), "mean": float(t.mean())}
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return out


def time_serving(gm, rng, dev, card: str) -> dict:
    """Phase 6 for the serving margin: K3's fixed-term wrapper at the
    serving and throughput shapes, the fused kernel (where the tree has
    it) at the serving shape and the throughput shape with and without a
    coordinate, the launch floor, and the scorer's dispatch."""
    out = {"k3": [time_gather_margin(gm, rng, dev, 64, 256, D_GLOBAL, NNZ,
                                     iters=2000, reps=200, replays=20),
                  time_gather_margin(gm, rng, dev, 65_536, 256, 4_096, 256,
                                     iters=50, reps=10, replays=5)]}
    for label, r in zip(("serving", "throughput"), out["k3"]):
        print(f"[6/6] [{card}] gather_margin (K3, fixed term) {label} shape "
              f"B={r['B']} K={r['K']} D={r['D']}, ms per call, graph replay "
              f"(eager): kernel {r['ms']:.5f} ({r['eager_ms']:.5f}), plain "
              f"{r['plain_ms']:.5f} ({r['eager_plain_ms']:.5f}), "
              f"embedding_bag {r['library_ms']:.5f} "
              f"({r['eager_library_ms']:.5f}); bound {r['bound_ms']:.6f} "
              f"({r['bound_by']}, {r['bytes']} bytes at 3.35 TB/s)",
              flush=True)
    if hasattr(gm, "glmix_margin"):
        out["fused"] = [
            time_glmix_margin(gm, rng, dev, 64, 256, D_GLOBAL, NNZ,
                              (K_USER,), N_USERS, reps=200, replays=20,
                              iters=2000),
            time_glmix_margin(gm, rng, dev, 65_536, 256, 4_096, 256, (),
                              0, reps=10, replays=5, iters=20),
            time_glmix_margin(gm, rng, dev, 65_536, 256, 4_096, 256,
                              (K_USER,), N_USERS, reps=10, replays=5,
                              iters=20)]
        for r in out["fused"]:
            print(f"[6/6] [{card}] glmix_margin (fused) B={r['B']} K={r['K']} "
                  f"D={r['D']} slot widths {r['slot_widths']}, ms per call, "
                  f"graph replay (eager): kernel {r['ms']:.5f} "
                  f"({r['kernel_only_eager_ms']:.5f}; the wrapper's call "
                  f"with its copies and wait {r['eager_ms']:.5f}), plain "
                  f"{r['plain_ms']:.5f} ({r['eager_plain_ms']:.5f}), "
                  f"parent chain {r['parent_chain_ms']:.5f} "
                  f"({r['eager_parent_chain_ms']:.5f}), embedding_bag "
                  f"fixed term {r['embedding_bag_fixed_ms']:.5f} "
                  f"({r['eager_embedding_bag_fixed_ms']:.5f}); bound "
                  f"{r['bound_ms']:.6f} ({r['bound_by']}, {r['bytes']} "
                  f"bytes at 3.35 TB/s)", flush=True)
        f = out["floor"] = time_launch_floor(gm, rng, dev, iters=2000)
        print(f"[6/6] [{card}] launch floor B={f['B']}: empty kernel "
              f"{f['empty_graph_ms']:.5f} ms in graph replay; C-call round "
              f"trip ({f['bytes_in']} bytes in, empty kernel, copy out, "
              f"wait) p50 {f['round_trip_pinned']['p50']:.5f} ms p99 "
              f"{f['round_trip_pinned']['p99']:.5f} (result back by .cpu(): "
              f"p50 {f['round_trip_cpu']['p50']:.5f} p99 "
              f"{f['round_trip_cpu']['p99']:.5f}); glmix_margin call p50 "
              f"{f['glmix_margin_call']['p50']:.5f} p99 "
              f"{f['glmix_margin_call']['p99']:.5f}", flush=True)
    out["scorer"] = time_scorer(rng, iters=2000)
    for mode, q in out["scorer"].items():
        print(f"[6/6] [{card}] scorer.dispatch {mode} B={MAX_BATCH} to the "
              f"host result: p50 {q['p50']:.5f} ms, p99 {q['p99']:.5f}, "
              f"mean {q['mean']:.5f}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3 (continued): the fused value+gradient kernels K1 (dense) and K2
# (ELL) against their plain versions
# ---------------------------------------------------------------------------


def _labels(loss_name: str, n: int, g: torch.Generator, dev):
    if loss_name == "poisson":
        return torch.randint(0, 6, (n,), generator=g, device=dev).float()
    if loss_name == "squared":
        return torch.randn(n, generator=g, device=dev)
    return (torch.rand(n, generator=g, device=dev) < 0.4).float()


def _row_vectors(variant: int, n: int, g: torch.Generator, dev):
    """(offsets, weights): both given, both None, or weights with every
    third row at zero weight."""
    if variant == 1:
        return None, None
    off = torch.randn(n, generator=g, device=dev) * 0.2
    w = torch.rand(n, generator=g, device=dev) + 0.1
    if variant == 2:
        w[::3] = 0.0
    return off, w


def _vg_scales(loss, margins: torch.Tensor, margin_mag: torch.Tensor, y,
               off, w, feat_abs_t):
    """Magnitude sums the value and gradient are held to. A reordered f32
    sum errs relative to the sum of its terms' magnitudes, not to a
    result that may have cancelled; and each row's margin, itself such a
    sum (``margin_mag`` = |x_i|.|coef| + |off_i|), passes its error on
    through l' to the value and through l'' to the gradient. So
    value: sum_i |w_i| (|l_i| + |l'_i| M_i), gradient:
    |X|^T (|w| (|l'| + |l''| M)). ``feat_abs_t(v)`` gives |X|^T v."""
    z = margins if off is None else margins + off
    mag = margin_mag if off is None else margin_mag + off.abs()
    l, dz = loss.loss_and_dz(z, y)
    h = loss.d2z(z, y).abs()
    wa = torch.ones_like(z) if w is None else w.abs()
    return ((wa * (l.abs() + dz.abs() * mag)).sum().reshape(()),
            feat_abs_t(wa * (dz.abs() + h * mag)))


def _scaled_err(got, want, scale) -> float:
    """max |got - want| / scale over the entries with scale > 0."""
    err = (got.double() - want.double()).abs().reshape(-1)
    s = scale.double().reshape(-1)
    keep = s > 0
    return float((err[keep] / s[keep]).max()) if bool(keep.any()) else 0.0


def _check_vg(name, got, again, want, scales, what,
              rtol: float = VG_RTOL):
    """Value and gradient against the plain version; ``again`` (a second
    launch on the same inputs) must equal ``got`` bit for bit. Returns
    the max abs err and the max err relative to the magnitude sums."""
    err = max(check_close(got[0].reshape(1), want[0].reshape(1),
                          f"{name} value {what}", scales[0].reshape(1),
                          rtol=rtol),
              check_close(got[1], want[1], f"{name} grad {what}", scales[1],
                          rtol=rtol))
    if again is not None and not (torch.equal(got[0], again[0])
                                  and torch.equal(got[1], again[1])):
        raise AssertionError(f"{name} {what}: second launch is not bitwise "
                             f"equal")
    ratio = max(_scaled_err(got[0], want[0], scales[0]),
                _scaled_err(got[1], want[1], scales[1]))
    return err, ratio


def _dense_case(fvg, loss, x, g, dev, variant, what):
    """One K1 case on features ``x``: labels, vectors and coef drawn here;
    the kernel twice (bitwise) against the plain version."""
    n, d = x.shape
    y = _labels(loss.name, n, g, dev)
    off, w = _row_vectors(variant, n, g, dev)
    coef = torch.randn(d, generator=g, device=dev) * (0.5 / d ** 0.5)
    got = fvg.fused_dense_value_grad(loss, x, y, off, w, coef)
    again = fvg.fused_dense_value_grad(loss, x, y, off, w, coef)
    want = fvg.fused_dense_value_grad_reference(loss, x, y, off, w, coef)
    xa = x.float().abs()
    scales = _vg_scales(loss, x.float() @ coef, xa @ coef.abs(), y, off, w,
                        lambda v: v @ xa)
    return _check_vg("K1", got, again, want, scales,
                     f"loss={loss.name} {what} x={x.dtype} "
                     f"vectors={variant}")


def check_fused_dense(fvg, losses, g, dev):
    worst, worst_ratio, cases = 0.0, (0.0, ""), 0

    def run(loss, x, what):
        nonlocal worst, worst_ratio, cases
        err, ratio = _dense_case(fvg, loss, x, g, dev, cases % 3, what)
        worst = max(worst, err)
        worst_ratio = max(worst_ratio, (ratio, f"loss={loss.name} {what}"))
        cases += 1

    for loss in losses:
        for d in VG_DENSE_DS:
            for n in VG_DENSE_NS:
                for xdt in (torch.float32, torch.bfloat16):
                    x = torch.randn(n, d, generator=g, device=dev).to(xdt)
                    run(loss, x, f"n={n} d={d}")
        # X whose base is not on a 16-byte boundary: rows of an intercept
        # width (big[1:]) and rows of an aligned width shifted by one
        # element (both take the element-a-lane pieces)
        for n in (1, VG_TILE + 1, 8449):
            for xdt in (torch.float32, torch.bfloat16):
                big = torch.randn(n + 1, 1025, generator=g,
                                  device=dev).to(xdt)
                run(loss, big[1:], f"n={n} d=1025 base+1 row")
                flat = torch.randn(n * 1024 + 1, generator=g,
                                   device=dev).to(xdt)
                run(loss, flat[1:].view(n, 1024), f"n={n} d=1024 base+1 "
                    f"element")
    return worst, worst_ratio, cases


def _ell_case(n, k, d, vdt, g, dev):
    """ELL rows with ~25% pad slots (0, 0.0), every fifth row all pads
    (an empty segment), duplicate ids in half the rows (also across
    32-slot pieces where K > 32), and ~5% of ids outside [0, D) (which
    add 0)."""
    idx = torch.randint(0, max(d, 1), (n, k), generator=g, device=dev)
    val = torch.randn(n, k, generator=g, device=dev) / max(k, 1) ** 0.5
    if k:
        pad = torch.rand(n, k, generator=g, device=dev) < 0.25
        pad[::5] = True
        idx[pad], val[pad] = 0, 0.0
        stray = torch.rand(n, k, generator=g, device=dev) < 0.05
        idx[stray] = torch.where(
            torch.rand(n, k, generator=g, device=dev)[stray] < 0.5,
            torch.tensor(-1, device=dev), torch.tensor(d, device=dev))
    if k > 1:
        idx[1::2, 1] = idx[1::2, 0]
    if k > 32:
        idx[1::2, k - 1] = idx[1::2, 0]
    return idx.to(torch.int32).contiguous(), val.to(vdt).contiguous()


def _ell_abs_t(idx, val, d):
    """v -> |X|^T v over ELL rows, ids outside [0, D) dropped."""
    cols = idx.long()
    keep = (cols >= 0) & (cols < d)
    vals = torch.where(keep, val.float().abs(), torch.zeros((), device=cols.device))

    def f(v):
        out = torch.zeros(d, device=v.device)
        return out.index_add_(0, cols.clamp(0, max(d - 1, 0)).reshape(-1),
                              (vals * v[:, None]).reshape(-1))
    return f


def _ell_margins(idx, val, coef):
    d = coef.shape[0]
    cols = idx.long()
    keep = (cols >= 0) & (cols < d)
    gathered = coef[cols.clamp(0, max(d - 1, 0))] if d else \
        torch.zeros_like(val.float())
    return torch.where(keep, val.float() * gathered,
                       torch.zeros((), device=idx.device)).sum(dim=-1)


def check_fused_sparse(fvg, losses, g, dev):
    from photon_tpu_torch.ops.features import SparseFeatures

    worst, worst_ratio, cases = 0.0, (0.0, ""), 0

    def run(loss, idx, val, d, what):
        nonlocal worst, worst_ratio, cases
        variant = cases % 3
        n = idx.shape[0]
        x = SparseFeatures(idx, val)
        y = _labels(loss.name, n, g, dev)
        off, w = _row_vectors(variant, n, g, dev)
        coef = torch.randn(d, generator=g, device=dev) * 0.5
        got = fvg.fused_sparse_value_grad(loss, x, y, off, w, coef)
        again = fvg.fused_sparse_value_grad(loss, x, y, off, w, coef)
        want = fvg.fused_sparse_value_grad_reference(loss, x, y, off, w,
                                                     coef)
        scales = _vg_scales(loss, _ell_margins(idx, val, coef),
                            _ell_margins(idx, val.abs(), coef.abs()), y, off,
                            w, _ell_abs_t(idx, val, d))
        what = (f"loss={loss.name} {what} d={d} values={val.dtype} "
                f"vectors={variant}")
        err, ratio = _check_vg("K2", got, again, want, scales, what)
        worst = max(worst, err)
        worst_ratio = max(worst_ratio, (ratio, what))
        cases += 1

    vdts = (torch.float32, torch.bfloat16)
    for loss in losses:
        for d in (1, 2048, 4096):
            warps = 8 if d <= 2048 else 4
            # 0, 1, a tile +- 1, a warp's run +- 1, a block's step +- 1,
            # and at D = 2048 and 4096 the grid's step +- 1 (at D = 1 all
            # the terms of so many rows go into one column, where the plain
            # version's own f32 index_add_ rounding was read past the limit
            # at 676K terms)
            block = warps * K2_RUN
            ns = [0, 1, VG_TILE - 1, VG_TILE + 1, K2_RUN - 1, K2_RUN + 1,
                  block - 1, block + 1, 8453]
            if d > 1:
                ns += [VG_GRID * block - 1, VG_GRID * block + 1]
            # K > 32: a row in several 32-slot pieces
            for k in (0, 5, 32, 33, 64):
                for n in dict.fromkeys(ns):
                    for vdt in vdts:
                        idx, val = _ell_case(n, k, d, vdt, g, dev)
                        run(loss, idx, val, d, f"n={n} k={k}")
        for k in (5, 32, 33):
            # two block steps + 1 and the grid's step + 1 (4 warps a block)
            for n in (2 * 4 * K2_RUN + 1, VG_GRID * 4 * K2_RUN + 1):
                for vdt in vdts:
                    # every entry of every row in one column
                    idx, val = _ell_case(n, k, 4096, vdt, g, dev)
                    idx = torch.full_like(idx, 1234)
                    run(loss, idx, val, 4096, f"n={n} k={k} one column")
                    # Zipf-skewed columns
                    idx = zipf_columns(n, k, 4096, g, dev)
                    run(loss, idx, val, 4096, f"n={n} k={k} zipf")
    return worst, worst_ratio, cases


# ---------------------------------------------------------------------------
# phase 5: the training main path
# ---------------------------------------------------------------------------


def _counts():
    from photon_tpu_torch.ops import aggregators as agg
    from photon_tpu_torch.ops import fused_value_grad as fvg

    return fvg.dense_launches, fvg.sparse_launches, agg.two_pass_cuda


def _fit(what: str, fn, kernel: str):
    """Run one fit, timed on the host clock to a synchronize, and hold its
    kernel launches to its objective evaluations: every evaluation of an
    f32 fit is one launch of ``kernel`` and none is two-pass."""
    c0 = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    results = out[1] if isinstance(out[1], dict) else {None: out[1]}
    evals = sum(r.num_fun_evals for r in results.values())
    dense, sparse, two_pass = (b - a for a, b in zip(c0, _counts()))
    want = {"K1": (evals, 0), "K2": (0, evals)}[kernel]
    if (dense, sparse) != want or two_pass != 0:
        raise AssertionError(
            f"{what}: {evals} evaluations but K1 launches {dense}, K2 "
            f"launches {sparse}, two-pass evaluations {two_pass}")
    return out, seconds, evals


def _against_oracle(what, limits, coef, obj64, batch64, lam, oracle_model,
                    oracle_res):
    from photon_tpu_torch.function.objective import Hyper

    f_fit = float(obj64.value(coef.double(), batch64, Hyper.of(lam)))
    f_opt = float(oracle_res.value)
    gap = (f_fit - f_opt) / abs(f_opt)
    want = oracle_model.coefficients.means
    rel = float(torch.linalg.vector_norm(coef.double() - want)
                / torch.linalg.vector_norm(want))
    f_rel, coef_rel = ORACLE_LIMITS[limits]
    if not (abs(gap) <= f_rel and rel <= coef_rel):
        raise AssertionError(
            f"{what}: objective gap {gap:.3e} (bound {f_rel}), coef rel L2 "
            f"err {rel:.3e} (bound {coef_rel}) against the float64 oracle")
    return {"objective_rel_gap": gap, "coef_rel_err": rel}


def profile_solve(run, warm_s: float) -> dict:
    """One more warm solve under torch.profiler: device time by kernel and
    the device's busy share (summed kernel time over the unprofiled warm
    wall time). Returns {} where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_kernel: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "device_time", None)
            if us is None:
                us = evt.cuda_time
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + us / 1e3
    if not by_kernel:
        return {}
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (warm_s * 1e3),
            "kernels": {name[:60]: ms for name, ms in top}}


def train_dense_lbfgs(seed: int, dev, card: str):
    """bench.py::config_fe_throughput, accelerator arm: 1,000,000 x 1024
    f32 logistic, L2 1.0, 40 iterations at tolerance 0; cold then warm,
    then the same with bf16 storage; each checked against a float64
    solve of its own data. Returns the f32 and bf16 features and the
    labels, which phase 6 times K1 on."""
    from photon_tpu_torch.data.dataset import DataBatch
    from photon_tpu_torch.function.objective import (GLMObjective,
                                                     L2Regularization)
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.optim.problem import (
        GLMOptimizationConfiguration, GlmOptimizationProblem,
        OptimizerConfig)
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    n, d = FE_N, FE_D
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=dev)
    w_true = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = (torch.rand(n, generator=g, device=dev)
         < torch.sigmoid(x @ w_true)).float()
    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=40, tolerance=0.0),
        regularization=L2Regularization, regularization_weight=1.0)
    cfg64 = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=500, tolerance=1e-12),
        regularization=L2Regularization, regularization_weight=1.0)
    problem = GlmOptimizationProblem(task, cfg)
    obj64 = GLMObjective(LogisticLoss)
    features = {}
    for storage, fdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        batch = DataBatch.from_numpy(x, y, device=dev, feature_dtype=fdt)
        run = lambda: problem.run(batch, dim=d, device=dev)
        _, cold_s, _ = _fit(f"dense L-BFGS {storage} cold", run, "K1")
        (model, res), warm_s, evals = _fit(f"dense L-BFGS {storage} warm",
                                           run, "K1")
        trace = profile_solve(run, warm_s)
        nbytes = n * d * batch.features.element_size() + n * 4 + d * 8
        batch64 = DataBatch(batch.features.double(), y.double())
        oracle_model, oracle_res = GlmOptimizationProblem(
            task, cfg64).run(batch64, dim=d, regularization_weight=1.0,
                             device=dev)
        check = _against_oracle(f"dense L-BFGS {storage}",
                                f"dense {storage}", model.coefficients.means, obj64, batch64,
                                1.0, oracle_model, oracle_res)
        del batch64
        torch.cuda.empty_cache()
        bytes_per_s = evals * nbytes / warm_s
        print(f"[5/6] [{card}] dense L-BFGS {storage} {n}x{d}: warm "
              f"{warm_s:.4f}s (cold {cold_s:.4f}s), {evals} evaluations = "
              f"{evals} K1 launches, {res.iterations} iterations, reason "
              f"{res.reason}; {n * evals / warm_s:.4e} samples/s, "
              f"{warm_s / evals * 1e3:.4f} ms per evaluation, "
              f"{bytes_per_s / 1e9:.1f} GB/s "
              f"({bytes_per_s / HBM_BYTES_PER_S:.3f} of 3.35 TB/s); host syncs {res.host_syncs} per solve; float64 "
              f"oracle ({oracle_res.iterations} iterations): objective gap "
              f"{check['objective_rel_gap']:.3e}, coef rel err "
              f"{check['coef_rel_err']:.3e}", flush=True)
        if trace:
            print(f"[5/6] [{card}] dense L-BFGS {storage} profiled warm "
                  f"solve: device busy {trace['device_busy_ms']:.4f} ms "
                  f"= {trace['device_busy_share']:.3f} of the unprofiled "
                  f"warm wall time; top kernels (ms): "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in trace["kernels"].items()),
                  flush=True)
        else:
            print(f"[5/6] dense L-BFGS {storage}: the profiler recorded no "
                  f"device time; busy share not measured", flush=True)
        features[storage] = batch.features
    return features, y


def train_ell_path(seed: int, dev, card: str) -> None:
    """run_fused_bench's full shape (bench.py:3615-3619): 65,536 ELL rows
    x 32 slots over D=2048, logistic, through
    train_generalized_linear_model over lambda 10, 1, 0.1 with warm
    starts; each lambda checked against a float64 solve."""
    from photon_tpu_torch.data.dataset import DataBatch
    from photon_tpu_torch.estimators.model_training import \
        train_generalized_linear_model
    from photon_tpu_torch.function.objective import (GLMObjective,
                                                     L2Regularization)
    from photon_tpu_torch.ops.features import SparseFeatures
    from photon_tpu_torch.ops.losses import LogisticLoss
    from photon_tpu_torch.optim.problem import (
        GLMOptimizationConfiguration, GlmOptimizationProblem,
        OptimizerConfig)
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    n, k, d = ELL_N, ELL_K, ELL_D
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    idx = torch.randint(0, d, (n, k), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.randn(n, k, generator=g, device=dev) / k ** 0.5
    w_true = torch.randn(d, generator=g, device=dev)
    margins = (val * w_true[idx.long()]).sum(dim=-1)
    y = (torch.rand(n, generator=g, device=dev)
         < torch.sigmoid(margins)).float()
    batch = DataBatch.from_numpy(SparseFeatures(idx, val), y, device=dev)
    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=100, tolerance=1e-7),
        regularization=L2Regularization)
    cfg64 = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=1000, tolerance=1e-12),
        regularization=L2Regularization)
    (models, stats), seconds, evals = _fit(
        "ELL L-BFGS lambda path",
        lambda: train_generalized_linear_model(
            task, batch, d, cfg, regularization_weights=ELL_LAMBDAS,
            device=dev), "K2")
    batch64 = DataBatch(SparseFeatures(idx, val.double()), y.double())
    obj64 = GLMObjective(LogisticLoss)
    for lam in ELL_LAMBDAS:
        om, ores = GlmOptimizationProblem(task, cfg64).run(
            batch64, dim=d, regularization_weight=lam, device=dev)
        check = _against_oracle(f"ELL L-BFGS lambda={lam}", "ELL",
                                models[lam].coefficients.means, obj64,
                                batch64, lam, om, ores)
        r = stats[lam]
        print(f"[5/6] [{card}] ELL L-BFGS n={n} K={k} D={d} lambda={lam}: "
              f"{r.num_fun_evals} evaluations, {r.iterations} iterations, "
              f"reason {r.reason}, host syncs {r.host_syncs}; float64 "
              f"oracle: objective gap {check['objective_rel_gap']:.3e}, "
              f"coef rel err {check['coef_rel_err']:.3e}", flush=True)
    print(f"[5/6] [{card}] ELL lambda path: {seconds:.4f}s, {evals} "
          f"evaluations = {evals} K2 launches, "
          f"{n * evals / seconds:.4e} samples/s", flush=True)


def _flagship_fixed_effect(n: int, g: torch.Generator, dev):
    """bench.py:484-516's generator on the card: global features
    N(0, 1/256), the per-user term (1,000 users x 4 features) folded into
    the labels."""
    xg = torch.randn(n, NEWTON_D, generator=g, device=dev) / NEWTON_D ** 0.5
    users = torch.randint(0, 1_000, (n,), generator=g, device=dev)
    xu = torch.randn(n, 4, generator=g, device=dev)
    return xg, users, xu


def train_newton(seed: int, dev, card: str) -> None:
    """The flagship's fixed-effect width (bench.py:503-505, :541-553):
    100,000 x 256 logistic, NEWTON, L2 1.0, tolerance 1e-5; scored on a
    20,000-row validation set. Held against scipy's L-BFGS-B in float64
    numpy on the same row-sum objective."""
    import numpy as np
    from scipy.optimize import minimize

    from photon_tpu_torch.data.dataset import DataBatch
    from photon_tpu_torch.evaluation.evaluators import auc
    from photon_tpu_torch.function.objective import L2Regularization
    from photon_tpu_torch.optim.problem import (
        GLMOptimizationConfiguration, GlmOptimizationProblem,
        OptimizerConfig)
    from photon_tpu_torch.types import OptimizerType, TaskType

    task = TaskType.LOGISTIC_REGRESSION
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    w_g = torch.randn(NEWTON_D, generator=g, device=dev)
    w_u = torch.randn(1_000, 4, generator=g, device=dev) * 1.5

    def make(n):
        xg, users, xu = _flagship_fixed_effect(n, g, dev)
        logits = xg @ w_g + (xu * w_u[users]).sum(dim=-1)
        y = (torch.rand(n, generator=g, device=dev)
             < torch.sigmoid(logits)).float()
        return xg, y

    x, y = make(NEWTON_N)
    xv, yv = make(NEWTON_N_VAL)
    cfg = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType.NEWTON,
                                  max_iterations=100, tolerance=1e-5),
        regularization=L2Regularization, regularization_weight=1.0)
    batch = DataBatch.from_numpy(x, y, device=dev)
    problem = GlmOptimizationProblem(task, cfg)
    (model, res), seconds, evals = _fit(
        "dense NEWTON",
        lambda: problem.run(batch, dim=NEWTON_D, device=dev), "K1")
    coef = model.coefficients.means

    xh = x.double().cpu().numpy()
    yh = y.double().cpu().numpy()

    def fun(wv):
        z = xh @ wv
        f = np.sum(np.logaddexp(0.0, z) - yh * z) + 0.5 * wv @ wv
        return f, xh.T @ (1.0 / (1.0 + np.exp(-z)) - yh) + wv

    t0 = time.perf_counter()
    sp_res = minimize(fun, np.zeros(NEWTON_D), jac=True, method="L-BFGS-B",
                      options={"maxiter": 5000, "gtol": 1e-10,
                               "ftol": 1e-15})
    scipy_s = time.perf_counter() - t0
    w_sp = torch.from_numpy(sp_res.x).to(dev)
    rel = float(torch.linalg.vector_norm(coef.double() - w_sp)
                / torch.linalg.vector_norm(w_sp))
    auc_fit = float(auc(xv @ coef, yv))
    auc_sp = float(auc(xv.double() @ w_sp, yv.double()))
    if rel > NEWTON_COEF_REL or abs(auc_fit - auc_sp) > AUC_BAR:
        raise AssertionError(
            f"dense NEWTON: coef rel err {rel:.3e} (bound "
            f"{NEWTON_COEF_REL}), validation AUC {auc_fit:.5f} vs scipy "
            f"{auc_sp:.5f} (bar {AUC_BAR})")
    print(f"[5/6] [{card}] dense NEWTON {NEWTON_N}x{NEWTON_D}: {seconds:.4f}s, "
          f"{res.iterations} iterations, {evals} evaluations = {evals} K1 "
          f"launches, reason {res.reason}, host syncs {res.host_syncs}; "
          f"scipy L-BFGS-B float64 ({sp_res.nit} iterations, "
          f"{scipy_s:.2f}s on the host): coef rel err {rel:.3e}; validation "
          f"AUC {auc_fit:.5f} vs scipy {auc_sp:.5f}", flush=True)


def training_main_path(seed: int, dev, card: str) -> dict:
    from photon_tpu_torch.ops import aggregators as agg
    from photon_tpu_torch.ops import fused_value_grad as fvg

    # the main path's launch counts: from zero, just before training
    fvg.dense_launches = fvg.sparse_launches = 0
    agg.reset_counts()
    dense_inputs = train_dense_lbfgs(seed, dev, card)
    train_ell_path(seed, dev, card)
    train_newton(seed, dev, card)
    launches = {"K1": fvg.dense_launches, "K2": fvg.sparse_launches}
    print(f"[5/6] training main path: K1 launches {launches['K1']}, K2 "
          f"launches {launches['K2']}; two-pass evaluations on the card "
          f"{agg.two_pass_cuda}, all of them float64 oracle solves",
          flush=True)
    return {"launches": launches, "dense_inputs": dense_inputs}


# ---------------------------------------------------------------------------
# phase 6: K1 / K2 times
# ---------------------------------------------------------------------------


def _time_three(fns, reps, replays, iters) -> dict:
    out = {}
    for key, fn in fns.items():
        out[key] = graph_ms(fn, reps, replays)
        out["eager_" + key] = time_ms(fn, iters, warm=2)
    return out


def _bound(nbytes: int, flops: int, f_rate: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / f_rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def time_fused_dense(fvg, x, y, g, dev) -> dict:
    """K1, its plain version, and two cuBLAS GEMVs with the logistic loss
    between them, on ``x`` with offsets and weights."""
    import torch.nn.functional as Fn

    from photon_tpu_torch.ops.losses import LogisticLoss

    n, d = x.shape
    off = torch.randn(n, generator=g, device=dev) * 0.2
    w = torch.rand(n, generator=g, device=dev) + 0.5
    coef = torch.randn(d, generator=g, device=dev) / d ** 0.5
    coef_lib = coef.to(x.dtype)

    def kernel():
        return fvg.fused_dense_value_grad(LogisticLoss, x, y, off, w, coef)

    def plain():
        return fvg.fused_dense_value_grad_reference(LogisticLoss, x, y, off,
                                                    w, coef)

    def library():
        z = torch.mv(x, coef_lib).float() + off
        r = w * (torch.sigmoid(z) - y)
        value = (w * (Fn.softplus(z) - y * z)).sum()
        return value, torch.mv(x.t(), r.to(x.dtype)).float()

    before = fvg.dense_launches
    want = plain()
    xa = x.float().abs()
    scales = _vg_scales(LogisticLoss, x.float() @ coef, xa @ coef.abs(), y,
                        off, w, lambda v: v @ xa)
    del xa
    got, again = kernel(), kernel()
    err, ratio = _check_vg("K1", got, again, want, scales,
                           f"timing shape {n}x{d} {x.dtype}")
    # the yardstick computes the same function (its bf16 GEMV rounds coef
    # and r to bf16, hence the wider bound there)
    _check_vg("cuBLAS GEMVs", library(), None, want, scales, f"{n}x{d}",
              rtol=VG_RTOL if x.dtype == torch.float32 else 1e-2)
    out = {"n": n, "d": d, "storage": str(x.dtype).replace("torch.", ""),
           "max_abs_err": err, "max_scaled_err": ratio,
           **_time_three({"ms": kernel, "plain_ms": plain,
                          "library_ms": library}, reps=5, replays=4,
                         iters=10),
           **_bound(n * d * x.element_size() + n * 12 + d * 8, 4 * n * d,
                    F32_FLOPS)}
    fvg.dense_launches = before   # timing launches are not main-path ones
    return out


def zipf_columns(n: int, k: int, d: int, g: torch.Generator, dev):
    """[n, k] int32 column ids drawn Zipf(ZIPF_S) over D columns, the hot
    ranks spread over the ids by a seeded permutation."""
    ranks = torch.arange(1, d + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -ZIPF_S, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n * k, generator=g, device=dev, dtype=torch.float64)
    rank = torch.searchsorted(cdf, u).clamp_(max=d - 1)
    perm = torch.randperm(d, generator=g, device=dev)
    return perm[rank].reshape(n, k).to(torch.int32).contiguous()


def time_fused_sparse(fvg, n, k, d, draw, g, dev) -> dict:
    """K2, its plain version, and F.embedding_bag + index_add_ (the
    library yardstick) on ELL rows with offsets and weights, column ids
    uniform or Zipf-skewed (``draw``)."""
    import torch.nn.functional as Fn

    from photon_tpu_torch.ops.features import SparseFeatures
    from photon_tpu_torch.ops.losses import LogisticLoss

    if draw == "zipf":
        idx = zipf_columns(n, k, d, g, dev)
    else:
        idx = torch.randint(0, d, (n, k), generator=g, device=dev,
                            dtype=torch.int32)
    val = torch.randn(n, k, generator=g, device=dev) / k ** 0.5
    x = SparseFeatures(idx, val)
    y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
    off = torch.randn(n, generator=g, device=dev) * 0.2
    w = torch.rand(n, generator=g, device=dev) + 0.5
    coef = torch.randn(d, generator=g, device=dev) * 0.3
    idx64 = idx.long()
    flat = idx64.reshape(-1)

    def kernel():
        return fvg.fused_sparse_value_grad(LogisticLoss, x, y, off, w, coef)

    def plain():
        return fvg.fused_sparse_value_grad_reference(LogisticLoss, x, y, off,
                                                     w, coef)

    def library():
        z = Fn.embedding_bag(idx64, coef[:, None], per_sample_weights=val,
                             mode="sum")[:, 0] + off
        r = w * (torch.sigmoid(z) - y)
        value = (w * (Fn.softplus(z) - y * z)).sum()
        grad = torch.zeros(d, device=dev).index_add_(
            0, flat, (val * r[:, None]).reshape(-1))
        return value, grad

    before = fvg.sparse_launches
    want = plain()
    scales = _vg_scales(LogisticLoss, _ell_margins(idx, val, coef),
                        _ell_margins(idx, val.abs(), coef.abs()), y, off, w,
                        _ell_abs_t(idx, val, d))
    got, again = kernel(), kernel()
    err, ratio = _check_vg("K2", got, again, want, scales,
                           f"timing shape n={n} K={k} D={d} {draw}")
    _check_vg("embedding_bag + index_add_", library(), None, want, scales,
              f"n={n} K={k} D={d} {draw}")
    out = {"n": n, "k": k, "d": d, "columns": draw, "max_abs_err": err,
           "max_scaled_err": ratio,
           **_time_three({"ms": kernel, "plain_ms": plain,
                          "library_ms": library},
                         reps=50 if n < 100_000 else 10, replays=5,
                         iters=200 if n < 100_000 else 20),
           **_bound(n * k * 8 + n * 12 + d * 8, 4 * n * k, F32_FLOPS)}
    fvg.sparse_launches = before
    return out


def time_value_grad(fvg, dense_inputs, g, dev, card):
    """Phase 6 for K1 and K2: every timing shape, printed; returns the two
    lists of results, the main shapes first."""
    feats, labels = dense_inputs
    k1_times = [time_fused_dense(fvg, feats[s], labels, g, dev)
                for s in ("f32", "bf16")]
    del feats, labels, dense_inputs
    torch.cuda.empty_cache()
    for n_wide, d_wide, xdt in K1_WIDE_SHAPES:
        x_wide = torch.randn(n_wide, d_wide, generator=g, device=dev).to(xdt)
        y_wide = (torch.rand(n_wide, generator=g, device=dev) < 0.5).float()
        k1_times.append(time_fused_dense(fvg, x_wide, y_wide, g, dev))
        del x_wide, y_wide
        torch.cuda.empty_cache()
    k2_times = [time_fused_sparse(fvg, n, k, d, draw, g, dev)
                for n, k, d, draw in K2_SHAPES]
    for r in k1_times:
        _print_vg_times(card, "K1 fused_dense_value_grad", r)
    for r in k2_times:
        _print_vg_times(card, "K2 fused_sparse_value_grad", r)
    return k1_times, k2_times


def times_only(fvg, gm, seed: int, dev, card: str) -> int:
    """``--times-only``: phase 6 alone, on fresh data: the serving margin
    (K3, the fused kernel where the tree has it, the launch floor, the
    scorer's dispatch) and K1 and K2 at the training main path's shapes.
    Prints the times and a JSON line ``{"times": ...}``, and no ``ok``
    line: it checks no main path."""
    serving = time_serving(gm, np.random.default_rng(seed), dev, card)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(FE_N, FE_D, generator=g, device=dev)
    y = (torch.rand(FE_N, generator=g, device=dev) < 0.5).float()
    feats = {"f32": x, "bf16": x.to(torch.bfloat16)}
    del x
    k1, k2 = time_value_grad(fvg, (feats, y), g, dev, card)
    compact = lambda rs: [{k: v for k, v in r.items()
                           if not k.startswith("eager_")} for r in rs]
    serving = {k: compact(v) if isinstance(v, list) else v
               for k, v in serving.items()}
    print(json.dumps({"times": {"serving": serving, "K1": compact(k1),
                                "K2": compact(k2)}}))
    return 0


def _print_vg_times(card, name, r):
    shape = (f"n={r['n']} D={r['d']} {r['storage']}" if "storage" in r
             else f"n={r['n']} K={r['k']} D={r['d']} {r['columns']}")
    print(f"[6/6] [{card}] {name} {shape}, ms per call, graph replay "
          f"(eager): kernel {r['ms']:.5f} ({r['eager_ms']:.5f}), plain "
          f"{r['plain_ms']:.5f} ({r['eager_plain_ms']:.5f}), library "
          f"{r['library_ms']:.5f} ({r['eager_library_ms']:.5f}); bound "
          f"{r['bound_ms']:.6f} ({r['bound_by']}, {r['bytes']} bytes at "
          f"3.35 TB/s); max abs err {r['max_abs_err']:.3e}, "
          f"{r['max_scaled_err']:.3e} of the magnitude sum", flush=True)


def _record(name, source, replaces, launches, err, main, shapes, **extra):
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "eager_ms", "eager_plain_ms", "eager_library_ms")
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           **{k: main[k] for k in keys}, **extra}
    if shapes:
        rec["shapes"] = shapes
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--times-only", action="store_true",
                    help="build the kernels and run the times of phase 6 "
                         "alone (phases 1, 2 and 6); no ok line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from photon_tpu_torch.ops import cuda_build
    from photon_tpu_torch.ops import fused_value_grad as fvg
    from photon_tpu_torch.ops import gather_margin as gm
    from photon_tpu_torch.ops import losses

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1/6] device: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}; nvidia-smi: {card}",
          flush=True)

    t0 = time.perf_counter()
    libs = [gm.KERNEL, fvg.KERNEL]
    if hasattr(gm, "glmix_margin"):    # a parent tree may predate it
        libs.append(FLOOR_KERNEL)
    cuda_build.load_libraries(libs)
    build_s = time.perf_counter() - t0
    print(f"[2/6] built and loaded {', '.join(libs)} "
          f"({cuda_build.builds} nvcc runs in parallel, {cuda_build.loads} "
          f"loads) in {build_s:.2f}s", flush=True)
    if args.times_only:
        return times_only(fvg, gm, args.seed, dev, card)

    rng = np.random.default_rng(args.seed)
    check_err, cases = check_gather_margin(gm, rng, dev)
    print(f"[3/6] gather_margin vs plain version: {cases} cases, max abs "
          f"err {check_err:.3e} (atol {ATOL}, rtol {RTOL}), second launch "
          f"bitwise equal", flush=True)
    glmix_err, glmix_cases = check_glmix_margin(gm, rng, dev)
    print(f"[3/6] glmix_margin (fused) vs plain version: {glmix_cases} "
          f"cases (B {GLMIX_BS}, slot widths {GLMIX_COORDS} and "
          f"fixed-only, K_f {GLMIX_KF}), max abs err {glmix_err:.3e} (atol "
          f"{ATOL}, rtol {RTOL} of the magnitude sums), second launch "
          f"bitwise equal", flush=True)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    all_losses = (losses.LogisticLoss, losses.SquaredLoss,
                  losses.PoissonLoss, losses.SmoothedHingeLoss)
    k1_err, k1_ratio, k1_cases = check_fused_dense(fvg, all_losses, g, dev)
    k2_err, k2_ratio, k2_cases = check_fused_sparse(fvg, all_losses, g, dev)
    print(f"[3/6] K1 fused_dense_value_grad vs plain version: {k1_cases} "
          f"cases, max abs err {k1_err:.3e}, {k1_ratio[0]:.3e} of the "
          f"magnitude sum ({k1_ratio[1]}); K2 fused_sparse_value_grad: "
          f"{k2_cases} cases, max abs err {k2_err:.3e}, {k2_ratio[0]:.3e} of "
          f"the magnitude sum ({k2_ratio[1]}); atol {ATOL}, rtol {VG_RTOL} "
          f"of the magnitude sums; every second launch bitwise equal",
          flush=True)
    main_path = serving_main_path(gm, rng, card)
    training = training_main_path(args.seed, dev, card)

    serving_times = time_serving(gm, rng, dev, card)

    k1_times, k2_times = time_value_grad(fvg, training.pop("dense_inputs"),
                                         g, dev, card)

    compact = lambda rs: [{k: v for k, v in r.items()
                           if not k.startswith("eager_")} for r in rs]
    fused, k3 = serving_times["fused"], serving_times["k3"]
    record = {"kernels": [
        _record("glmix_margin", "photon_tpu_torch/csrc/gather_margin.cu",
                "photon_tpu/ops/pallas_glm.py:369", main_path["launches"],
                max([check_err, glmix_err]
                    + [r["max_abs_err"] for r in fused + k3]),
                fused[0], compact(fused[1:] + k3),
                main_shape={k: v for k, v in fused[0].items()
                            if k not in ("max_abs_err", "ms", "plain_ms",
                                         "eager_ms", "eager_plain_ms")},
                launch_floor=serving_times["floor"],
                scorer_dispatch=serving_times["scorer"]),
        _record("fused_dense_value_grad",
                "photon_tpu_torch/csrc/fused_value_grad.cu",
                "photon_tpu/ops/pallas_glm.py:101",
                training["launches"]["K1"],
                max([k1_err] + [r["max_abs_err"] for r in k1_times]),
                k1_times[0], compact(k1_times[1:])),
        _record("fused_sparse_value_grad",
                "photon_tpu_torch/csrc/fused_value_grad.cu",
                "photon_tpu/ops/pallas_glm.py:233",
                training["launches"]["K2"],
                max([k2_err] + [r["max_abs_err"] for r in k2_times]),
                k2_times[0], compact(k2_times[1:])),
    ]}
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f}s")
    print(f"card: {card}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
