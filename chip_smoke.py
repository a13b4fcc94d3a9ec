#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (photon_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing a line:
  1. the device: torch/CUDA versions, the card's name and power limit;
  2. building every kernel of the serving path from ``photon_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, over edge
     shapes (pad slots, duplicate and out-of-range indices, no offsets,
     empty batches), plus a bitwise check of a second launch;
  4. the serving main path at the width of the repo's serving benchmark
     model (one fixed-effect shard of 256 features, a per-user random
     effect over 10,000 users with 8 slots, 32 features per request, 10%
     unknown users, buckets 1..64): write the model dir, load it with
     ``ServingEngine.from_model_dir`` on the card, ``warmup()``, then
     2,000 requests through submit/pump/drain, 100 single-request
     ``serve()`` calls and a forced-shed pass, every score checked
     against a float64 numpy oracle built from the saved arrays;
  5. times: per-stage serving latency and throughput, and each kernel at
     the main-path shape and a throughput shape beside its plain version,
     its byte bound and one PyTorch library call computing the same
     function (a yardstick only; the port never calls it). Each is timed
     in CUDA-graph replay (the card's time per call) and as back-to-back
     eager calls (the host's issue rate where that is the slower).

Any failure raises and exits non-zero. The line before the last is the
kernels' JSON record; the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result. Imports nothing of JAX or photon_tpu.
"""

from __future__ import annotations

import argparse
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

# serving benchmark model width (bench.py's serving mode)
D_GLOBAL, N_USERS, K_USER, NNZ = 256, 10_000, 8, 32
N_REQUESTS, N_SINGLE, N_SHED = 2_000, 100, 256
MAX_BATCH = 64


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def check_close(got: torch.Tensor, want: torch.Tensor, what: str,
                scale: torch.Tensor = None) -> float:
    """|got - want| <= ATOL + RTOL * scale, elementwise; ``scale`` is
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
    bad = err > ATOL + RTOL * ref
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} values outside "
                             f"atol {ATOL} rtol {RTOL}, max abs err "
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
    print(f"[4/5] model dir written in {write_s:.2f}s, loaded+staged in "
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

    torch.cuda.synchronize()
    stats = engine.stats()
    launches = gm.launches
    all_batches = batch_count(stats)
    traffic_launches = launches - after_warmup
    if traffic_launches < all_batches:
        raise AssertionError(f"gather_margin launched {traffic_launches} "
                             f"times for {all_batches} batches")
    if stats["kernel_builds"]["steady"] != 0:
        raise AssertionError(f"kernel library built/loaded after warmup: "
                             f"{stats['kernel_builds']}")
    print(f"[4/5] served {len(out)} + {len(single_out)} + {len(shed_out)} "
          f"requests in {all_batches} batches; oracle rtol/atol "
          f"{RTOL}/{ATOL}: max abs err "
          f"{max(seen_a['max_abs_err'], seen_b['max_abs_err'], seen_c['max_abs_err']):.3e}; "
          f"unknown users {seen_a['unknown'] + seen_b['unknown'] + seen_c['unknown']}, "
          f"shed {seen_c['shed']}; gather_margin launches {launches} "
          f"({traffic_launches} for traffic); kernel builds "
          f"{stats['kernel_builds']}", flush=True)

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
        print(f"[5/5] [{card}] serving latency {stage}: p50 "
              f"{q['p50']:.4f} ms, p99 {q['p99']:.4f} ms", flush=True)
    print(f"[5/5] [{card}] serving throughput {serving['requests_per_s']:.1f} "
          f"requests/s ({N_REQUESTS} requests, {batches} batches, "
          f"{pass_a_s:.3f}s); serve() single request p50 "
          f"{serving['serve_single_ms']['p50']:.4f} ms, p99 "
          f"{serving['serve_single_ms']['p99']:.4f} ms", flush=True)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return {"launches": launches, "serving": serving}


# ---------------------------------------------------------------------------
# phase 5: kernel times
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from photon_tpu_torch.ops import cuda_build
    from photon_tpu_torch.ops import gather_margin as gm

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1/5] device: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}; nvidia-smi: {card}",
          flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library(gm.KERNEL)
    build_s = time.perf_counter() - t0
    print(f"[2/5] built and loaded {gm.KERNEL} ({cuda_build.builds} nvcc "
          f"run, {cuda_build.loads} load) in {build_s:.2f}s", flush=True)

    rng = np.random.default_rng(args.seed)
    check_err, cases = check_gather_margin(gm, rng, dev)
    print(f"[3/5] gather_margin vs plain version: {cases} cases, max abs "
          f"err {check_err:.3e} (atol {ATOL}, rtol {RTOL}), second launch "
          f"bitwise equal", flush=True)

    main_path = serving_main_path(gm, rng, card)

    main_shape = time_gather_margin(gm, rng, dev, 64, 256, D_GLOBAL, NNZ,
                                    iters=2000, reps=200, replays=20)
    big_shape = time_gather_margin(gm, rng, dev, 65_536, 256, 4_096, 256,
                                   iters=50, reps=10, replays=5)
    for label, r in (("main-path", main_shape), ("throughput", big_shape)):
        print(f"[5/5] [{card}] gather_margin {label} shape B={r['B']} "
              f"K={r['K']} D={r['D']}, ms per call, graph replay (eager): "
              f"kernel {r['ms']:.5f} ({r['eager_ms']:.5f}), plain "
              f"{r['plain_ms']:.5f} ({r['eager_plain_ms']:.5f}), "
              f"embedding_bag {r['library_ms']:.5f} "
              f"({r['eager_library_ms']:.5f}); bound {r['bound_ms']:.6f} "
              f"({r['bound_by']}, {r['bytes']} bytes at 3.35 TB/s)",
              flush=True)

    record = {"kernels": [{
        "name": gm.KERNEL,
        "route": "cuda",
        "source": "photon_tpu_torch/csrc/gather_margin.cu",
        "replaces": "photon_tpu/ops/pallas_glm.py:369",
        "launches": main_path["launches"],
        "max_abs_err": max(check_err, main_shape["max_abs_err"],
                           big_shape["max_abs_err"]),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "eager_ms": main_shape["eager_ms"],
        "eager_plain_ms": main_shape["eager_plain_ms"],
        "eager_library_ms": main_shape["eager_library_ms"],
    }]}
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
