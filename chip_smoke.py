#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``filodb_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; every check asserts and any failure exits non-zero:

  1. build   — print the card (``nvidia-smi`` name and power limit), build
               every kernel from ``filodb_tpu_torch/ops/csrc`` (one nvcc per
               source, in parallel) and print the build seconds.
  2. kernels — K1 (the fused-grid kernel) against its plain PyTorch twin on
               the card across the fn x op grid, S in {512, 4096, 65536},
               C in {128, 768}, G in {8, 64}, a sub-range query (c0 > 0) and
               non-finite cells: integer-valued partials bit for bit,
               the rest within rtol 1e-5 of the array's largest magnitude.
  3. small   — about 4096 series x 100 samples through RecordBuilder ->
               shard.ingest -> flush into a CUDA store; the slice's queries
               through QueryEngine.query_range on the card, compared with the
               same engine on the CPU (the plain twins) at rtol 1e-5; K1's
               launch count must advance.
  4. scale   — bench.py's shape: 2^20 series registered through the real
               ingest path, 720 samples each (C = 768, 10 s grid) synthesized
               on the card from a seeded torch.Generator; sum(rate(m[5m]))
               over bench.py's 8 range variants through the engine, each
               against the plain twin on the same tensors. Prints the
               engine's single-query p50, K1's time (CUDA events), the plain
               time, K1's bound and launches per query.

The two lines before the last are the card and the kernel table
({"kernels": [...]}); the last line is {"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside it, it exits 2 and
prints no result.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's north-star shape
NUM_SERIES = 1 << 20
NUM_SAMPLES = 720
CAPACITY = 768
INTERVAL_MS = 10_000
WINDOW_MS = 300_000
STEP_MS = 150_000
BASE_TS = 1_700_000_000_000
REG_BATCH = 1 << 19
DATA_BATCH = 1 << 17

SLICE_QUERIES = ("sum(rate(m[5m]))", "avg by (host) (rate(m[5m]))",
                 "stddev(rate(m[5m]))", "sum(increase(m[5m]))",
                 "count(avg_over_time(m[5m]))", "rate(m[5m])")
FNS = ("rate", "increase", "delta", "sum_over_time", "avg_over_time",
       "count_over_time")
OPS = ("sum", "avg", "count", "group", "stddev", "stdvar")

# published peaks per card (NVIDIA data sheets): memory bytes/s, f32 FLOP/s
# outside the tensor cores
PEAKS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def peaks_for(name: str):
    for key, bw, f32 in PEAKS:
        if key in name:
            return key, bw, f32
    return "H100", 3.35e12, 67e12


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device milliseconds per call, between CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare_parts(got: dict, ref: dict, exact_keys, what: str) -> float:
    """Assert K1's partials against the plain twin's; returns max |diff|."""
    import numpy as np
    assert set(got) == set(ref), (what, set(got), set(ref))
    worst = 0.0
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, (what, k, g.shape, r.shape)
        assert (np.isnan(g) == np.isnan(r)).all(), (what, k, "NaN pattern")
        fin = np.isfinite(r)
        if k in exact_keys:
            assert np.array_equal(g, r, equal_nan=True), (what, k, "not exact")
        else:
            scale = float(np.abs(r[fin]).max(initial=0.0))
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * scale,
                                       equal_nan=True, err_msg=f"{what} {k}")
        if fin.any():
            worst = max(worst, float(np.abs(g[fin] - r[fin]).max()))
    return worst


def make_block(torch, S, C, integer, seed, dev):
    """[S, C] f32 rows with short counts, made on the card. ``integer``:
    small integer gauges (every partial stays an integer below 2^24, exact
    in any summation order); else counters with resets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    col = torch.arange(C, device=dev)[None, :]
    if integer:
        val = torch.randint(0, 4, (S, C), generator=g, device=dev).float()
    else:
        inc = torch.empty((S, C), device=dev).exponential_(generator=g) * 5.0
        val = torch.cumsum(inc, dim=1)
        reset = torch.randint(0, 8, (S,), generator=g, device=dev) == 0
        cut = torch.randint(1, C, (S,), generator=g, device=dev)
        after = reset[:, None] & (col >= cut[:, None])
        val = torch.where(after, val - torch.gather(val, 1, cut[:, None]), val)
    n = torch.full((S,), C, dtype=torch.int32, device=dev)
    short = torch.randint(0, 4, (S,), generator=g, device=dev) == 0
    n = torch.where(short, torch.randint(0, C, (S,), generator=g, device=dev,
                                         dtype=torch.int32), n)
    val = torch.where(col >= n[:, None].long(), torch.full_like(val, 7.0e6), val)
    return val.contiguous(), n


def phase_kernels(torch, np, fg, dev):
    cases = []
    for S in (512, 4096, 65536):
        for C in (128, 768):
            for G in (8, 64):
                cases.append((S, C, G, False))
    cases.append((4096, 768, 8, True))          # sub-range: c0 > 0
    worst = 0.0
    checks = 0
    for i, (S, C, G, sub) in enumerate(cases):
        integer = i % 2 == 0
        val, n = make_block(torch, S, C, integer, 100 + i, dev)
        gids = torch.randint(0, G, (S,), device=dev, dtype=torch.int32,
                             generator=torch.Generator(device=dev).manual_seed(i))
        if sub:
            out_ts = np.arange((C - 180) * INTERVAL_MS, (C - 1) * INTERVAL_MS + 1,
                               STEP_MS, dtype=np.int64)
        else:
            out_ts = np.arange(WINDOW_MS, (C - 1) * INTERVAL_MS + 1, 60_000,
                               dtype=np.int64)
        T = len(out_ts)
        Tp = -(-T // 128) * 128
        plain = {}
        for fn in FNS:
            kind = "window" if fn in fg.FUSED_WINDOW_FNS else "rate"
            band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
                C, Tp, out_ts.tobytes(), WINDOW_MS, 0, INTERVAL_MS, kind,
                False, val.device)
            if sub:
                assert c0 > 0, (C, c0, Ca)
            for sumsq in (False, True):
                plain[fn, sumsq] = fg.fused_grid_aggregate_plain(
                    fn, sumsq, WINDOW_MS, INTERVAL_MS, val, n, gids, band,
                    ohlo, lo, hi, rel, G, c0, Ca)
            for op in OPS:
                sumsq = op in ("stddev", "stdvar")
                got = fg.fused_grid_aggregate(op, fn, val, n, gids, G, out_ts,
                                              WINDOW_MS, 0, INTERVAL_MS)
                ref = fg.PaddedPartials(plain[fn, sumsq], op, G, T).resolve()
                exact = {"count"} | ({"sum"} if integer and fn in (
                    "sum_over_time", "count_over_time") else set())
                worst = max(worst, compare_parts(
                    got, ref, exact, f"S={S} C={C} G={G} {fn} {op}"))
                checks += 1
    # non-finite cells: NaN/inf spread like the band and one-hot products
    val, n = make_block(torch, 4096, 768, False, 7, dev)
    val[5, 40] = float("nan")
    val[777, 300] = float("inf")
    n[5] = n[777] = 768
    gids = (torch.arange(4096, device=dev) % 8).to(torch.int32)
    out_ts = np.arange(WINDOW_MS, 767 * INTERVAL_MS + 1, 60_000, dtype=np.int64)
    for fn in ("rate", "sum_over_time"):
        got = fg.fused_grid_aggregate("stddev", fn, val, n, gids, 8, out_ts,
                                      WINDOW_MS, 0, INTERVAL_MS)
        band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
            768, 128, out_ts.tobytes(), WINDOW_MS, 0, INTERVAL_MS,
            "window" if fn in fg.FUSED_WINDOW_FNS else "rate", False, val.device)
        ref = fg.PaddedPartials(fg.fused_grid_aggregate_plain(
            fn, True, WINDOW_MS, INTERVAL_MS, val, n, gids, band, ohlo, lo,
            hi, rel, 8, c0, Ca), "stddev", 8, len(out_ts)).resolve()
        assert any(np.isnan(v).any() for v in ref.values())
        compare_parts(got, ref, {"count"}, f"non-finite {fn}")
        checks += 1
    torch.cuda.synchronize()
    return checks, worst


def ingest_small(RecordBuilder, GAUGE, shards, np):
    """~4096 series x 100 samples through the real ingest path; a sixteenth
    of the series start 20 cells late (a churned cohort)."""
    rng = np.random.default_rng(3)
    n_series, n_samples = 4096, 100
    per = 512
    for c in range(n_series // per):
        b = RecordBuilder(GAUGE)
        for s in range(c * per, (c + 1) * per):
            late = 20 if s % 16 == 5 else 0
            k = n_samples - late
            ts = BASE_TS + (late + np.arange(k, dtype=np.int64)) * INTERVAL_MS
            vals = np.cumsum(rng.exponential(5.0, k))
            b.add_batch({"_metric_": "m", "host": f"h{s % 8}", "inst": f"i{s}"},
                        ts, vals)
        cont = b.build()
        for sh in shards:
            sh.ingest(cont)
    for sh in shards:
        sh.flush()


def phase_small(torch, np, fg, pkg, devs=("cuda", "cpu")):
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    engines = {}
    shards = []
    for dev in devs:
        ms = TimeSeriesMemStore(device=dev)
        shards.append(ms.setup("p", GAUGE, 0, StoreConfig(
            max_series_per_shard=4096, samples_per_series=128,
            flush_batch_size=10**9, device=dev)))
        engines[dev] = QueryEngine(ms, "p", device=dev)
    ingest_small(RecordBuilder, GAUGE, shards, np)
    kind, _ = shards[0].store.grid_cohorts()
    assert kind == "mixed", kind
    start, end, step = BASE_TS + 300_000, BASE_TS + 990_000, 30_000
    fg.fused_grid_kernel.launches = 0
    got = {q: engines[devs[0]].query_range(q, start, end, step)
           for q in SLICE_QUERIES}
    launches = fg.fused_grid_kernel.launches
    for q in SLICE_QUERIES:
        ref = engines[devs[1]].query_range(q, start, end, step)
        g, r = got[q], ref
        assert [k.labels for k in g.matrix.keys] == \
            [k.labels for k in r.matrix.keys], q
        gv = np.asarray(g.matrix.values, np.float64)
        rv = np.asarray(r.matrix.values, np.float64)
        assert gv.shape == rv.shape and gv.shape[1] == len(r.matrix.out_ts), q
        assert (np.isnan(gv) == np.isnan(rv)).all(), q
        assert np.isfinite(gv[~np.isnan(gv)]).all(), q
        scale = float(np.nanmax(np.abs(rv)))
        np.testing.assert_allclose(gv, rv, rtol=1e-5, atol=1e-5 * scale,
                                   equal_nan=True, err_msg=q)
        assert g.stats.fused_kernels == r.stats.fused_kernels, q
    fused = sum(got[q].stats.fused_kernels for q in SLICE_QUERIES)
    assert launches == fused == 5, (launches, fused)
    return launches


def build_scale(torch, np, pkg, dev):
    """2^20 registered series + a bulk-installed [S, 768] f32 block."""
    StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine = pkg
    ms = TimeSeriesMemStore(device=dev)
    shard = ms.setup("prometheus", GAUGE, 0, StoreConfig(
        max_series_per_shard=NUM_SERIES, samples_per_series=CAPACITY,
        flush_batch_size=10**9, device=dev))
    t0 = time.perf_counter()
    for start in range(0, NUM_SERIES, REG_BATCH):
        b = RecordBuilder(GAUGE)
        b.add_series_batch(
            {"_metric_": "m",
             "host": [f"h{i}" for i in range(start, start + REG_BATCH)]},
            BASE_TS, 0.0)
        shard.ingest(b.build())
    # registration only: the bulk data is installed on the card below
    shard.discard_staged()
    reg_s = time.perf_counter() - t0
    assert shard.num_series == NUM_SERIES
    st = shard.store
    g = torch.Generator(device=dev).manual_seed(7)
    with shard.lock:
        for r0 in range(0, NUM_SERIES, DATA_BATCH):
            inc = torch.empty((DATA_BATCH, NUM_SAMPLES), device=dev)
            inc.exponential_(generator=g)
            st.val[r0:r0 + DATA_BATCH, :NUM_SAMPLES] = torch.cumsum(inc * 5.0, 1)
        st.val[:, NUM_SAMPLES:] = 0.0
        row = BASE_TS + torch.arange(NUM_SAMPLES, device=dev) * INTERVAL_MS
        st.ts[:, :NUM_SAMPLES] = row
        st.n.fill_(NUM_SAMPLES)
        st.n_host[:] = NUM_SAMPLES
        st.first_ts[:] = BASE_TS
        st.last_ts[:] = BASE_TS + (NUM_SAMPLES - 1) * INTERVAL_MS
        st.grid_base, st.grid_interval, st.grid_ok = BASE_TS, INTERVAL_MS, True
    torch.cuda.synchronize()
    return QueryEngine(ms, "prometheus", device=dev), shard, reg_s


def phase_scale(torch, np, fg, pkg, card, dev="cuda"):
    engine, shard, reg_s = build_scale(torch, np, pkg, dev)
    log(f"scale: registered {NUM_SERIES} series in {reg_s:.1f} s; store "
        f"val {tuple(shard.store.val.shape)} f32, ts "
        f"{tuple(shard.store.ts.shape)} i64 on the card")
    start = BASE_TS + WINDOW_MS
    end = BASE_TS + NUM_SAMPLES * INTERVAL_MS
    variants = [(start + k * INTERVAL_MS, end - k * INTERVAL_MS)
                for k in range(8)]
    q = "sum(rate(m[5m]))"
    for s, e in variants:                      # first calls: load + warm
        engine.query_range(q, s, e, STEP_MS)
    # the main path: counts from 0, read right after
    fg.fused_grid_kernel.launches = 0
    results, lat = [], []
    for i in range(8 + 11):
        s, e = variants[i % 8]
        t0 = time.perf_counter()
        r = engine.query_range(q, s, e, STEP_MS)
        lat.append((time.perf_counter() - t0) * 1000)
        if i < 8:
            results.append(r)
    n_queries = 8 + 11
    launches = fg.fused_grid_kernel.launches
    assert launches == n_queries, (launches, n_queries)
    p50 = float(np.percentile(lat[8:], 50))
    stages = {k: round(v, 3) for k, v in r.stats.stage_ms.items()}
    from filodb_tpu_torch.core.filters import Equals
    sel_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pids = shard.part_ids_from_filters([Equals("_metric_", "m")],
                                           start, end)
        sel_ms.append((time.perf_counter() - t0) * 1000)
    assert len(pids) == NUM_SERIES
    sel_p50 = float(np.percentile(sel_ms, 50))

    st = shard.store
    gids = fg.zero_gids(st.S, st.val.device)
    worst = 0.0
    for (s, e), r in zip(variants, results):
        out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
        vals = np.asarray(r.matrix.values)
        assert vals.shape == (1, len(out_ts)) and np.isfinite(vals).all(), \
            vals.shape
        T = len(out_ts)
        Tp = -(-T // 128) * 128
        ops = fg.device_operands(CAPACITY, Tp, out_ts.tobytes(), WINDOW_MS,
                                  BASE_TS, INTERVAL_MS, "rate", False,
                                  st.val.device)
        band, ohlo, lo, hi, rel, c0, Ca = ops
        plain = fg.PaddedPartials(fg.fused_grid_aggregate_plain(
            "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, band,
            ohlo, lo, hi, rel, 8, c0, Ca), "sum", 8, T).resolve()
        kern = fg.PaddedPartials(fg.fused_grid_kernel(
            "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, lo,
            hi, rel, 8, c0, Ca), "sum", 8, T).resolve()
        worst = max(worst, compare_parts(kern, plain, {"count"},
                                         f"scale {s}-{e}"))
        ref = plain["sum"][:1]
        np.testing.assert_allclose(vals, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))

    # timing at variant 0's operands (the full 2 h range: Ca = C = 768)
    s, e = variants[0]
    out_ts = np.arange(s, e + 1, STEP_MS, dtype=np.int64)
    T = len(out_ts)
    Tp = -(-T // 128) * 128
    band, ohlo, lo, hi, rel, c0, Ca = fg.device_operands(
        CAPACITY, Tp, out_ts.tobytes(), WINDOW_MS, BASE_TS, INTERVAL_MS,
        "rate", False, st.val.device)
    k_ms = cuda_ms(lambda: fg.fused_grid_kernel(
        "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, lo, hi,
        rel, 8, c0, Ca), reps=20)
    p_ms = cuda_ms(lambda: fg.fused_grid_aggregate_plain(
        "rate", False, WINDOW_MS, INTERVAL_MS, st.val, st.n, gids, band,
        ohlo, lo, hi, rel, 8, c0, Ca), reps=3, warm=1)
    key, bw, f32 = peaks_for(card)
    S = st.S
    nbytes = S * Ca * 4 + 2 * S * 4 + 3 * Tp * 4 + 2 * 8 * Tp * 4
    lo_h, hi_h = lo.cpu().numpy()[0, :T], hi.cpu().numpy()[0, :T]
    cells = np.clip(np.minimum(hi_h, NUM_SAMPLES - 1)
                    - np.maximum(lo_h + 1, 1) + 1, 0, None)
    # per (row, step): one subtract + max + add per window cell, ~30 for
    # the extrapolation and the fold
    flops = S * float((3 * cells + 30).sum())
    bound_ms = max(nbytes / bw, flops / f32) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / f32 else "operations"
    log(f"scale [{card}]: engine single-query p50 {p50:.3f} ms "
        f"(sum(rate(m[5m])), {T} steps, {n_queries} queries); last query's "
        f"stages (host clock, ms) {stages}; index selection of the "
        f"{NUM_SERIES} series p50 {sel_p50:.3f} ms")
    log(f"scale [{card}]: K1 {k_ms:.4f} ms by CUDA events; plain twin "
        f"{p_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e9:.3f} GB at {key}'s {bw / 1e12:.2f} TB/s, "
        f"{flops / 1e9:.2f} GFLOP at {f32 / 1e12:.0f} TFLOP/s f32)")
    log(f"scale [{card}]: library call: none (no single PyTorch call "
        "computes this function)")
    log(f"scale [{card}]: launches per query {launches / n_queries:.2f}; "
        f"K1 vs plain max |diff| {worst:.3g}")
    return dict(launches=launches, max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "filodb_tpu_torch")):
        print("chip_smoke: filodb_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    from filodb_tpu_torch.core.record import RecordBuilder
    from filodb_tpu_torch.core.schemas import GAUGE
    from filodb_tpu_torch.ops import fusedgrid as fg
    from filodb_tpu_torch.ops import kernels
    from filodb_tpu_torch.query.engine import QueryEngine
    pkg = (StoreConfig, TimeSeriesMemStore, RecordBuilder, GAUGE, QueryEngine)

    t_all = time.perf_counter()
    card = card_line()
    log(f"build: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"build: {', '.join(built) or 'nothing stale'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in kernels.build_log.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    t0 = time.perf_counter()
    checks, worst2 = phase_kernels(torch, np, fg, "cuda")
    log(f"kernels: fusedgrid_k1 ({checks} checks against the plain twin, "
        f"max |diff| {worst2:.3g}, {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    small = phase_small(torch, np, fg, pkg)
    log(f"small: {len(SLICE_QUERIES)} queries on 4096 series match the CPU "
        f"engine; K1 launches {small} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    k1 = phase_scale(torch, np, fg, pkg, card)
    log(f"scale: done in {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    table = {"kernels": [{
        "name": "fusedgrid_k1", "route": "cuda",
        "source": "filodb_tpu_torch/ops/csrc/fusedgrid.cu",
        "replaces": "filodb_tpu/ops/fusedgrid.py:224",
        "launches": k1["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}]}
    print(card, flush=True)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
