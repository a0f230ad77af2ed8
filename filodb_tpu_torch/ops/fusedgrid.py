"""Fused single-pass grid kernel: rate + cross-series aggregation in one read.

Port of ``filodb_tpu/ops/fusedgrid.py``. The north-star query
``sum(rate(metric[5m]))`` over a grid-aligned shard is bound by the bytes of
the value store ([S, C], gigabytes). The fused tier reads the store once
and produces per-group partial state ([G, Tp] sum / count (/ sumsq)) without
the [S, T] rate matrix ever existing in device memory. The store's block is
raw f32 or one of the narrow decode variants of ops/decodereg.py (quant16,
delta16, delta8), decoded tile by tile on the way in.

Two implementations of one function, chosen by the tensor's device:

  * K1, ``csrc/fusedgrid.cu``: the hand-written CUDA kernel for Hopper that
    replaces the Pallas kernel ``build_pallas``. CUDA tensors launch it (or
    raise); nothing falls back.
  * :func:`fused_grid_aggregate_plain`: the plain PyTorch version, walking
    the same [Sb, Ca] row tiles as the reference's XLA twin through the same
    :func:`tile_contrib` math (band and one-hot products, one-hot fold). CPU
    tensors take it; on the card it is the kernel's yardstick only.

The shape gate, group/step padding and active-column slicing are the
reference's, even where the CUDA kernel would not need them, so both
packages take the same route for the same query.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.tracing import SPAN_QUERY_FETCH, span
from . import decodereg, gridfns, kernels

FUSED_FNS = {"rate", "increase", "delta"}
# window-aggregation shapes of the fused tier: closed band instead of the
# open one, cnt >= 1 presence
FUSED_WINDOW_FNS = {"sum_over_time", "avg_over_time", "count_over_time"}
FUSED_OPS = {"sum", "avg", "count", "group", "stddev", "stdvar"}

# K1's function codes (enum Fn in csrc/fusedgrid.cu)
FN_CODES = {"rate": 0, "increase": 1, "delta": 2, "sum_over_time": 3,
            "avg_over_time": 4, "count_over_time": 5}
# K1's decode variants (enum Kind in csrc/fusedgrid.cu)
KIND_CODES = {"raw": 0, "quant16": 1, "delta16": 2, "delta8": 3}
K1_STEPS = 128             # steps per block (kSteps in the CUDA source)
K1_TERMS = 6               # per-step time terms (kTerms in the CUDA source)
K1_THREADS = 256           # threads per block (kThreads in the CUDA source)
K1_RUN = 16                # cells a thread decodes (kRun in the CUDA source)
K1_PASSES = 2              # delta decode passes a tile (kPasses)
K1_MAX_RUNS = 64           # delta runs a row (kMaxRuns)


def _roundup(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def tile_contrib(fn: str, window_ms: int, interval_ms: int, c0: int,
                 v, n, band, ohlo, lo, hi, rel):
    """Per-tile window math of the fused tier, the reference's tile_contrib
    in PyTorch: decoded values ``v [Sb, Ca]`` -> ``(contrib [Sb, Tp]`` with
    absent cells zeroed, ``okf [Sb, Tp]`` presence as f32). ``band`` is the
    OPEN band for the rate family and the CLOSED band for the window fns;
    ``n [Sb, 1]`` i32, ``lo/hi/rel [1, Tp]`` i32."""
    f32 = torch.float32
    Sb, Ca = v.shape
    lcol = torch.arange(Ca, dtype=torch.int32, device=v.device)[None, :]
    col = lcol + c0                                           # global cell
    valid = col < n
    v = torch.where(valid, v, 0.0)

    last_cell = n - 1                                         # [Sb, 1]
    f_idx = torch.clamp(lo, min=0)                            # [1, Tp]
    l_idx = torch.minimum(hi, last_cell)                      # [Sb, Tp]
    cnt = torch.clamp(l_idx - f_idx + 1, min=0)
    cnt_f = cnt.to(f32)

    if fn in FUSED_WINDOW_FNS:
        ok = cnt >= 1
        if fn == "count_over_time":
            return torch.where(ok, cnt_f, 0.0), ok.to(f32)
        s = v @ band                                          # closed band
        if fn == "avg_over_time":
            s = s / cnt_f
        return torch.where(ok, s, 0.0), ok.to(f32)

    is_counter = fn != "delta"
    # valid cells are a prefix of each row: cell c has a valid predecessor
    # exactly when c > 0 and c is valid, which also masks the roll's
    # wrapped column; with a column offset the local column 0 wraps to the
    # slice's last column and is masked too
    prev = torch.roll(v, 1, dims=1)
    raw = v - prev
    inc = torch.clamp(raw, min=0.0) if is_counter else raw
    mask = valid & (col > 0)
    if c0:
        mask &= lcol > 0
    inc = torch.where(mask, inc, 0.0)

    delta = inc @ band                                        # [Sb, Tp]
    f_v = v @ ohlo

    relf = rel.to(f32)                                        # [1, Tp]
    f_rel = (f_idx * interval_ms).to(f32)
    l_rel = (l_idx * interval_ms).to(f32)
    dur_start = (f_rel - (relf - window_ms)) / 1000.0
    dur_end = (relf - l_rel) / 1000.0
    sampled = (l_rel - f_rel) / 1000.0
    avg_dur = sampled / (cnt_f - 1.0)
    if is_counter:
        safe = torch.where(delta > 0, delta, 1.0)
        dur_zero = torch.where(delta > 0, sampled * (f_v / safe), float("inf"))
        dur_start = torch.where((delta > 0) & (f_v >= 0)
                                & (dur_zero < dur_start), dur_zero, dur_start)
    thresh = avg_dur * 1.1
    extrap = sampled
    extrap = extrap + torch.where(dur_start < thresh, dur_start, avg_dur / 2)
    extrap = extrap + torch.where(dur_end < thresh, dur_end, avg_dur / 2)
    scaled = delta * (extrap / sampled)
    if fn == "rate":
        scaled = scaled * (1000.0 / window_ms)

    ok = cnt >= 2
    return torch.where(ok, scaled, 0.0), ok.to(f32)


def fused_grid_aggregate_plain(fn: str, needs_sumsq: bool, window_ms: int,
                               interval_ms: int, val, n, gids, band, ohlo,
                               lo, hi, rel, G: int, c0: int = 0,
                               Ca: int | None = None, kind: str = "raw",
                               row_ops=()):
    """Plain PyTorch twin of K1: walks the reference's [Sb, Ca] row tiles
    (Sb = 512, or S when S <= 512), decodes each through the registry's
    ``kind`` (``val`` is that variant's block, ``row_ops`` its per-row [S]
    operands), runs it through :func:`tile_contrib` and folds it into
    [G, Tp] partials with a one-hot product. Returns the 2 or 3 [G, Tp] f32
    outputs (sum, count (, sumsq))."""
    f32 = torch.float32
    S, C = val.shape
    Ca = Ca or C
    Sb = 512 if S % 512 == 0 else S
    Tp = band.shape[1]
    dev = val.device
    outs = [torch.zeros((G, Tp), dtype=f32, device=dev)
            for _ in range(3 if needs_sumsq else 2)]
    gcol = torch.arange(G, dtype=torch.int32, device=dev)[None, :]
    n2 = n.to(torch.int32).reshape(S, 1)
    g2 = gids.to(torch.int32).reshape(S, 1)
    decode = decodereg.variant(kind).decode
    for i in range(0, S, Sb):
        v = decode(val[i:i + Sb, c0:c0 + Ca],
                   *(r[i:i + Sb, None] for r in row_ops))
        contrib, okf = tile_contrib(fn, window_ms, interval_ms, c0, v,
                                    n2[i:i + Sb], band, ohlo, lo, hi, rel)
        oh = (gcol == g2[i:i + Sb]).to(f32).T                 # [G, Sb]
        outs[0] += oh @ contrib
        outs[1] += oh @ okf
        if needs_sumsq:
            outs[2] += oh @ (contrib * contrib)
    return tuple(outs)


@functools.lru_cache(maxsize=1)
def _k1_lib():
    lib = kernels.load("fusedgrid")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fusedgrid_launch.restype = i
    lib.fusedgrid_launch.argtypes = [
        p, i, p, p,                              # val, kind, row0, row1
        ctypes.c_longlong, i, i, i, i,           # row_stride, c0, ca, cap, rows
        p, p, p, p, p,                           # n, gid, lo, hi, rel
        i, i, i, i, i, i, ctypes.c_float,        # tp, G, fn, nout, window, interval, scale
        i, i, i, i, p, i, p, p]                  # rpb, rt, vec4, cw, scratch, nchunks, out, stream
    lib.fusedgrid_error_string.restype = ctypes.c_char_p
    lib.fusedgrid_error_string.argtypes = [i]
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused_grid_kernel: {what}")


def k1_smem_bytes(Ca: int, rt: int, G: int, nout: int,
                  kind: str = "raw") -> int:
    """Shared memory of one K1 block: the sum ``smem_bytes`` in
    csrc/fusedgrid.cu computes, term for term (keep the two alike) — the
    f32 tile buffers [nbuf, rt, Ca] (two for raw's double buffer, one for
    the decode variants), the decode variants' ring [2, rt, Ca] of their
    own i16 / i8 (its bytes rounded up to 4: quant16's and delta16's are
    exactly raw's second f32 buffer), contributions and presence [rt, 128]
    each, the accumulator [nout, G, 128], the steps' 6 time terms [6, 128];
    and i32 n and gid [2, rt] each, two non-finite counts [rt] each, lo /
    hi / rel / the live-step list [128] each, 4 warp counts."""
    nbuf = 2 if kind == "raw" else 1
    ring = {"quant16": 4 * rt * Ca, "delta16": 4 * rt * Ca,
            "delta8": _roundup(2 * rt * Ca, 4)}
    return (4 * (nbuf * rt * Ca + 2 * rt * K1_STEPS + nout * G * K1_STEPS
                 + K1_TERMS * K1_STEPS)
            + ring.get(kind, 0)
            + 4 * (6 * rt + 4 * K1_STEPS + 4))


def k1_delta_runs(Ca: int, rt: int) -> tuple[int, int, int]:
    """(runs a row, rows a pass, passes) of the delta decode in
    csrc/fusedgrid.cu (``decode_delta``): thread t of a pass decodes cells
    [16 j, 16 j + 16) of the pass's row t // runs (j = t % runs), so a pass
    holds the whole rows that 256 threads cover."""
    nrun = -(-Ca // K1_RUN)
    rpp = K1_THREADS // nrun
    return nrun, rpp, -(-rt // rpp)


def k1_delta_cells(Ca: int, nr: int):
    """The delta decode's layout over a tile of ``nr`` staged rows, as the
    kernel computes it: (pass, thread, row, first cell, end cell) for every
    thread that decodes a run."""
    nrun, rpp, passes = k1_delta_runs(Ca, nr)
    for ps in range(min(passes, K1_PASSES)):
        for t in range(K1_THREADS):
            q, j = divmod(t, nrun)
            r = ps * rpp + q
            if q < rpp and r < nr:
                yield ps, t, r, j * K1_RUN, min(j * K1_RUN + K1_RUN, Ca)


def k1_quant16_chunks(Ca: int, nr: int, cw: int):
    """The quant16 staging's layout over a tile of ``nr`` staged rows, as
    the kernel computes it (``quant16_slot`` / ``quant16_next`` in
    csrc/fusedgrid.cu): the packed tile is cut into chunks of cw / 2 cells,
    chunk u goes to thread u % 256 in pass u // 256, and the thread steps
    its chunk's (row, column) from pass to pass by a fixed amount. Yields
    (pass, thread, packed first cell, row, column) for every chunk: the
    copy reads the block at (row, column) and writes the stage at the
    packed cell, and the dequantise reads the stage and writes the f32 tile
    there."""
    e = cw // 2
    r, c = divmod(np.arange(K1_THREADS) * e, Ca)
    dr, dc = divmod(K1_THREADS * e, Ca)
    ps = 0
    while ps * K1_THREADS * e < nr * Ca:
        for t in range(K1_THREADS):
            x = (ps * K1_THREADS + t) * e
            if x < nr * Ca:
                yield ps, t, x, int(r[t]), int(c[t])
        c = c + dc
        r = r + dr + (c >= Ca)
        c = np.where(c >= Ca, c - Ca, c)
        ps += 1


def delta_copy_width(ptr: int, stride_bytes: int, row_bytes: int) -> int:
    """The ring's copy width in bytes (every decode variant): the largest
    power of two, at most 16, that divides the first active byte, the row
    stride and the row length in bytes, so every row's global start and
    its packed start in the ring are aligned to it (16, 8, 4: cp.async; 2,
    1: plain loads)."""
    a = ptr | stride_bytes | row_bytes | 16
    return a & -a


def k1_copy_width(val, c0: int, Ca: int) -> int:
    """The ring's copy width for K1 over columns [c0, c0 + Ca) of ``val``:
    :func:`delta_copy_width` of the view's first active byte, its row
    stride and its active row length in bytes."""
    esz = val.element_size()
    return delta_copy_width(val.data_ptr() + c0 * esz, val.stride(0) * esz,
                            Ca * esz)


def k1_launch_shape(S: int, Ca: int, Tp: int, G: int, nout: int):
    """(rows staged per tile, rows per block, row chunks) of one K1 launch:
    about 1024 blocks in all, scratch partials held under 64 MB. A tile is
    about 4096 cells (5 rows at bench.py's 768 columns), at most 32 rows:
    two raw tile buffers, the [rt, 128] contribution arrays and a G = 8
    accumulator then leave room for four blocks on an SM, and 5 rows x 47
    live steps fill the block's 256 threads about once. The tile does not
    depend on the decode variant, so a narrow block and its decode fold in
    the same chunks (bit for bit the same partials)."""
    rt = max(1, min(32, 4096 // Ca))
    by = Tp // K1_STEPS
    nchunks = min(-(-S // rt), max(1, 1024 // by),
                  max(1, (64 << 20) // (nout * G * Tp * 4)))
    nchunks = max(1, nchunks)
    rows_per_block = -(-S // nchunks)
    return rt, rows_per_block, -(-S // rows_per_block)


def fused_grid_kernel(fn: str, needs_sumsq: bool, window_ms: int,
                      interval_ms: int, val, n, gids, lo, hi, rel, G: int,
                      c0: int = 0, Ca: int | None = None, kind: str = "raw",
                      row_ops=()):
    """Launch K1 on ``val``'s card; returns the 2 or 3 [G, Tp] f32 outputs.

    Checks what the kernel takes and raises on anything else: ``val`` a
    CUDA [S, C] tensor of the decode variant ``kind``'s block dtype (f32 raw,
    i16 quant16/delta16, i8 delta8) with unit column stride (the kernel
    reads columns [c0, c0 + Ca) of each row; the full_columns variants
    delta16/delta8 need c0 = 0 and Ca = C); ``row_ops`` the variant's
    contiguous f32 [S] row operands ((vmin, scale) for quant16, (anchor,)
    for the delta variants); ``n``/``gids`` contiguous int32 [S];
    ``lo``/``hi``/``rel`` contiguous int32 holding Tp values, Tp a multiple
    of 128; 1 <= G <= 64; all on one device. Launches on that device's
    current stream (with the device made current for the launch) and does
    not synchronise. Counts its launches in ``.launches`` and, by
    variant, in ``.launches_by_kind``.

    C interface (``fusedgrid_launch`` in csrc/fusedgrid.cu), in order:
    val, kind (KIND_CODES), row0, row1 (row operands, or null) -- the
    block and its decode; row_stride, c0, ca, cap (= C), rows (= S);
    n, gid, lo, hi, rel -- device pointers of the operands above;
    tp, groups, fn (FN_CODES), nout (2 or 3), window_ms, interval_ms,
    rate_scale (f32 of 1000.0 / window_ms) -- the query;
    rows_per_block, rt (rows per shared-memory tile), vec4 (raw's 16-byte
    loads aligned), cw (the narrow ring's copy width,
    :func:`k1_copy_width`) -- the launch shape;
    scratch ([nchunks, nout, G, Tp] f32), nchunks, out ([nout, G, Tp] f32),
    stream. It returns cudaGetLastError() after each of its two launches,
    refuses a narrow launch whose copy width does not divide the first
    active byte, the row stride and the row length, and a delta launch at
    c0 > 0, Ca < C, Ca > K1_RUN * K1_MAX_RUNS or a tile of more than
    K1_PASSES decode passes. quant16 stages through the same ring at any
    c0 and Ca (``k1_quant16_chunks``)."""
    Ca = Ca or val.shape[1]
    dev = val.device
    _require(fn in FN_CODES, f"unknown fn {fn!r}")
    _require(kind in KIND_CODES, f"unknown decode variant {kind!r}")
    var = decodereg.variant(kind)
    _require(val.dtype == var.block_dtype,
             f"a {kind} block must be {var.block_dtype}, got {val.dtype}")
    _require(val.dim() == 2 and val.stride(1) == 1,
             "val must be [S, C] with unit column stride")
    S, C = val.shape
    _require(0 <= c0 and 0 < Ca and c0 + Ca <= C, f"bad columns {c0}+{Ca} of {C}")
    _require(not var.full_columns or (c0 == 0 and Ca == C),
             f"{kind} decodes whole rows: columns {c0}+{Ca} of {C}")
    _require(len(row_ops) == var.row_operands,
             f"{kind} takes {var.row_operands} row operands, got {len(row_ops)}")
    for t in row_ops:
        _require(t.device == dev and t.dtype == torch.float32
                 and t.is_contiguous() and t.numel() == S,
                 f"row operands must be contiguous float32 [{S}] on {dev}")
    for name, t, length in (("n", n, S), ("gids", gids, S)):
        _require(t.device == dev and t.dtype == torch.int32
                 and t.is_contiguous() and t.numel() == length,
                 f"{name} must be contiguous int32 [{length}] on {dev}")
    Tp = lo.numel()
    _require(Tp > 0 and Tp % K1_STEPS == 0, f"Tp={Tp} not a multiple of 128")
    for name, t in (("lo", lo), ("hi", hi), ("rel", rel)):
        _require(t.device == dev and t.dtype == torch.int32
                 and t.is_contiguous() and t.numel() == Tp,
                 f"{name} must be contiguous int32 [{Tp}] on {dev}")
    _require(1 <= G <= MAX_GROUPS, f"G={G} outside [1, {MAX_GROUPS}]")
    _require(val.is_cuda, "val must be a CUDA tensor")
    nout = 3 if needs_sumsq else 2
    rt, rows_per_block, nchunks = k1_launch_shape(S, Ca, Tp, G, nout)
    vec4 = int(val.stride(0) % 4 == 0 and c0 % 4 == 0 and Ca % 4 == 0
               and val.data_ptr() % (4 * val.element_size()) == 0)
    cw = k1_copy_width(val, c0, Ca)
    if var.full_columns:
        nrun, _rpp, passes = k1_delta_runs(Ca, rt)
        _require(nrun <= K1_MAX_RUNS and passes <= K1_PASSES,
                 f"{kind} at C={Ca}: {nrun} runs a row, {passes} decode "
                 f"passes a tile (at most {K1_MAX_RUNS}, {K1_PASSES})")
    scratch = torch.empty((nchunks, nout, G, Tp), dtype=torch.float32,
                          device=dev)
    out = torch.empty((nout, G, Tp), dtype=torch.float32, device=dev)
    rate_scale = float(np.float32(1000.0 / window_ms))
    lib = _k1_lib()
    rows = [t.data_ptr() for t in row_ops] + [None] * (2 - len(row_ops))
    # the <<<>>> launch runs on the thread's current device: make it the
    # tensors' own (a mesh shard on cuda:1 while cuda:0 is current)
    with torch.cuda.device(dev):
        err = lib.fusedgrid_launch(
            val.data_ptr(), KIND_CODES[kind], *rows, val.stride(0), c0, Ca,
            C, S, n.data_ptr(), gids.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            rel.data_ptr(), Tp, G, FN_CODES[fn], nout, int(window_ms),
            int(interval_ms), rate_scale, rows_per_block, rt, vec4, cw,
            scratch.data_ptr(), nchunks, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fusedgrid kernel launch failed: CUDA error {err} "
                           f"({lib.fusedgrid_error_string(err).decode()})")
    kernels.count_launch(fused_grid_kernel, kind)
    return tuple(out.unbind(0))


fused_grid_kernel.launches = 0
fused_grid_kernel.launches_by_kind = dict.fromkeys(KIND_CODES, 0)


def active_columns(C: int, lo: np.ndarray, hi: np.ndarray) -> tuple[int, int]:
    """(c0, Ca): the aligned store-column range the query actually reads —
    first-sample selects need cell max(0, lo.min()); window sums need cells
    (lo, hi]. The block's offset must be a multiple of its width (the
    reference's Pallas block indexing; kept so both packages slice alike),
    so Ca grows in 128-steps until an aligned start covers the range. C
    must be a multiple of 128; callers get (0, C) otherwise."""
    if C % 128 != 0 or len(lo) == 0:
        return 0, C
    first = max(0, int(lo.min()))
    last = min(C - 1, int(hi.max()))
    if last < first:                      # empty windows: minimal block
        last = first
    c1 = _roundup(last + 1, 128)
    Ca = c1 - (first // 128) * 128
    while Ca < C:
        c0 = (first // Ca) * Ca
        # the block must cover [c0, c1) and stay inside the store
        if c0 + Ca >= c1 and c0 + Ca <= C:
            return c0, Ca
        Ca += 128
    return 0, C


def pad_edges(lo: np.ndarray, hi: np.ndarray, rel: np.ndarray,
              window_ms: int, Tp: int):
    """Step-edge operands padded to Tp as [1, Tp] i32: lo zero-padded, hi
    padded with -1 (an empty window — cnt clamps to 0 so padded steps
    contribute nothing), rel zero-padded."""
    T = len(rel)
    assert abs(rel).max(initial=0) < 2**31 and window_ms < 2**31
    lo_p = np.zeros(Tp, np.int32); lo_p[:T] = lo
    hi_p = np.full(Tp, -1, np.int32); hi_p[:T] = hi
    rel_p = np.zeros(Tp, np.int32); rel_p[:T] = rel
    return (lo_p.reshape(1, Tp), hi_p.reshape(1, Tp), rel_p.reshape(1, Tp))


def host_operands(C: int, Tp: int, out_ts: np.ndarray, window_ms: int,
                  base_ts: int, interval_ms: int, fn_kind: str = "rate",
                  full_cols: bool = False):
    """Band/one-hot/edge operands as host arrays + active column range:
    (band, ohlo, lo[1,Tp], hi[1,Tp], rel[1,Tp], c0, Ck). Sub-range queries
    get band/ohlo rows sliced to [c0, c0+Ck). ``fn_kind`` "rate" builds the
    OPEN band, "window" the CLOSED band of the *_over_time fns."""
    T = len(out_ts)
    lo, hi = gridfns.grid_edges(out_ts, window_ms, base_ts, interval_ms)
    rel = out_ts - base_ts
    lo_p, hi_p, rel_p = pad_edges(lo, hi, rel, window_ms, Tp)
    band = np.zeros((C, Tp), np.float32)
    band[:, :T] = gridfns.band_matrix(C, lo, hi, fn_kind == "rate",
                                      np.float32)
    ohlo = np.zeros((C, Tp), np.float32)
    ohlo[:, :T] = gridfns.onehot_matrix(C, np.maximum(lo, 0), np.float32)
    c0, Ca = (0, C) if full_cols else active_columns(C, lo, hi)
    if Ca < C:
        band = np.ascontiguousarray(band[c0:c0 + Ca])
        ohlo = np.ascontiguousarray(ohlo[c0:c0 + Ca])
    return (band, ohlo, lo_p, hi_p, rel_p, c0, Ca)


@functools.lru_cache(maxsize=32)
def device_operands(C: int, Tp: int, out_ts_key: bytes, window_ms: int,
                     base_ts: int, interval_ms: int, fn_kind: str,
                     full_cols: bool, device: torch.device):
    """Band/one-hot/edge operands on ``device``, cached per query shape and
    device: re-uploading the [C, Tp] bands per query would cost a host to
    device copy each time."""
    out_ts = np.frombuffer(out_ts_key, np.int64)
    *arrs, c0, Ck = host_operands(C, Tp, out_ts, window_ms, base_ts,
                                  interval_ms, fn_kind, full_cols)
    return tuple(torch.from_numpy(a).to(device) for a in arrs) + (c0, Ck)


# shape caps of the fused path, the reference's (set there by VMEM); beyond
# them callers take the two-step route
MAX_GROUPS = 64
MAX_STEPS = 512          # Tp cap
MAX_CAPACITY = 1024      # C cap


def fusable(S: int, C: int, T: int, num_groups: int) -> bool:
    """Shape gate of the fused tier (the reference's, unchanged)."""
    return (C <= MAX_CAPACITY
            and _roundup(max(T, 1), 128) <= MAX_STEPS
            and num_groups <= MAX_GROUPS
            and (S % 512 == 0 or (S <= 512 and S % 8 == 0)))


class PaddedPartials:
    """Device-resident padded kernel outputs, fetched lazily: the leaf holds
    the shard lock while launching — blocking there on a device to host
    copy would stall every ingest/query thread for the whole pass.
    ``resolve()`` runs at present/merge time, outside the lock."""

    def __init__(self, outs, op: str, num_groups: int, T: int):
        self._outs = outs
        self._op = op
        self._ng = num_groups
        self._T = T

    def parts_of(self, outs) -> dict:
        """Partial dict from already-fetched outputs."""
        s, c = outs[0][:self._ng, :self._T], outs[1][:self._ng, :self._T]
        if self._op in ("count", "group"):
            return {"count": c}
        parts = {"sum": s, "count": c}
        if len(outs) > 2:
            parts["sumsq"] = outs[2][:self._ng, :self._T]
        return parts

    def resolve(self) -> dict:
        # the host waits here for K1 and everything queued ahead of it
        with span(SPAN_QUERY_FETCH, site="k1_partials"):
            outs = [o.cpu().numpy() for o in self._outs]
        return self.parts_of(outs)


def fused_grid_aggregate(op: str, fn: str, val, n, gids, num_groups: int,
                         out_ts: np.ndarray, window_ms: int,
                         base_ts: int, interval_ms: int, fetch: bool = True,
                         narrow=None):
    """One-pass ``op(fn(metric[window]))`` partials over a grid-aligned block.

    val [S, C] f32, n [S] valid counts, gids [S] dense group ids (<
    num_groups). Returns the partial-state dict of
    ``aggregators.partial_aggregate(op, ...)`` with [num_groups, T] arrays;
    with ``fetch=False`` a :class:`PaddedPartials` whose ``resolve()`` does
    the host copy later. ``narrow=(kind, operands)`` streams a registered
    narrow block (ops/decodereg.py) instead of ``val``: ``kind`` names the
    decode variant ("quant16" | "delta16" | "delta8") and ``operands =
    (block, *row_operands)`` its tensors; the caller must already have
    zeroed ``n`` on rows whose narrow form is not bit-exact. CUDA tensors go
    through K1, CPU tensors through the plain version; there is no other
    route.
    """
    assert fn in FUSED_FNS | FUSED_WINDOW_FNS and op in FUSED_OPS
    kind, (val, *row_ops) = narrow if narrow is not None else ("raw", (val,))
    S, C = val.shape
    T = len(out_ts)
    assert fusable(S, C, T, num_groups), (S, C, T, num_groups)
    Tp = _roundup(max(T, 1), 128)
    G = _roundup(max(num_groups, 8), 8)
    band, ohlo, lo_d, hi_d, rel_d, c0, Ck = device_operands(
        C, Tp, np.ascontiguousarray(np.asarray(out_ts, np.int64)).tobytes(),
        int(window_ms), int(base_ts), int(interval_ms),
        "window" if fn in FUSED_WINDOW_FNS else "rate",
        decodereg.variant(kind).full_columns, val.device)
    outs = fused_grid_partials(fn, op in ("stddev", "stdvar"), int(window_ms),
                               int(interval_ms), val, n, gids, band, ohlo,
                               lo_d, hi_d, rel_d, G, c0, Ck, kind, row_ops)
    padded = PaddedPartials(outs, op, num_groups, T)
    return padded.resolve() if fetch else padded


def fused_grid_partials(fn: str, needs_sumsq: bool, window_ms: int,
                        interval_ms: int, val, n, gids, band, ohlo, lo, hi,
                        rel, G: int, c0: int = 0, Ca: int | None = None,
                        kind: str = "raw", row_ops=()):
    """The 2 or 3 [G, Tp] partials of one fused pass over operands already
    built (:func:`device_operands`): K1 for CUDA tensors, the plain twin for
    CPU tensors; there is no other route."""
    n = n.to(torch.int32)
    gids = gids.to(torch.int32)
    if val.is_cuda:
        return fused_grid_kernel(fn, needs_sumsq, window_ms, interval_ms, val,
                                 n.contiguous(), gids.contiguous(), lo, hi,
                                 rel, G, c0, Ca, kind, row_ops)
    return fused_grid_aggregate_plain(fn, needs_sumsq, window_ms, interval_ms,
                                      val, n, gids, band, ohlo, lo, hi, rel, G,
                                      c0, Ca, kind, row_ops)


@functools.lru_cache(maxsize=8)
def zero_gids(S: int, device: torch.device):
    """Cached device zeros for single-group (global) aggregation: no fresh
    [S] upload per query."""
    return torch.zeros(S, dtype=torch.int32, device=device)
