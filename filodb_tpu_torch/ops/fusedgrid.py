"""Fused single-pass grid kernel: rate + cross-series aggregation in one read.

Port of ``filodb_tpu/ops/fusedgrid.py``. The north-star query
``sum(rate(metric[5m]))`` over a grid-aligned shard is bound by the bytes of
the value store ([S, C] f32, gigabytes). The fused tier reads the store once
and produces per-group partial state ([G, Tp] sum / count (/ sumsq)) without
the [S, T] rate matrix ever existing in device memory.

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

from . import decodereg, gridfns, kernels

FUSED_FNS = {"rate", "increase", "delta"}
# window-aggregation shapes of the fused tier: closed band instead of the
# open one, cnt >= 1 presence
FUSED_WINDOW_FNS = {"sum_over_time", "avg_over_time", "count_over_time"}
FUSED_OPS = {"sum", "avg", "count", "group", "stddev", "stdvar"}

# K1's function codes (enum Fn in csrc/fusedgrid.cu)
FN_CODES = {"rate": 0, "increase": 1, "delta": 2, "sum_over_time": 3,
            "avg_over_time": 4, "count_over_time": 5}
K1_STEPS = 128             # steps per block (kSteps in the CUDA source)


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
                               Ca: int | None = None):
    """Plain PyTorch twin of K1: walks the reference's [Sb, Ca] row tiles
    (Sb = 512, or S when S <= 512) through :func:`tile_contrib` and folds
    each into [G, Tp] partials with a one-hot product. Returns the 2 or 3
    [G, Tp] f32 outputs (sum, count (, sumsq))."""
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
    decode = decodereg.variant("raw").decode
    for i in range(0, S, Sb):
        v = decode(val[i:i + Sb, c0:c0 + Ca])
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
        p, ctypes.c_longlong, i, i, i, i,        # val, row_stride, c0, ca, cap, rows
        p, p, p, p, p,                           # n, gid, lo, hi, rel
        i, i, i, i, i, i, ctypes.c_float,        # tp, G, fn, nout, window, interval, scale
        i, i, i, p, i, p, p]                     # rpb, rt, vec4, scratch, nchunks, out, stream
    lib.fusedgrid_error_string.restype = ctypes.c_char_p
    lib.fusedgrid_error_string.argtypes = [i]
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused_grid_kernel: {what}")


def k1_launch_shape(S: int, Ca: int, Tp: int, G: int, nout: int):
    """(rows staged per tile, rows per block, row chunks) of one K1 launch:
    about 1024 blocks in all, scratch partials held under 64 MB."""
    rt = max(1, min(64, 8192 // Ca))
    by = Tp // K1_STEPS
    nchunks = min(-(-S // rt), max(1, 1024 // by),
                  max(1, (64 << 20) // (nout * G * Tp * 4)))
    nchunks = max(1, nchunks)
    rows_per_block = -(-S // nchunks)
    return rt, rows_per_block, -(-S // rows_per_block)


def fused_grid_kernel(fn: str, needs_sumsq: bool, window_ms: int,
                      interval_ms: int, val, n, gids, lo, hi, rel, G: int,
                      c0: int = 0, Ca: int | None = None):
    """Launch K1 on ``val``'s card; returns the 2 or 3 [G, Tp] f32 outputs.

    Checks what the kernel takes and raises on anything else: ``val`` a
    CUDA f32 [S, C] tensor with unit column stride (the kernel reads columns
    [c0, c0 + Ca) of each row); ``n``/``gids`` contiguous int32 [S];
    ``lo``/``hi``/``rel`` contiguous int32 holding Tp values, Tp a multiple
    of 128; 1 <= G <= 64; all on one device. Launches on the current stream
    and does not synchronise.

    C interface (``fusedgrid_launch`` in csrc/fusedgrid.cu), in order:
    val, row_stride, c0, ca, cap (= C), rows (= S) -- the value block;
    n, gid, lo, hi, rel -- device pointers of the operands above;
    tp, groups, fn (FN_CODES), nout (2 or 3), window_ms, interval_ms,
    rate_scale (f32 of 1000.0 / window_ms) -- the query;
    rows_per_block, rt (rows per shared-memory tile), vec4 (16-byte loads
    aligned) -- the launch shape; scratch ([nchunks, nout, G, Tp] f32),
    nchunks, out ([nout, G, Tp] f32), stream. It returns
    cudaGetLastError() after each of its two launches."""
    Ca = Ca or val.shape[1]
    dev = val.device
    _require(fn in FN_CODES, f"unknown fn {fn!r}")
    _require(val.is_cuda, "val must be a CUDA tensor")
    _require(val.dtype == torch.float32, f"val must be float32, got {val.dtype}")
    _require(val.dim() == 2 and val.stride(1) == 1,
             "val must be [S, C] with unit column stride")
    S, C = val.shape
    _require(0 <= c0 and 0 < Ca and c0 + Ca <= C, f"bad columns {c0}+{Ca} of {C}")
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
    nout = 3 if needs_sumsq else 2
    rt, rows_per_block, nchunks = k1_launch_shape(S, Ca, Tp, G, nout)
    vec4 = int(val.stride(0) % 4 == 0 and c0 % 4 == 0 and Ca % 4 == 0
               and val.data_ptr() % 16 == 0)
    scratch = torch.empty((nchunks, nout, G, Tp), dtype=torch.float32,
                          device=dev)
    out = torch.empty((nout, G, Tp), dtype=torch.float32, device=dev)
    rate_scale = float(np.float32(1000.0 / window_ms))
    lib = _k1_lib()
    err = lib.fusedgrid_launch(
        val.data_ptr(), val.stride(0), c0, Ca, C, S,
        n.data_ptr(), gids.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        rel.data_ptr(), Tp, G, FN_CODES[fn], nout, int(window_ms),
        int(interval_ms), rate_scale, rows_per_block, rt, vec4,
        scratch.data_ptr(), nchunks, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fusedgrid kernel launch failed: CUDA error {err} "
                           f"({lib.fusedgrid_error_string(err).decode()})")
    fused_grid_kernel.launches += 1
    return tuple(out.unbind(0))


fused_grid_kernel.launches = 0


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
        return self.parts_of([o.cpu().numpy() for o in self._outs])


def fused_grid_aggregate(op: str, fn: str, val, n, gids, num_groups: int,
                         out_ts: np.ndarray, window_ms: int,
                         base_ts: int, interval_ms: int, fetch: bool = True):
    """One-pass ``op(fn(metric[window]))`` partials over a grid-aligned block.

    val [S, C] f32, n [S] valid counts, gids [S] dense group ids (<
    num_groups). Returns the partial-state dict of
    ``aggregators.partial_aggregate(op, ...)`` with [num_groups, T] arrays;
    with ``fetch=False`` a :class:`PaddedPartials` whose ``resolve()`` does
    the host copy later. CUDA tensors go through K1, CPU tensors through the
    plain version; there is no other route.
    """
    assert fn in FUSED_FNS | FUSED_WINDOW_FNS and op in FUSED_OPS
    S, C = val.shape
    T = len(out_ts)
    assert fusable(S, C, T, num_groups), (S, C, T, num_groups)
    Tp = _roundup(max(T, 1), 128)
    G = _roundup(max(num_groups, 8), 8)
    band, ohlo, lo_d, hi_d, rel_d, c0, Ck = device_operands(
        C, Tp, np.ascontiguousarray(np.asarray(out_ts, np.int64)).tobytes(),
        int(window_ms), int(base_ts), int(interval_ms),
        "window" if fn in FUSED_WINDOW_FNS else "rate",
        decodereg.variant("raw").full_columns, val.device)
    needs_sumsq = op in ("stddev", "stdvar")
    n = n.to(torch.int32)
    gids = gids.to(torch.int32)
    if val.is_cuda:
        outs = fused_grid_kernel(fn, needs_sumsq, int(window_ms),
                                 int(interval_ms), val, n.contiguous(),
                                 gids.contiguous(), lo_d, hi_d, rel_d, G,
                                 c0, Ck)
    else:
        outs = fused_grid_aggregate_plain(fn, needs_sumsq, int(window_ms),
                                          int(interval_ms), val, n, gids,
                                          band, ohlo, lo_d, hi_d, rel_d, G,
                                          c0, Ck)
    padded = PaddedPartials(outs, op, num_groups, T)
    return padded.resolve() if fetch else padded


@functools.lru_cache(maxsize=8)
def zero_gids(S: int, device: torch.device):
    """Cached device zeros for single-group (global) aggregation: no fresh
    [S] upload per query."""
    return torch.zeros(S, dtype=torch.int32, device=device)
