"""Fused execution tier: the registry of single-pass query shapes.

Port of ``filodb_tpu/ops/fusedresident.py``. The reference selects a
backend per ``query.fused_kernels`` mode (Pallas, its XLA twin, or the
composed ``off`` chain). The port has no mode: the tensor's device picks the
implementation — the hand-written CUDA kernel on the card, the plain
PyTorch twin on the CPU — so no switch can put the plain version on a
card's serving path. The composed ``off`` chain arrives with a later slice.

Shapes:

  shape           query pattern                         kernel
  --------------  ------------------------------------  ---------------------
  rate_sum        sum/avg/...(rate|increase|delta)      K1 (ops/fusedgrid.py)
  window_reduce   sum/...(avg|sum|count_over_time)      K1 (ops/fusedgrid.py)
  hist_quantile   histogram_quantile(q, sum(fn(h[w])))  K2 (this module,
                  over i8/i16 2D-delta-resident blocks   csrc/fusedhist.cu)

The hist_quantile map phase exists twice here, as K1's does in fusedgrid:
K2, ``csrc/fusedhist.cu``, the hand-written CUDA kernel that replaces the
Pallas kernel ``build_hist_pallas``; and :func:`fused_hist_map_plain`, the
plain PyTorch twin walking the reference's [Sb] row tiles through the same
:func:`hist_tile_contrib` math and one-hot :func:`_hist_fold`. The f64
quantile finish is torch ops (``gridfns.histogram_quantile``), not a kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.metrics import (FILODB_QUERY_FUSED_FALLBACK,
                             FILODB_QUERY_FUSED_SERVED, registry)
from . import fusedgrid, gridfns, kernels

HIST_FUSED_FNS = frozenset({"rate", "increase", "delta"})
MAX_BUCKETS = 64    # the reference's cap ([Sb, C, B] tile + accumulators in VMEM)

# shape name -> (window fns, reduce ops) it serves; exec.py and engine.py
# consult it for plan-time eligibility
FUSED_SHAPES = {
    "rate_sum": (frozenset(fusedgrid.FUSED_FNS),
                 frozenset(fusedgrid.FUSED_OPS)),
    "window_reduce": (frozenset(fusedgrid.FUSED_WINDOW_FNS),
                      frozenset(fusedgrid.FUSED_OPS)),
    "hist_quantile": (HIST_FUSED_FNS, frozenset({"sum"})),
}

# K2's function codes (enum Fn in csrc/fusedhist.cu)
K2_FN_CODES = {"rate": 0, "increase": 1, "delta": 2}

_roundup = fusedgrid._roundup


def scalar_shape_of(fn: str) -> str | None:
    """Registry shape serving a scalar window fn, or None."""
    for shape in ("rate_sum", "window_reduce"):
        if fn in FUSED_SHAPES[shape][0]:
            return shape
    return None


def backend_of(t) -> str:
    """Which implementation a tensor's device selects: "cuda" (the
    hand-written kernels) or "plain" (the PyTorch twins, CPU tensors)."""
    return "cuda" if t.is_cuda else "plain"


def count_served(shape: str, backend: str) -> None:
    registry.counter(FILODB_QUERY_FUSED_SERVED,
                     {"shape": shape, "mode": backend}).increment()


def count_fallback(shape: str) -> None:
    """A query matched a fused shape but took another route (shape gate,
    group cap, off-grid store, ...)."""
    registry.counter(FILODB_QUERY_FUSED_FALLBACK, {"shape": shape}).increment()


def scalar_aggregate(op: str, fn: str, val, n, gids, num_groups: int,
                     out_ts: np.ndarray, window_ms: int, base_ts: int,
                     interval_ms: int, fetch: bool = True, narrow=None):
    """One-pass ``op(fn(metric[w]))`` partials (operand contracts: see
    fusedgrid.fused_grid_aggregate; ``narrow=(kind, operands)`` streams a
    registered narrow block, ops/decodereg.py). The caller checked
    eligibility."""
    out = fusedgrid.fused_grid_aggregate(
        op, fn, val, n, gids, num_groups, out_ts, window_ms, base_ts,
        interval_ms, fetch=fetch, narrow=narrow)
    # ``n``: ``val`` may be a narrow store's deferred view
    count_served(scalar_shape_of(fn) or "rate_sum", backend_of(n))
    return out


# ---------------------------------------------------------------------------
# hist_quantile: fused histogram_quantile over i8/i16 2D-delta-resident
# [S, C, B] blocks — the decoded f32 store never exists
# ---------------------------------------------------------------------------

def hist_fusable(S: int, C: int, T: int, B: int, num_groups: int) -> bool:
    """Shape gate (the reference's, unchanged, so both packages take the
    same route). There is no active-column slicing: the quantile's
    first-sample prefix needs every column from cell 0."""
    return (C <= fusedgrid.MAX_CAPACITY
            and _roundup(max(T, 1), 128) * B <= fusedgrid.MAX_STEPS * 8
            and num_groups <= fusedgrid.MAX_GROUPS
            and 0 < B <= MAX_BUCKETS
            and (S % 512 == 0 or (S <= 512 and S % 8 == 0)))


def hist_tile_contrib(fn: str, window_ms: int, interval_ms: int, B: int,
                      ddf, first_d, n, band_open, prefix_lo, lo, hi, rel):
    """Per-tile math of the hist_quantile shape, the reference's
    hist_tile_contrib in PyTorch: the decoded 2D-delta tile ``ddf [Sb, Ca,
    B]`` (+ ``first_d [Sb, B]`` first-frame bucket deltas, ``n [Sb, 1]``
    valid counts) -> ``(contrib, okf)``, both ``[Sb, Tp*B]`` flat in the
    aggregators layout (t*B + b).

    The window delta of cumulative buckets is ``cumsum_b(dd @ band_open)``
    and the first-sample value ``F + cumsum_b(dd @ prefix_lo)``: every
    reduction is linear in the frames, so the products read the narrow dd
    encoding directly."""
    f32 = torch.float32
    Sb, Ca, _B = ddf.shape
    Tp = band_open.shape[1]
    flat = ddf.permute(0, 2, 1).reshape(Sb * B, Ca)           # [Sb*B, Ca]
    delta = torch.cumsum((flat @ band_open).reshape(Sb, B, Tp), dim=1)
    F = torch.cumsum(first_d, dim=1)                          # [Sb, B]
    f_v = F[:, :, None] + torch.cumsum(
        (flat @ prefix_lo).reshape(Sb, B, Tp), dim=1)

    last_cell = n - 1                                         # [Sb, 1]
    f_idx = torch.clamp(lo, min=0)                            # [1, Tp]
    l_idx = torch.minimum(hi, last_cell)                      # [Sb, Tp]
    cnt = torch.clamp(l_idx - f_idx + 1, min=0)
    cnt_f = cnt.to(f32)
    relf = rel.to(f32)
    f_rel = (f_idx * interval_ms).to(f32)
    l_rel = (l_idx * interval_ms).to(f32)
    # a 0-dim tensor, not a Python scalar: CUDA's division by a host scalar
    # multiplies by its reciprocal (one rounding off), and the twin must
    # round alike on both devices
    k1000 = torch.full((), 1000.0, dtype=f32, device=rel.device)
    dur_start = (f_rel - (relf - window_ms)) / k1000          # [Sb, Tp]
    dur_end = (relf - l_rel) / k1000
    sampled = (l_rel - f_rel) / k1000
    avg_dur = sampled / (cnt_f - 1.0)
    thresh = avg_dur * 1.1
    if fn != "delta":
        # per-bucket counter zero-clamp (the composed narrow kernel's)
        dur_zero = torch.where(delta > 0,
                               sampled[:, None, :] * (f_v / delta),
                               float("inf"))
        ds = torch.broadcast_to(dur_start[:, None, :], delta.shape)
        ds = torch.where((delta > 0) & (f_v >= 0) & (dur_zero < ds),
                         dur_zero, ds)
        extrap = (sampled[:, None, :]
                  + torch.where(ds < thresh[:, None, :], ds,
                                avg_dur[:, None, :] / 2)
                  + torch.where(dur_end[:, None, :] < thresh[:, None, :],
                                dur_end[:, None, :], avg_dur[:, None, :] / 2))
        factor = extrap / sampled[:, None, :]
    else:
        extrap = (sampled
                  + torch.where(dur_start < thresh, dur_start, avg_dur / 2)
                  + torch.where(dur_end < thresh, dur_end, avg_dur / 2))
        factor = (extrap / sampled)[:, None, :]
    scaled = delta * factor
    if fn == "rate":
        scaled = scaled * (1000.0 / window_ms)

    ok = cnt >= 2                                             # [Sb, Tp]
    contrib = torch.where(ok[:, None, :], scaled, 0.0)        # [Sb, B, Tp]
    okb = torch.broadcast_to(ok[:, None, :], contrib.shape).to(f32)
    return (contrib.permute(0, 2, 1).reshape(Sb, Tp * B),
            okb.permute(0, 2, 1).reshape(Sb, Tp * B))


def _hist_fold(G: int, gid, contrib, okf):
    """Per-group fold of one tile's flat [Sb, Tp*B] contributions: a one-hot
    product, as on the reference's MXU. A row whose gid lies outside [0, G)
    (the engine's excluded cohort-pool rows) multiplies by zeros."""
    gcol = torch.arange(G, dtype=torch.int32, device=contrib.device)[None, :]
    oh = (gcol == gid).to(torch.float32).T                    # [G, Sb]
    return oh @ contrib, oh @ okf


def fused_hist_map_plain(fn: str, window_ms: int, interval_ms: int, dd,
                         first_d, n, gids, band, plo, lo, hi, rel, G: int):
    """Plain PyTorch twin of K2: walks the reference's [Sb, C, B] row tiles
    (Sb = 512, or S when S <= 512) through :func:`hist_tile_contrib` and
    :func:`_hist_fold`. Returns (sum, count), [G, Tp*B] f32 each."""
    S, C, B = dd.shape
    Tp = band.shape[1]
    Sb = 512 if S % 512 == 0 else S
    dev = dd.device
    psum = torch.zeros((G, Tp * B), dtype=torch.float32, device=dev)
    pcnt = torch.zeros((G, Tp * B), dtype=torch.float32, device=dev)
    n2 = n.to(torch.int32).reshape(S, 1)
    g2 = gids.to(torch.int32).reshape(S, 1)
    for i in range(0, S, Sb):
        # the tile math consumes dd directly: its band products and bucket
        # cumsums are the decode, so the widen is the i8/i16 -> f32 cast
        contrib, okf = hist_tile_contrib(
            fn, window_ms, interval_ms, B,
            dd[i:i + Sb].float(), first_d[i:i + Sb],
            n2[i:i + Sb], band, plo, lo, hi, rel)
        s, c = _hist_fold(G, g2[i:i + Sb], contrib, okf)
        psum += s
        pcnt += c
    return psum, pcnt


def hist_operands(C: int, Tp: int, out_ts: np.ndarray, window_ms: int,
                  base_ts: int, interval_ms: int):
    """Host operands of the hist tier: the open band for window deltas, the
    prefix band selecting v at the lo cells (cells (0, l0] — it needs every
    column from 0, hence no active-column slicing), padded edges.
    (band, plo, lo[1,Tp], hi[1,Tp], rel[1,Tp])."""
    T = len(out_ts)
    lo, hi = gridfns.grid_edges(out_ts, window_ms, base_ts, interval_ms)
    rel = out_ts - base_ts
    lo_p, hi_p, rel_p = fusedgrid.pad_edges(lo, hi, rel, window_ms, Tp)
    band = np.zeros((C, Tp), np.float32)
    band[:, :T] = gridfns.band_matrix(C, lo, hi, True, np.float32)
    l0 = np.maximum(lo, 0)
    plo = np.zeros((C, Tp), np.float32)
    plo[:, :T] = gridfns.band_matrix(C, np.zeros(T, np.int64),
                                     np.minimum(l0, C - 1), True, np.float32)
    return (band, plo, lo_p, hi_p, rel_p)


def k2_cell_tables(C: int, lo: np.ndarray, hi: np.ndarray):
    """K2's per-query tables from the padded [Tp] edges: the sorted cells
    whose 2D prefix a row needs (cell 0 first), and per step the slots in
    that list of min(hi, C-1), min(lo, C-1) and the first-sample cell
    min(max(lo, 0), C-1) (-1 where the prefix is empty), plus the active
    step range [t0, t1) (steps with hi >= 0; the others add nothing).
    Returns (cells [K] i32, slots [3, Tp] i32, t0, t1)."""
    lo = np.asarray(lo, np.int64).ravel()
    hi = np.asarray(hi, np.int64).ravel()
    Tp = len(lo)
    act = np.nonzero(hi >= 0)[0]
    hc = np.minimum(hi, C - 1)
    lc = np.minimum(lo, C - 1)
    fc = np.minimum(np.maximum(lo, 0), C - 1)
    need = [np.zeros(1, np.int64)]
    if len(act):
        need += [hc[act], lc[act][lc[act] >= 0], fc[act]]
    cells = np.unique(np.concatenate(need))
    slot_of = {int(c): i for i, c in enumerate(cells)}
    slots = np.full((3, Tp), -1, np.int32)
    for t in act:
        slots[0, t] = slot_of[int(hc[t])]
        slots[1, t] = slot_of[int(lc[t])] if lc[t] >= 0 else -1
        slots[2, t] = slot_of[int(fc[t])] if fc[t] >= 1 else -1
    t0, t1 = (int(act[0]), int(act[-1]) + 1) if len(act) else (0, 0)
    return cells.astype(np.int32), slots, t0, t1


@dataclass(frozen=True)
class HistOperands:
    """Device operands of one hist query shape: the plain twin's bands and
    edges, and K2's cell tables (see :func:`k2_cell_tables`)."""
    band: torch.Tensor
    plo: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    rel: torch.Tensor
    cells: torch.Tensor
    slots: torch.Tensor
    t0: int
    t1: int


@functools.lru_cache(maxsize=32)
def hist_device_operands(C: int, Tp: int, out_ts_key: bytes, window_ms: int,
                         base_ts: int, interval_ms: int,
                         device: torch.device) -> HistOperands:
    """:func:`hist_operands` + K2's tables on ``device``, cached per query
    shape and device."""
    out_ts = np.frombuffer(out_ts_key, np.int64)
    band, plo, lo, hi, rel = hist_operands(C, Tp, out_ts, window_ms, base_ts,
                                           interval_ms)
    cells, slots, t0, t1 = k2_cell_tables(C, lo, hi)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return HistOperands(dev(band), dev(plo), dev(lo), dev(hi), dev(rel),
                        dev(cells), dev(slots), t0, t1)


@functools.lru_cache(maxsize=1)
def _k2_lib():
    lib = kernels.load("fusedhist")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fusedhist_launch.restype = i
    lib.fusedhist_launch.argtypes = [
        p, i, i, i, i,                 # dd, dd_bytes, rows, C, B
        p, p, p,                       # first_d, n, gid
        p, p, p, p, p, i, i, i,        # lo, hi, rel, cells, slots, ncells, t0, t1
        i, i, i, i, i, ctypes.c_float,  # tp, G, fn, window, interval, scale
        i, i, i,                       # rows_per_block, rows_per_pass, tile_steps
        p, i, p, p]                    # scratch, nchunks, out, stream
    lib.fusedhist_fold.restype = i
    lib.fusedhist_fold.argtypes = [p, p, i, i, p]
    lib.fusedhist_error_string.restype = ctypes.c_char_p
    lib.fusedhist_error_string.argtypes = [i]
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused_hist_kernel: {what}")


K2_THREADS = 256                 # threads per block (kThreads in fusedhist.cu)
K2_ACC_BYTES = 64 << 10          # shared accumulator budget per block
K2_PREFIX_BYTES = 96 << 10       # shared 2D-prefix budget per block
K2_SCRATCH_BYTES = 64 << 20      # per-block partials held under this


def k2_launch_shape(S: int, B: int, Tp: int, G: int, ncells: int,
                    t0: int, t1: int):
    """(rows per pass, rows per block, row chunks, steps per tile, tiles) of
    one K2 launch: a block stages ``rows per pass`` rows' prefixes at a
    time and accumulates a [2, G, steps per tile * B] tile in shared
    memory; about 1024 blocks in all, scratch under 64 MB."""
    rows_pass = max(1, min(K2_THREADS // B,
                           K2_PREFIX_BYTES // (ncells * B * 4)))
    tile_steps = max(1, min(max(t1 - t0, 1), K2_ACC_BYTES // (8 * G * B)))
    ntiles = max(1, -(-(t1 - t0) // tile_steps))
    nchunks = min(-(-S // rows_pass), max(1, 1024 // ntiles),
                  max(1, K2_SCRATCH_BYTES // (2 * G * Tp * B * 4)))
    nchunks = max(1, nchunks)
    rows_per_block = -(-S // nchunks)
    return rows_pass, rows_per_block, -(-S // rows_per_block), tile_steps, ntiles


def fused_hist_kernel(fn: str, window_ms: int, interval_ms: int, dd, first_d,
                      n, gids, ops: HistOperands, G: int):
    """Launch K2 on ``dd``'s card; returns (sum, count), [G, Tp*B] f32.

    Checks what the kernel takes and raises on anything else: ``dd`` a
    contiguous CUDA int8/int16 [S, C, B] tensor inside the shape gate
    (:func:`hist_fusable`); ``first_d`` contiguous f32 [S, B]; ``n``/
    ``gids`` contiguous int32 [S]; the operands of ``ops`` on the same
    device. Launches on the current stream and does not synchronise.

    C interface (``fusedhist_launch`` in csrc/fusedhist.cu), in order: dd,
    dd_bytes (1 or 2), rows (S), C, B; first_d, n, gid; lo, hi, rel ([Tp]
    i32), cells ([K] i32), slots ([3, Tp] i32), ncells (K), t0, t1 (active
    steps); tp, groups, fn (K2_FN_CODES), window_ms, interval_ms,
    rate_scale (f32 of 1000.0 / window_ms); rows_per_block, rows_per_pass,
    tile_steps (the launch shape); scratch ([nchunks, 2, G, Tp*B] f32,
    zeroed), nchunks, out ([2, G, Tp*B] f32), stream. It returns
    cudaGetLastError() after each of its two launches."""
    _require(fn in K2_FN_CODES, f"unknown fn {fn!r}")
    _require(dd.is_cuda, "dd must be a CUDA tensor")
    _require(dd.dtype in (torch.int8, torch.int16),
             f"dd must be int8 or int16, got {dd.dtype}")
    _require(dd.dim() == 3 and dd.is_contiguous(),
             "dd must be a contiguous [S, C, B] block")
    S, C, B = dd.shape
    dev = dd.device
    Tp = ops.lo.numel()
    _require(Tp % 128 == 0, f"Tp={Tp} not a multiple of 128")
    _require(hist_fusable(S, C, Tp, B, G) and G >= 1,
             f"shape S={S} C={C} Tp={Tp} B={B} G={G} outside the gate")
    _require(first_d.device == dev and first_d.dtype == torch.float32
             and first_d.is_contiguous() and tuple(first_d.shape) == (S, B),
             f"first_d must be contiguous f32 [{S}, {B}] on {dev}")
    for name, t in (("n", n), ("gids", gids)):
        _require(t.device == dev and t.dtype == torch.int32
                 and t.is_contiguous() and t.numel() == S,
                 f"{name} must be contiguous int32 [{S}] on {dev}")
    for name, t in (("lo", ops.lo), ("hi", ops.hi), ("rel", ops.rel),
                    ("cells", ops.cells), ("slots", ops.slots)):
        _require(t.device == dev and t.dtype == torch.int32
                 and t.is_contiguous(), f"{name} must be int32 on {dev}")
    ncells = ops.cells.numel()
    _require(ops.slots.numel() == 3 * Tp and 1 <= ncells <= C,
             "cell tables do not match the edges")
    rows_pass, rows_per_block, nchunks, tile_steps, ntiles = k2_launch_shape(
        S, B, Tp, G, ncells, ops.t0, ops.t1)
    scratch = torch.zeros((nchunks, 2, G, Tp * B), dtype=torch.float32,
                          device=dev)
    out = torch.empty((2, G, Tp * B), dtype=torch.float32, device=dev)
    rate_scale = float(np.float32(1000.0 / window_ms))
    lib = _k2_lib()
    err = lib.fusedhist_launch(
        dd.data_ptr(), dd.element_size(), S, C, B,
        first_d.data_ptr(), n.data_ptr(), gids.data_ptr(),
        ops.lo.data_ptr(), ops.hi.data_ptr(), ops.rel.data_ptr(),
        ops.cells.data_ptr(), ops.slots.data_ptr(), ncells, ops.t0, ops.t1,
        Tp, G, K2_FN_CODES[fn], int(window_ms), int(interval_ms), rate_scale,
        rows_per_block, rows_pass, tile_steps,
        scratch.data_ptr(), nchunks, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fusedhist kernel launch failed: CUDA error {err} "
                           f"({lib.fusedhist_error_string(err).decode()})")
    kernels.count_launch(fused_hist_kernel)
    return out[0], out[1]


fused_hist_kernel.launches = 0


def fused_hist_map(fn: str, window_ms: int, interval_ms: int, dd, first_d,
                   n, gids, ops: HistOperands, G: int):
    """The hist_quantile map phase: K2 for CUDA tensors, the plain twin for
    CPU tensors; there is no other route."""
    n = n.to(torch.int32)
    gids = gids.to(torch.int32)
    if dd.is_cuda:
        return fused_hist_kernel(fn, window_ms, interval_ms, dd,
                                 first_d.contiguous(), n.contiguous(),
                                 gids.contiguous(), ops, G)
    return fused_hist_map_plain(fn, window_ms, interval_ms, dd, first_d, n,
                                gids, ops.band, ops.plo, ops.lo, ops.hi,
                                ops.rel, G)


def fused_hist_quantile_resident(q: float, les, dd, first_d, n, gids,
                                 num_groups: int, out_ts: np.ndarray,
                                 window_ms: int, fn: str, base_ts: int,
                                 interval_ms: int, corr=None):
    """histogram_quantile(q, sum by(...)(fn(h[w]))) over a hist-resident
    store: the map phase (K2 / its twin) — per-bucket window deltas and the
    group fold with the [S, C, B] f32 decode never materialized — then the
    shared finish: slice the padded partials to the true steps, fold the
    cohort-pool correction partials in (``corr = (sum, cnt)``, [G', T*B],
    those rows' gids excluded here), mask empty groups and run the f64
    quantile. Returns [G, T] f64."""
    assert fn in HIST_FUSED_FNS
    S, C, B = dd.shape
    T = len(out_ts)
    G = _roundup(max(num_groups, 8), 8)
    assert hist_fusable(S, C, T, B, G), (S, C, T, B, G)
    Tp = _roundup(max(T, 1), 128)
    ops = hist_device_operands(
        C, Tp, np.ascontiguousarray(np.asarray(out_ts, np.int64)).tobytes(),
        int(window_ms), int(base_ts), int(interval_ms), dd.device)
    psum, pcnt = fused_hist_map(fn, int(window_ms), int(interval_ms), dd,
                                first_d, n, gids, ops, G)
    return hist_finish(q, les, psum, pcnt, T, B, corr)


def hist_finish(q: float, les, psum, pcnt, T: int, B: int, corr=None):
    """The shared finish of the hist_quantile shape (the reference's
    _hist_finish_program as torch f64 ops): slice the padded [G, Tp*B]
    partials to the true steps, fold the cohort-pool correction partials in,
    mask empty groups, run the quantile. Returns [G, T] f64."""
    G = psum.shape[0]
    Tp = psum.shape[1] // B
    ps = psum.reshape(G, Tp, B)[:, :T, :].reshape(G, T * B)
    pc = pcnt.reshape(G, Tp, B)[:, :T, :].reshape(G, T * B)
    if corr is not None:
        corr_sum, corr_cnt = corr
        if corr_sum.shape[0] != G:
            # corr partials come at the engine's pow2 group bucket, which
            # sits below the 8-aligned G for small group counts: pad with
            # empty groups (masked by pc == 0, sliced off by the caller)
            pad = (0, 0, 0, G - corr_sum.shape[0])
            corr_sum = torch.nn.functional.pad(corr_sum, pad)
            corr_cnt = torch.nn.functional.pad(corr_cnt, pad)
        ps = ps + corr_sum
        pc = pc + corr_cnt
    summed = torch.where(pc == 0, float("nan"), ps)
    return gridfns.histogram_quantile(q, les, summed.reshape(G, T, B))
