"""Fused execution tier: the registry of single-pass query shapes.

Port of ``filodb_tpu/ops/fusedresident.py``. The reference selects a
backend per ``query.fused_kernels`` mode (Pallas, its XLA twin, or the
composed ``off`` chain); so does the port, through :func:`set_mode`. With
``"xla"`` or ``"pallas"`` (the default) the fused tier serves, and the
tensor's device picks its implementation — the hand-written CUDA kernel on
the card, the plain PyTorch twin on the CPU — so no mode can put the plain
version on a card's serving path. With ``"off"`` the planner gates
(``query/exec.py``, ``query/engine.py::_try_fused_hist``,
``parallel/distributed.py``) route every query through the composed
two-step chain (``gridfns.periodic_samples_grid`` or the general histogram
path, then the aggregators), as the reference's ``off`` does: the fused
tier's A/B baseline, chosen by config and never switched to on a failure.

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

MODES = ("off", "xla", "pallas")

# process-global, as the reference's: every serving path (the in-process
# leaf, the fused-hist engine route, the mesh) reads it at plan time. Set
# once at start from ``query.fused_kernels`` (standalone.py); tests and the
# bench suite flip it under try/finally.
_mode: str = "pallas"

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


def mode() -> str:
    """The active fused-kernel mode ("off" | "xla" | "pallas")."""
    return _mode


def set_mode(m: str) -> None:
    """Select the fused-kernel tier (config: ``query.fused_kernels``)."""
    global _mode
    if m not in MODES:
        raise ValueError(f"query.fused_kernels must be one of {MODES}, "
                         f"got {m!r}")
    _mode = m


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


K2_SEG_CELLS = 8                 # cells a prefix segment holds at most


def k2_segments(cells: np.ndarray):
    """K2's prefix segments from :func:`k2_cell_tables`' cells: the cells
    [0, cells[-1]] cut into consecutive segments that end at every needed
    cell and hold at most K2_SEG_CELLS cells each (so the kernel's per-
    segment sums are balanced work items). Returns (bounds [J + 1] i32,
    segment j holding cells [bounds[j], bounds[j + 1]); kseg [K] i32, the
    segment that ends at cells[k])."""
    bounds, kseg = [0], []
    for c in np.asarray(cells, np.int64).ravel():
        while bounds[-1] <= c:
            bounds.append(min(bounds[-1] + K2_SEG_CELLS, int(c) + 1))
        kseg.append(len(bounds) - 2)
    return np.asarray(bounds, np.int32), np.asarray(kseg, np.int32)


def k2_step_table(lo: np.ndarray, hi: np.ndarray, rel: np.ndarray):
    """K2's distinct active steps from the padded [Tp] edges: a step whose
    window holds data (hi >= 0) and whose (lo, hi, rel) no earlier step
    repeats (the engine pads a query's steps by repeating its last one).
    Returns (usteps [U] i32, those steps in order; ucol [Tp] i32, the index
    in usteps of each step's first copy, -1 where hi < 0). A repeated step's
    columns are its first copy's: the same additions in the same order."""
    lo, hi, rel = (np.asarray(a, np.int64).ravel() for a in (lo, hi, rel))
    first: dict = {}
    usteps, ucol = [], np.full(len(lo), -1, np.int32)
    for t in np.nonzero(hi >= 0)[0]:
        key = (int(lo[t]), int(hi[t]), int(rel[t]))
        if key not in first:
            first[key] = len(usteps)
            usteps.append(int(t))
        ucol[t] = first[key]
    return np.asarray(usteps, np.int32), ucol


@dataclass(frozen=True)
class HistOperands:
    """Device operands of one hist query shape: the plain twin's bands and
    edges, and K2's cell tables (see :func:`k2_cell_tables`), prefix
    segments (:func:`k2_segments`) and distinct steps
    (:func:`k2_step_table`), with their sizes as host ints."""
    band: torch.Tensor
    plo: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    rel: torch.Tensor
    slots: torch.Tensor
    kseg: torch.Tensor
    bounds: torch.Tensor
    usteps: torch.Tensor
    ucol: torch.Tensor
    cmax: int       # cells[-1]: the last cell K2 reads
    nsegs: int      # J
    nsteps: int     # U, the distinct active steps


@functools.lru_cache(maxsize=32)
def hist_device_operands(C: int, Tp: int, out_ts_key: bytes, window_ms: int,
                         base_ts: int, interval_ms: int,
                         device: torch.device) -> HistOperands:
    """:func:`hist_operands` + K2's tables on ``device``, cached per query
    shape and device."""
    out_ts = np.frombuffer(out_ts_key, np.int64)
    band, plo, lo, hi, rel = hist_operands(C, Tp, out_ts, window_ms, base_ts,
                                           interval_ms)
    cells, slots, _t0, _t1 = k2_cell_tables(C, lo, hi)
    bounds, kseg = k2_segments(cells)
    usteps, ucol = k2_step_table(lo, hi, rel)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return HistOperands(dev(band), dev(plo), dev(lo), dev(hi), dev(rel),
                        dev(slots), dev(kseg), dev(bounds), dev(usteps),
                        dev(ucol), int(cells[-1]), len(bounds) - 1,
                        len(usteps))


@functools.lru_cache(maxsize=1)
def _k2_lib():
    lib = kernels.load("fusedhist")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fusedhist_launch.restype = i
    lib.fusedhist_launch.argtypes = [
        p, i, i, i, i,                 # dd, dd_bytes, rows, C, B
        p, p, p,                       # first_d, n, gid
        p, p, p, p, p, p, p, p,        # lo, hi, rel, slots, kseg, bounds,
                                       # usteps, ucol
        i, i, i, i,                    # ncells, nsegs, cmax, nsteps
        i, i, i, i, i, ctypes.c_float,  # tp, G, fn, window, interval, scale
        i, i, i, i,                    # rows_per_block, rows_pass, tile_steps,
                                       # acc_shared
        p, i, p, p]                    # scratch, nchunks, out, stream
    lib.fusedhist_fold.restype = i
    lib.fusedhist_fold.argtypes = [p, p, i, i, i, i, i, p, p]
    lib.fusedhist_error_string.restype = ctypes.c_char_p
    lib.fusedhist_error_string.argtypes = [i]
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused_hist_kernel: {what}")


K2_THREADS = 256                 # threads per block (kThreads in fusedhist.cu)
K2_COLS = 8                      # columns a thread owns per step tile (kCols)
K2_CHUNKS = 256                  # row chunks (blocks) a launch aims at
K2_STAGE_BYTES = 32 << 10        # dd bytes a pass stages, at least
K2_MAX_ROWS = 16                 # rows a pass stages, at most
K2_PAIR_BYTES = 115_200          # shared memory that leaves two blocks an SM
K2_TERMS_BYTES = 24 << 10        # shared time-term budget per block
K2_SMEM_LIMIT = 232_448          # shared memory an H100 block may opt into
K2_SCRATCH_BYTES = 64 << 20      # per-chunk partials held under this


def k2_smem_bytes(B: int, elt: int, cmax: int, G: int, nsteps: int,
                  ncells: int, nsegs: int, rows_pass: int, tile_steps: int,
                  acc_shared: bool) -> int:
    """Shared memory of one K2 block: the sum ``layout`` in
    csrc/fusedhist.cu computes, term for term (keep the two alike) — the
    accumulator [2, G, nsteps * B] f32 when shared (rounded up to 16
    bytes); two stages of ``rows_pass`` slots, each the 16-byte-aligned
    span covering a row's cells [0, cmax] plus its first_d; the time terms
    [rows_pass, tile_steps] float4; the prefixes [rows_pass, J, B + 1] u32; F
    [rows_pass, B] f32; the terms' ok flags [rows_pass, tile_steps]; the n /
    gid ring [3, 2, rows_pass]; kseg [K] and bounds [J + 1]."""
    span = _roundup((cmax + 1) * B * elt + 15, 16)
    slot = span + _roundup(4 * B, 16)
    acc = _roundup(8 * G * nsteps * B, 16) if acc_shared else 0
    return (acc + 2 * rows_pass * slot + 16 * rows_pass * tile_steps
            + 4 * rows_pass * nsegs * (B + 1) + 4 * rows_pass * B
            + 4 * rows_pass * tile_steps + 4 * 6 * rows_pass
            + 4 * ncells + 4 * (nsegs + 1))


@dataclass(frozen=True)
class K2Shape:
    """One K2 launch: ``nchunks`` blocks of ``rows_per_block`` rows (one
    block per chunk: every step in one block, so dd is read once), staged
    ``rows_pass`` rows a pass, time terms ``tile_steps`` steps at a time,
    the accumulator in shared memory or in scratch, ``smem`` bytes."""
    rows_pass: int
    rows_per_block: int
    nchunks: int
    tile_steps: int
    acc_shared: bool
    smem: int


def k2_launch_shape(S: int, B: int, elt: int, G: int, cmax: int,
                    ncells: int, nsegs: int, nsteps: int) -> K2Shape:
    """K2's launch shape for ``nsteps`` distinct active steps. A pass
    stages at least K2_STAGE_BYTES of dd (so the next pass's copies keep
    that much in flight while this one works), at most K2_MAX_ROWS rows; a
    step tile holds at most K2_THREADS * K2_COLS columns and K2_TERMS_BYTES
    of time terms. The accumulator goes to shared memory only where the
    block still leaves room for a second one on its SM (K2_PAIR_BYTES):
    two blocks overlap one's barrier-bound phases with the other's work,
    and a column's current group sits in registers, so the scratch slice
    is touched only when a row's group differs from the last. K2_CHUNKS
    chunks (one wave at two blocks an SM), fewer for small S or where the
    partials would pass 64 MB."""
    slot = _roundup((cmax + 1) * B * elt + 15, 16) + _roundup(4 * B, 16)
    want = max(1, min(K2_MAX_ROWS, -(-K2_STAGE_BYTES // slot)))

    def fit(acc_shared, rp):
        ts = max(1, min(max(nsteps, 1), K2_THREADS * K2_COLS // B,
                        K2_TERMS_BYTES // (20 * rp)))
        return ts, k2_smem_bytes(B, elt, cmax, G, nsteps, ncells, nsegs, rp,
                                 ts, acc_shared)
    for acc_shared, rp, limit in [(True, want, K2_PAIR_BYTES)] + [
            (False, rp, K2_SMEM_LIMIT) for rp in range(want, 0, -1)]:
        ts, smem = fit(acc_shared, rp)
        if smem <= limit:
            break
    else:
        raise ValueError(f"fused_hist_kernel: no launch shape fits B={B} "
                         f"cmax={cmax} G={G} steps={nsteps}")
    per_chunk = 8 * G * max(nsteps * B, 1)
    nchunks = max(1, min(-(-S // rp), K2_CHUNKS,
                         K2_SCRATCH_BYTES // per_chunk))
    rows_per_block = -(-S // nchunks)
    return K2Shape(rp, rows_per_block, -(-S // rows_per_block), ts,
                   acc_shared, smem)


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
    i32), slots ([3, Tp] i32), kseg ([K] i32), bounds ([J + 1] i32), usteps
    ([U] i32), ucol ([Tp] i32); ncells (K), nsegs (J), cmax, nsteps (U);
    tp, groups, fn
    (K2_FN_CODES), window_ms, interval_ms, rate_scale (f32 of 1000.0 /
    window_ms); rows_per_block, rows_pass, tile_steps, acc_shared (the
    launch shape); scratch ([nchunks, 2, G, U * B] f32), nchunks,
    out ([2, G, Tp*B] f32), stream. It launches the map (when a step is
    active) and the fold, and returns cudaGetLastError() after each."""
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
                    ("slots", ops.slots), ("kseg", ops.kseg),
                    ("bounds", ops.bounds), ("usteps", ops.usteps),
                    ("ucol", ops.ucol)):
        _require(t.device == dev and t.dtype == torch.int32
                 and t.is_contiguous(), f"{name} must be int32 on {dev}")
    ncells = ops.kseg.numel()
    _require(ops.slots.numel() == 3 * Tp and 1 <= ncells <= C
             and ops.kseg.numel() == ncells
             and ops.bounds.numel() == ops.nsegs + 1 and ops.cmax < C
             and ops.usteps.numel() == ops.nsteps and ops.ucol.numel() == Tp,
             "cell tables do not match the edges")
    shape = k2_launch_shape(S, B, dd.element_size(), G, ops.cmax, ncells,
                            ops.nsegs, ops.nsteps)
    ncols = ops.nsteps * B
    scratch = torch.empty((shape.nchunks, 2, G, max(ncols, 1)),
                          dtype=torch.float32, device=dev)
    out = torch.empty((2, G, Tp * B), dtype=torch.float32, device=dev)
    rate_scale = float(np.float32(1000.0 / window_ms))
    lib = _k2_lib()
    # the <<<>>> launch runs on the thread's current device: make it dd's
    with torch.cuda.device(dev):
        err = lib.fusedhist_launch(
            dd.data_ptr(), dd.element_size(), S, C, B,
            first_d.data_ptr(), n.data_ptr(), gids.data_ptr(),
            ops.lo.data_ptr(), ops.hi.data_ptr(), ops.rel.data_ptr(),
            ops.slots.data_ptr(), ops.kseg.data_ptr(), ops.bounds.data_ptr(),
            ops.usteps.data_ptr(), ops.ucol.data_ptr(),
            ncells, ops.nsegs, ops.cmax, ops.nsteps,
            Tp, G, K2_FN_CODES[fn], int(window_ms), int(interval_ms),
            rate_scale, shape.rows_per_block, shape.rows_pass,
            shape.tile_steps, int(shape.acc_shared), scratch.data_ptr(),
            shape.nchunks, out.data_ptr(),
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
