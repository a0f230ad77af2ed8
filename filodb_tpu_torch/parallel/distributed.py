"""Query execution over the shards of a dataset spread across a device mesh.

Port of ``filodb_tpu/parallel/distributed.py`` (ref: the Akka scatter-gather
plane — ExecPlans dispatched to per-shard QueryActors, partial aggregates
reduced on the calling node; coordinator/.../queryengine2/
QueryEngine.scala:59-67). A mesh is an ordered list of ``torch.device``s.
With ``ns = slots * ndev`` shards placed round-robin (shard ``i`` on device
``i % ndev``, standalone's placement), slot ``j`` holds shards
``j * ndev + d``. On one card the shard axis is slots on that card
(``["cuda"]``); the CPU tests pass ``["cpu"] * 8``.

Every ``dist_*`` function below runs the per-shard map phase on each
shard's own device, eagerly, and keeps the per-shard partial state
unfolded (slot-major, device-minor). Where the reference wraps the same
body in one sharded XLA program (``shard_map`` / ``pjit``), the port
launches per shard: K1 once per shard for the fused routes
(``fusedgrid.fused_grid_partials``, its plain twin on the CPU), the range
function and the stable segment reduce per shard for the two-step route.

The cross-shard fold is never a device reduction: :class:`LazyMeshResult`
copies the partials to the host and folds them in shard order in f64,
seeded with shard 0's, exactly as the host scatter-gather merge
(``query/exec._merge_partials``) does, then presents them with the same
``aggregators.present_partials``. So a mesh answer is bit-equal to the host
loop's over the same shards. Sketch counts are integers in f32, exact under
any summation order.

Each shard's [S, T] range-function matrix (two-step, sketch, topk routes) is
computed the way the host leaf computes it on that shard: through the grid
kernels when the shard is grid-aligned with one start cohort and the
function has a grid form, else through the row-chunked general path
(``rangefns.periodic_samples``, at most ``rangefns.CHUNK_BYTES`` of
transients a chunk). The reference's mesh always takes its general kernel;
the port's choice keeps the answers within the reference's bar and makes
them bit-equal to the port's own host loop.

Deliberately not lowered, as in the reference: count_values (its partial
state is keyed by rendered value strings).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceUnavailable, resolve_device
from ..ops import aggregators, decodereg, fusedgrid, fusedresident, gridfns
from ..ops import rangefns
from ..query.exec import _pad_steps, _pow2
from ..utils.metrics import (FILODB_QUERY_MESH_FALLBACK,
                             FILODB_QUERY_MESH_SERVED, registry)

# the program mode a mesh query runs in: the port launches per shard,
# eagerly (the reference's pjit / shard_map modes are XLA program forms)
MESH_MODE = "eager"


def make_mesh(devices=None) -> list[torch.device]:
    """The mesh: ``devices`` resolved in order, or every CUDA device.
    Without a card and without ``devices`` it raises
    :class:`DeviceUnavailable` (pass ``["cpu"] * n`` to run on the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available on this host; pass the mesh's devices "
                "(e.g. [\"cpu\"] * 8) to run it on the CPU explicitly")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def count_mesh_served(route: str, mode: str = MESH_MODE) -> None:
    registry.counter(FILODB_QUERY_MESH_SERVED,
                     {"route": route, "mode": mode}).increment()


def count_mesh_fallback(reason: str) -> None:
    """A mesh-eligible dispatch took the host scatter-gather path after
    eligibility (order-statistic caps)."""
    registry.counter(FILODB_QUERY_MESH_FALLBACK,
                     {"reason": reason}).increment()


class DistributedStore:
    """Per-slot views of the shards' stores, each tensor on its shard's own
    device. The reference assembles zero-copy global arrays [NDEV, S, C];
    the port keeps per-shard tensor lists, slot-major and device-minor:
    ``out[j][d]`` belongs to shard ``j * ndev + d``."""

    def __init__(self, mesh, shards):
        self.mesh = list(mesh)
        self.shards = shards
        ns, ndev = len(shards), len(self.mesh)
        assert ns % ndev == 0, "shards must divide evenly over mesh devices"
        self.slots = ns // ndev
        self.ndev = ndev
        s0 = shards[0].store
        self.S, self.C = s0.S, s0.C

    def _slot(self, j: int):
        return [self.shards[j * self.ndev + d] for d in range(self.ndev)]

    def stores(self):
        """Per-slot lists of the shards' stores: a shard's range-function
        matrix reads its grid and, only off the grid path, its timestamps
        (the reference's ``arrays()`` hands every shard's (ts, val, n), a
        transient decode of both on a narrow-resident store)."""
        return [[sh.store for sh in self._slot(j)] for j in range(self.slots)]

    def value_arrays(self):
        """Per-slot lists of (val, (), n), the fused route's raw operands:
        it never reads ts, and a narrow-resident shard contributes a
        transient f32 decode on its own device."""
        return [[(sh.store.value_block(), (), sh.store.n)
                 for sh in self._slot(j)] for j in range(self.slots)]

    def narrow_arrays(self):
        """``(kind, slots)``: per-slot lists of (block, row_operands, n) of
        the narrow-resident state, or None unless every shard is
        narrow-resident with one decode variant and no live cohort-pool rows
        (a pool row would need a per-shard correction; such stores take the
        fused route over a transient f32 decode instead)."""
        per_shard, kinds = [], set()
        for sh in self.shards:
            nd = sh.store.narrow_operands()
            if nd is None:
                return None
            kind, ops, ok = nd
            if (~ok & (sh.store.n_host > 0)).any():
                return None
            kinds.add(kind)
            per_shard.append(ops)
        if len(kinds) != 1:
            return None
        out = []
        for j in range(self.slots):
            ops = per_shard[j * self.ndev:(j + 1) * self.ndev]
            out.append([(o[0], tuple(o[1:]), sh.store.n)
                        for o, sh in zip(ops, self._slot(j))])
        return kinds.pop(), out

    def global_gids(self, group_ids_per_shard):
        """Per-slot lists of int32 [S] group-id tensors, each on its
        shard's device (one host array per shard, in shard order)."""
        return [[torch.from_numpy(np.ascontiguousarray(
                    group_ids_per_shard[j * self.ndev + d], np.int32))
                 .to(sh.store.n.device)
                 for d, sh in enumerate(self._slot(j))]
                for j in range(self.slots)]


def _shard_matrix(store, fn, out_eval, window_ms, a0, a1, stale_ms):
    """One shard's [S, T'] range-function matrix, computed as the host leaf
    computes it on the whole shard: the grid kernels on a grid-aligned store
    with one start cohort (at the cohort's cell), else the general path."""
    grid = store.grid_info()
    if grid is not None and fn in gridfns.GRID_FNS:
        kind, off = store.grid_cohorts()
        base = grid[0] + off * grid[1] if kind == "uniform" else None
        if (base is not None
                and max(abs(int(out_eval[0]) - base),
                        abs(int(out_eval[-1]) - base)) + window_ms < 2**31):
            return gridfns.periodic_samples_grid(
                store.value_block(), store.n, out_eval, window_ms, fn, base,
                grid[1], stale_ms=stale_ms)
    return rangefns.periodic_samples(store.ts_block(), store.value_block(),
                                     store.n, out_eval, window_ms, fn, a0, a1)


def _slot_matrices(slot_stores, slot_gids, out_eval, window_ms, a0, a1,
                   stale_ms, fn):
    """Yield (slot, device, matrix, gids) for every shard, slot-major."""
    for j, (stores, gids) in enumerate(zip(slot_stores, slot_gids)):
        for d, (st, g) in enumerate(zip(stores, gids)):
            yield j, d, _shard_matrix(st, fn, out_eval, window_ms, a0, a1,
                                      stale_ms), g


def dist_aggregate(slot_stores, slot_gids, out_eval, window_ms, a0, a1,
                   fn: str, op: str, num_groups: int, stale_ms: int):
    """The two-step map phase: per shard the range-function matrix and its
    STABLE segment partials (the host composed path's reduce). Returns the
    unfolded partials, ``parts[j][d]``, for the host-order fold."""
    parts = [[None] * len(s) for s in slot_stores]
    for j, d, mat, gids in _slot_matrices(slot_stores, slot_gids, out_eval,
                                          window_ms, a0, a1, stale_ms, fn):
        parts[j][d] = aggregators.partial_aggregate(op, mat, gids,
                                                    num_groups, stable=True)
    return parts


def dist_quantile_sketch(slot_stores, slot_gids, out_eval, window_ms, a0, a1,
                         fn: str, num_groups: int, stale_ms: int):
    """Quantile map phase: per shard the range-function matrix's log-bucket
    counts (``aggregators.quantile_sketch``'s bucket rules) over its
    selected rows, summed per device, then across devices on the host.
    Returns [G, W, T'] f32 host counts (integers: exact in any order)."""
    per_dev: dict = {}
    for _j, d, mat, gids in _slot_matrices(slot_stores, slot_gids, out_eval,
                                           window_ms, a0, a1, stale_ms, fn):
        # rows outside the selection carry an out-of-range group id
        sel = gids < num_groups
        c = aggregators.quantile_sketch(mat[sel], gids[sel], num_groups)
        per_dev[d] = c if d not in per_dev else per_dev[d] + c
    total = None
    for d in sorted(per_dev):
        c = per_dev[d].cpu().numpy()
        total = c if total is None else total + c
    return total


def dist_topk(slot_stores, slot_gids, out_eval, window_ms, a0, a1,
              fn: str, k: int, bottom: bool, num_groups: int, stale_ms: int):
    """topk/bottomk: per-shard top-k candidates per (group, step), then one
    gather of the fixed-size candidate blocks and a global re-select. The
    candidates line up device-major, then slot, then rank — the reference's
    all_gather order — and ties go to the lower candidate index (a stable
    sort, as ``jax.lax.top_k``). Returns host (values, rows, shard ids,
    present), each [G, T', k'] with rows store rows on the owning shard."""
    fmax = float(np.finfo(np.float64).max)
    fill = float("inf") if bottom else float("-inf")
    ndev = len(slot_stores[0])
    blocks = [[None] * len(slot_stores) for _ in range(ndev)]
    for j, d, mat, gids in _slot_matrices(slot_stores, slot_gids, out_eval,
                                          window_ms, a0, a1, stale_ms, fn):
        matf = mat.to(torch.float64)
        valid = ~torch.isnan(matf)
        # real +/-Inf must outrank empty (fill) slots on ties: clamp to
        # +/-DBL_MAX in the sort domain only
        sortable = torch.clamp(matf, -fmax, fmax)
        kk = min(k, matf.shape[0])
        gv, gr, gok = [], [], []
        for gi in range(num_groups):
            m = (gids == gi)[:, None] & valid
            sv = torch.where(m, sortable, fill)
            sv = -sv if bottom else sv
            topi = torch.sort(sv.T, dim=1, descending=True,
                              stable=True).indices[:, :kk]         # [T, kk]
            gv.append(torch.gather(matf.T, 1, topi))
            gr.append(topi)
            gok.append(torch.gather(m.T, 1, topi))
        shard = j * ndev + d
        blocks[d][j] = (torch.stack(gv).cpu(), torch.stack(gr).cpu(),
                        torch.full(gv[0].shape, shard, dtype=torch.int64)
                        .expand(num_groups, -1, -1),
                        torch.stack(gok).cpu())
    cand = [torch.cat([torch.cat([blk[i] for blk in dev_blocks], dim=2)
                       for dev_blocks in blocks], dim=2) for i in range(4)]
    gv, gr, gsh, gok = cand                                     # [G, T, C]
    sv = torch.where(gok, torch.clamp(gv, -fmax, fmax), fill)
    sv = -sv if bottom else sv
    kk2 = min(k, gv.shape[2])
    sel = torch.sort(sv, dim=2, descending=True, stable=True).indices[:, :, :kk2]
    return tuple(torch.gather(x, 2, sel).numpy() for x in (gv, gr, gsh, gok))


def _fused_parts(op: str, outs) -> dict:
    """K1's (sum, count(, sumsq)) outputs as a partial dict in the
    ops/aggregators layout (count-only ops keep just the count)."""
    if op in ("count", "group"):
        return {"count": outs[1]}
    return dict(zip(("sum", "count", "sumsq"), outs))


def dist_fused_aggregate(slots, slot_gids, operands, fn: str, op: str,
                         num_groups: int, window_ms: int, interval_ms: int,
                         kind: str = "raw"):
    """The fused map phase, K1 launched once per shard on the shard's
    device (``fusedgrid.fused_grid_partials``: the kernel for CUDA tensors,
    its plain twin for CPU ones). ``slots[j][d]`` is a shard's (block,
    row_operands, n): a raw f32 value block, or the narrow ``kind``'s
    block and its row operands; ``operands[device]`` the cached band and
    edge operands (``fusedgrid.device_operands``) on that device. Returns
    the unfolded partials ``parts[j][d]``."""
    needs_sumsq = op in ("stddev", "stdvar")
    parts = []
    for shards, gids in zip(slots, slot_gids):
        row = []
        for (blk, row_ops, n), g in zip(shards, gids):
            band, ohlo, lo, hi, rel, c0, Ck = operands[blk.device]
            outs = fusedgrid.fused_grid_partials(
                fn, needs_sumsq, window_ms, interval_ms, blk, n, g, band,
                ohlo, lo, hi, rel, num_groups, c0, Ck, kind, row_ops)
            row.append(_fused_parts(op, outs))
        parts.append(row)
    return parts


class LazyMeshResult:
    """Unfolded per-shard partials on their devices; ``resolve()`` does the
    blocking host copy (the engine dispatches under the shard locks and
    fetches after releasing them) and folds in shard order — slot-major,
    device-minor, shard ``j * ndev + d`` — in f64, seeded with shard 0's
    partials as the host merge's first base, then presents with
    ``aggregators.present_partials``: bit-equal to the host loop."""

    def __init__(self, parts, op: str, num_groups: int, T: int | None):
        self._parts = parts
        self._op = op
        self._ng = num_groups
        self._T = T

    def resolve(self) -> np.ndarray:
        host = [[aggregators.host_partials(p) for p in slot]
                for slot in self._parts]
        merged: dict[str, np.ndarray] = {}
        for name in host[0][0]:
            acc = host[0][0][name].astype(np.float64)
            for j, slot in enumerate(host):
                for d, p in enumerate(slot):
                    if j == 0 and d == 0:
                        continue
                    a = p[name]
                    if name == "min":
                        acc = np.minimum(acc, a)
                    elif name == "max":
                        acc = np.maximum(acc, a)
                    else:
                        acc = acc + a
            merged[name] = acc
        vals = aggregators.present_partials(self._op, merged)[:self._ng]
        return vals[:, :self._T] if self._T is not None else vals


class LazySketch:
    """The summed sketch ``counts`` [G, W, T'] (host f32); ``resolve()``
    presents the [G, T] quantiles."""

    def __init__(self, counts, num_groups: int, T: int, q: float):
        self.counts, self._ng, self._T, self._q = counts, num_groups, T, q

    def resolve(self) -> np.ndarray:
        return aggregators.present_quantile_sketch(
            self.counts[:self._ng, :, :self._T], self._q)


class LazyTopK:
    def __init__(self, outs, num_groups: int, T: int):
        self._outs, self._ng, self._T = outs, num_groups, T

    def resolve(self):
        """(values [G, k, T] NaN where empty, shard ids, rows, present)."""
        v, r, sh, ok = (o[:self._ng] for o in self._outs)
        T = self._T
        ok_t = np.moveaxis(ok, 2, 1)[:, :, :T]
        return (np.where(ok_t, np.moveaxis(v, 2, 1)[:, :, :T], np.nan),
                np.moveaxis(sh, 2, 1)[:, :, :T],
                np.moveaxis(r, 2, 1)[:, :, :T], ok_t)


class MeshQueryExecutor:
    """Runs aggregation queries over a DistributedStore (the engine's mesh
    route). A fusable query (``rate|increase|delta|*_over_time`` into
    ``sum|avg|count|group|stddev|stdvar``) over f32 shards on one common
    grid, each with one start cohort at the grid's first cell, inside the
    fused shape gate, launches K1 per shard — streaming every shard's narrow
    block when all are narrow-resident with one decode variant and no pool
    rows; anything else takes the two-step route. ``last_path`` records the
    route, ``last_mode`` the program mode (always ``"eager"``)."""

    def __init__(self, dstore: DistributedStore):
        self.dstore = dstore
        self.last_path: str | None = None
        self.last_mode: str = MESH_MODE

    def _fused_grid(self):
        """The common (base_ts, interval_ms) when every shard qualifies for
        the fused map phase, else None."""
        grids = set()
        for sh in self.dstore.shards:
            st = sh.store
            if st is None or st.dtype != torch.float32:
                return None
            gi = st.grid_info()
            if gi is None:
                return None
            kind, off = st.grid_cohorts()
            if kind != "uniform" or off != 0:
                return None
            grids.add(gi)
        return grids.pop() if len(grids) == 1 else None

    def aggregate(self, fn: str, op: str, out_ts: np.ndarray, window_ms: int,
                  group_ids_per_shard: list[np.ndarray], num_groups: int,
                  args=(0.0, 0.0), fetch: bool = True,
                  stale_ms: int = 300_000):
        ds = self.dstore
        slot_gids = ds.global_gids(group_ids_per_shard)
        G = _pow2(num_groups)
        S, C, T = ds.S, ds.C, len(out_ts)
        grid = (self._fused_grid()
                if fusedresident.mode() != "off"
                and fn in fusedgrid.FUSED_FNS | fusedgrid.FUSED_WINDOW_FNS
                and op in fusedgrid.FUSED_OPS
                and fusedgrid.fusable(S, C, T, G) else None)
        if grid is not None:
            base_ts, interval_ms = grid
            Tp = (max(T, 1) + 127) // 128 * 128
            # resolved before the band operands: the delta variants decode
            # through a column prefix, so they need whole rows
            narrow = ds.narrow_arrays()
            kind = narrow[0] if narrow is not None else "raw"
            key = np.ascontiguousarray(np.asarray(out_ts, np.int64)).tobytes()
            operands = {dev: fusedgrid.device_operands(
                C, Tp, key, int(window_ms), int(base_ts), int(interval_ms),
                "window" if fn in fusedgrid.FUSED_WINDOW_FNS else "rate",
                decodereg.variant(kind).full_columns, dev)
                for dev in dict.fromkeys(ds.mesh)}
            parts = dist_fused_aggregate(
                narrow[1] if narrow is not None else ds.value_arrays(),
                slot_gids, operands, fn, op, G, int(window_ms),
                int(interval_ms), kind)
            fusedresident.count_served(
                fusedresident.scalar_shape_of(fn) or "rate_sum",
                fusedresident.backend_of(ds.shards[0].store.n))
            self.last_path = "fused-narrow" if narrow is not None else "fused"
            res = LazyMeshResult(parts, op, num_groups, T)
            return res.resolve() if fetch else res
        out_eval, T = _pad_steps(np.asarray(out_ts, np.int64))
        parts = dist_aggregate(ds.stores(), slot_gids, out_eval,
                               int(window_ms), float(args[0]),
                               float(args[1]), fn, op, G, stale_ms)
        self.last_path = "twostep"
        res = LazyMeshResult(parts, op, num_groups, T)
        return res.resolve() if fetch else res

    def quantile(self, fn: str, out_ts: np.ndarray, window_ms: int,
                 group_ids_per_shard: list[np.ndarray], num_groups: int,
                 q: float, args=(0.0, 0.0), stale_ms: int = 300_000):
        """Sketch counts per shard, summed over the mesh; returns a
        LazySketch whose resolve() presents [G, T] on the host (the same
        presenter as the host SketchPartial merge)."""
        ds = self.dstore
        out_eval, T = _pad_steps(np.asarray(out_ts, np.int64))
        counts = dist_quantile_sketch(
            ds.stores(), ds.global_gids(group_ids_per_shard), out_eval,
            int(window_ms), float(args[0]), float(args[1]), fn, num_groups,
            stale_ms)
        self.last_path = "sketch"
        return LazySketch(counts, num_groups, T, q)

    def topk(self, fn: str, out_ts: np.ndarray, window_ms: int,
             group_ids_per_shard: list[np.ndarray], num_groups: int,
             k: int, bottom: bool, args=(0.0, 0.0), stale_ms: int = 300_000):
        """Per-shard candidates, one gather, a global re-select. Returns a
        LazyTopK whose resolve() gives (values [G, k, T], shard ids, rows,
        present); the caller maps (shard, row) back to series keys."""
        ds = self.dstore
        out_eval, T = _pad_steps(np.asarray(out_ts, np.int64))
        outs = dist_topk(ds.stores(), ds.global_gids(group_ids_per_shard),
                         out_eval, int(window_ms), float(args[0]),
                         float(args[1]), fn, int(k), bool(bottom),
                         num_groups, stale_ms)
        self.last_path = "topk"
        return LazyTopK(outs, num_groups, T)
