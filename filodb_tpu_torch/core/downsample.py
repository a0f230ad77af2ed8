"""Downsampling: inline (at flush) and batch, reusing the store's grid structure.

Reference: core/.../downsample/ChunkDownsampler.scala:18-30 (dMin/dMax/dSum/
dCount/dAvg/dLast/tTime samplers), ShardDownsampler (emits downsample records at
flush into a publisher), spark-jobs/.../BatchDownsampler.scala (6-hourly batch job
over Cassandra chunks).

Port of ``filodb_tpu/core/downsample.py``. Downsample buckets on a
grid-aligned shard are non-overlapping fixed-size cell ranges, so the whole
store block downsamples on its device as a reshape to [S, Tds, k] and one
reduction a aggregate (``grid_downsample``; eager torch, a plain program
with no hand kernel, as the reference's is a ``lax.reduce_window`` program
with no Pallas kernel). Everything else here is host numpy: the streaming
inline downsampler fed by each durable flush, and the record-level
aggregators the batch and cascade jobs run.

Output model (matches the reference): ONE downsample dataset per resolution,
``{name}:ds_{res}``, carrying every aggregate as a named value column
(dMin/dMax/dSum/dCount/dAvg/dLast/tTime) selected at query time with
``metric::dAvg`` / ``{__col__="dAvg"}`` — exactly how the reference's
multi-column downsample datasets work (filodb-defaults.conf downsample
schemas + ast/Vectors.scala __col__). Readers keep a fallback to the
pre-multi-column per-aggregate datasets ``{name}:ds_{res}:{agg}``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

DOWNSAMPLERS = ("dMin", "dMax", "dSum", "dCount", "dAvg", "dLast", "tTime")


# canonical wire/column order of downsample aggregates — BY DEFINITION the
# downsampler list (one constant: column order can never desynchronize from it)
DS_AGG_ORDER = DOWNSAMPLERS


def ds_schema(aggs: tuple[str, ...] = DS_AGG_ORDER):
    """Multi-value-column schema of a downsample dataset: one DOUBLE column
    per aggregate (ref: the reference's downsample datasets pack all
    aggregates as data columns, selected via __col__)."""
    from .schemas import Column, ColumnType, Schema
    cols = (Column("timestamp", ColumnType.TIMESTAMP),) + tuple(
        Column(a, ColumnType.DOUBLE) for a in aggs)
    default = "dAvg" if "dAvg" in aggs else aggs[-1]
    return Schema("ds-gauge", cols, value_column=default)


def ds_family(dataset: str, resolution_ms: int) -> str:
    """Canonical downsample family name for a resolution (shared by inline,
    batch, cascade, and load paths; sub-minute resolutions use a seconds
    suffix so they never collide)."""
    if resolution_ms % 60_000 == 0:
        return f"{dataset}:ds_{resolution_ms // 60_000}m"
    return f"{dataset}:ds_{resolution_ms // 1000}s"


class InlineDownsampler:
    """Streaming per-flush downsampler emitting only COMPLETE buckets.

    The reference's ShardDownsampler downsamples whole flushed chunks, which
    are much longer than a resolution bucket; here flushes can be sub-second
    (poll-driven), so per-flush emission would produce partial duplicate
    bucket records. Instead, partial aggregates accumulate per (series,
    bucket) and a bucket is emitted once its series' ingestion time passes
    the bucket end — in-order-per-series ingestion (out-of-order samples are
    dropped upstream) guarantees no more samples can arrive for it.
    Emission state is dropped only after the publish callback SUCCEEDS, so a
    transient sink failure retries at the next flush."""

    def __init__(self, resolution_ms: int, publish, floor_ms: int = -1):
        self.resolution_ms = resolution_ms
        self.publish = publish           # publish(shard, {agg: (pids, ts, vals)})
        # buckets ending at or before this are already durably published
        # (restart resume floor); their samples are ignored
        self.floor_ms = floor_ms
        # (pid, bucket) -> [sum, count, min, max, last_v, last_t]
        self._acc: dict[tuple[int, int], list] = {}
        # flush_group runs from several threads (ingest consumer poll, test/
        # operator flush_all_groups): accumulate/emit must be atomic or two
        # racing emitters would publish the same closed bucket twice
        self._lock = threading.Lock()
        # generation-tagged drops: a claim snapshots the drop counter, and a
        # pid poisons that claim iff it was dropped AFTER the snapshot —
        # state accumulated by a reused slot's NEW owner (later generations)
        # is never confused with the in-flight claim of the dead series
        self._drop_counter = 0
        self._drop_gen_of: dict[int, int] = {}
        self._claims_in_flight: list[int] = []   # claim gens not yet settled

    def drop_pids(self, pids) -> None:
        """Partition release (purge/eviction): open buckets of these pids
        must never be emitted — the slot may be reused by a new series whose
        labels would then be attributed the dead series' data."""
        gone = set(int(p) for p in pids)
        with self._lock:
            self._drop_counter += 1
            for p in gone:
                self._drop_gen_of[p] = self._drop_counter
            for k in [k for k in self._acc if k[0] in gone]:
                del self._acc[k]
            if self._seeded_last is not None:
                # the seed floor is per-SLOT: a reused slot's new owner must
                # not have its samples filtered by the dead series' floor
                for p in gone:
                    self._seeded_last[p] = -(1 << 62)

    def seed_from_store(self, shard) -> None:
        """Post-recovery rebuild of open buckets, called AFTER the sink's
        chunks loaded but BEFORE bus replay: replay skips rows below the
        durable chunk watermark, so a bucket straddling the restart would
        otherwise re-publish with only its post-restart samples. Per-pid
        seed floors make later replayed duplicates of already-seeded samples
        no-ops in add()."""
        st = shard.store
        if st is None:
            return
        # build the floors locally and publish once under the lock at the
        # end: a purge running concurrently with seeding (queries — and their
        # release paths — are admitted during recovery) calls drop_pids,
        # whose per-slot floor resets under self._lock would interleave with
        # unguarded incremental writes here. Snapshot the drop generation
        # first: a slot released DURING the scan must not have the dead
        # series' floor re-installed by the publish below (its reused slot's
        # new owner would lose every sample below that floor).
        with self._lock:
            gen0 = self._drop_counter
        seeded = np.full(st.S, -(1 << 62), np.int64)
        # one block materialization and one host copy for the whole scan (a
        # compressed-resident store must not decode its block once per
        # pid). The copies are taken under the shard lock and reach the
        # host after it is released
        with shard.lock:
            tdev, vdev = st.snapshot_arrays()
            tdev, vdev = tdev.clone(), vdev.clone()
            n_host = st.n_host.copy()
        tsrc, vsrc = tdev.cpu().numpy(), vdev.cpu().numpy()
        cnt = n_host.astype(np.int64)
        live = np.nonzero(cnt > 0)[0]
        seeded[live] = tsrc[live, cnt[live] - 1]
        # every live row's samples past the floor, in (pid, time) order, in
        # one accumulation and one emission: the open buckets the
        # reference's pid-by-pid pass builds, without its per-pid scan of
        # every open bucket (quadratic in the series). Buckets that close
        # during the seed publish in one batch instead of one a pid
        valid = np.arange(tsrc.shape[1])[None, :] < cnt[:, None]
        rows, cols = np.nonzero(valid & (tsrc > self.floor_ms))
        if len(rows):
            self._ingest(shard, rows.astype(np.int32), tsrc[rows, cols],
                         np.asarray(vsrc[rows, cols], np.float64))
        with self._lock:
            for p, g in self._drop_gen_of.items():
                if g > gen0 and p < len(seeded):
                    seeded[p] = -(1 << 62)   # released mid-scan: floor reset wins
            self._seeded_last = seeded

    _seeded_last = None

    def add(self, shard, pids, ts, vals) -> None:
        pids = np.asarray(pids)
        ts = np.asarray(ts)
        vals = np.asarray(vals)
        if self._seeded_last is not None:
            # recovery replay can re-deliver rows the seed already counted
            keep = ts > self._seeded_last[pids]
            if not keep.all():
                pids, ts, vals = pids[keep], ts[keep], vals[keep]
        self._ingest(shard, pids, ts, vals)

    def _ingest(self, shard, pids, ts, vals) -> None:
        res = self.resolution_ms
        if self.floor_ms >= 0 and len(ts):
            keep = (ts // res + 1) * res - 1 > self.floor_ms
            if not keep.all():
                pids, ts, vals = pids[keep], ts[keep], vals[keep]
        if len(pids) == 0:
            return
        with self._lock:
            self._ingest_locked(shard, pids, ts, vals)
        self._emit_complete(shard)

    def _ingest_locked(self, shard, pids, ts, vals) -> None:
        res = self.resolution_ms
        v, t, gidx, ngroups, gp, gts = _group_by_series_bucket(pids, ts, vals, res)
        sums = np.bincount(gidx, weights=v, minlength=ngroups)
        cnts = np.bincount(gidx, minlength=ngroups)
        mins = np.full(ngroups, np.inf); np.minimum.at(mins, gidx, v)
        maxs = np.full(ngroups, -np.inf); np.maximum.at(maxs, gidx, v)
        lastv = np.zeros(ngroups); lastv[gidx] = v
        lastt = np.zeros(ngroups, np.int64); lastt[gidx] = t
        # host scalars in one conversion each: the per-bucket loop below is
        # the flush's hot spot (float64 arithmetic either way)
        acc = self._acc
        for key, s_, c_, mn, mx, lv, lt in zip(
                zip(gp.tolist(), (gts // res).tolist()), sums.tolist(),
                cnts.tolist(), mins.tolist(), maxs.tolist(), lastv.tolist(),
                lastt.tolist()):
            a = acc.get(key)
            if a is None:
                acc[key] = [s_, c_, mn, mx, lv, lt]
            else:
                a[0] += s_; a[1] += c_
                a[2] = min(a[2], mn); a[3] = max(a[3], mx)
                if lt >= a[5]:
                    a[4], a[5] = lv, lt

    def _emit_complete(self, shard, force: bool = False) -> None:
        res = self.resolution_ms
        last_ts = shard.store.last_ts
        with self._lock:
            done = [k for k in self._acc
                    if force or last_ts[k[0]] >= (k[1] + 1) * res]
            if not done:
                return
            # claim atomically: a racing emitter must not publish these too
            claimed = {k: self._acc.pop(k) for k in done}
            claim_gen = self._drop_counter
            self._claims_in_flight.append(claim_gen)
        try:
            self._publish_claimed(shard, claimed, claim_gen)
        except Exception:
            with self._lock:     # publish failed: restore for retry
                for k, a in claimed.items():
                    if self._drop_gen_of.get(k[0], 0) > claim_gen:
                        continue       # released after the claim: stays dead
                    cur = self._acc.get(k)
                    if cur is None:
                        self._acc[k] = a
                    else:
                        cur[0] += a[0]; cur[1] += a[1]
                        cur[2] = min(cur[2], a[2]); cur[3] = max(cur[3], a[3])
                        if a[5] >= cur[5]:
                            cur[4], cur[5] = a[4], a[5]
            raise
        finally:
            with self._lock:
                self._claims_in_flight.remove(claim_gen)
                # drop generations older than every outstanding claim can no
                # longer poison anything: prune (bounds churn-driven growth)
                floor = min(self._claims_in_flight,
                            default=self._drop_counter)
                if self._drop_gen_of:
                    self._drop_gen_of = {p: g for p, g in
                                         self._drop_gen_of.items()
                                         if g > floor}

    def _publish_claimed(self, shard, claimed, claim_gen: int) -> None:
        with self._lock:
            # a release racing the claim window poisons exactly the claims
            # taken before it (generation comparison): new-owner state from a
            # later reuse is untouched
            claimed = {k: a for k, a in claimed.items()
                       if self._drop_gen_of.get(k[0], 0) <= claim_gen}
        if not claimed:
            return
        done = list(claimed)
        res = self.resolution_ms
        pids = np.array([k[0] for k in done], np.int32)
        bts = np.array([(k[1] + 1) * res - 1 for k in done], np.int64)
        rows = np.array([claimed[k] for k in done], np.float64)
        recs = {
            "dSum": (pids, bts, rows[:, 0]),
            "dCount": (pids, bts, rows[:, 1]),
            "dMin": (pids, bts, rows[:, 2]),
            "dMax": (pids, bts, rows[:, 3]),
            "dAvg": (pids, bts, rows[:, 0] / np.maximum(rows[:, 1], 1)),
            "dLast": (pids, bts, rows[:, 4]),
            "tTime": (pids, bts, rows[:, 5]),
        }
        self.publish(shard, recs)

    def flush_remaining(self, shard) -> None:
        """Emit every open bucket (shutdown / final drain)."""
        self._emit_complete(shard, force=True)


@dataclass
class DownsampledBlock:
    """One aggregate's downsampled series block."""
    agg: str
    out_ts: np.ndarray        # bucket-end timestamps [Tds]
    values: np.ndarray        # [S, Tds] (NaN = empty bucket)


def grid_downsample(val, n, base_ts: int, interval_ms: int, resolution_ms: int,
                    aggs=DOWNSAMPLERS) -> list[DownsampledBlock]:
    """Downsample a grid-aligned store block [S, C] to ``resolution_ms``
    buckets, on the block's device.

    Bucket t covers cells [t*k, (t+1)*k) with k = resolution / interval; the
    emitted timestamp is the bucket's last cell time (ref: ChunkDownsampler
    tTime = last sample time in bucket, the bucket-end convention). Sums
    and counts fold the k cells of a bucket left to right in the block's
    dtype, the order of the reference's window reduction; min, max, last
    and tTime are exact. Empty buckets come back NaN; the values reach the
    host as f64 in one copy.
    """
    S, C = val.shape
    assert resolution_ms % interval_ms == 0, "resolution must be a multiple of the grid interval"
    k = resolution_ms // interval_ms
    Tds = C // k
    dev = val.device
    n = torch.as_tensor(n, device=dev)
    valid = (torch.arange(C, dtype=torch.int32, device=dev)[None, :]
             < n[:, None])[:, :Tds * k]
    x = val[:, :Tds * k]
    v = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=dev))

    def buckets(a):
        return a.reshape(S, Tds, k)

    def fold_sum(a):
        b = buckets(a)
        acc = b[:, :, 0].clone()
        for j in range(1, k):
            acc = acc + b[:, :, j]
        return acc

    cnt = fold_sum(valid.to(x.dtype))
    out: dict[str, torch.Tensor] = {}
    if "dSum" in aggs or "dAvg" in aggs:
        s = fold_sum(v)
        out["dSum"] = s
        if "dAvg" in aggs:
            out["dAvg"] = torch.where(cnt > 0, s / torch.clamp(cnt, min=1),
                                      torch.full_like(s, float("nan")))
    if "dMin" in aggs:
        out["dMin"] = buckets(torch.where(
            valid, x, torch.full_like(x, float("inf")))).amin(dim=2)
    if "dMax" in aggs:
        out["dMax"] = buckets(torch.where(
            valid, x, torch.full_like(x, float("-inf")))).amax(dim=2)
    if "dLast" in aggs:
        out["dLast"] = buckets(v)[:, :, k - 1]
    if "dCount" in aggs:
        out["dCount"] = cnt
    if "tTime" in aggs:
        # last valid cell's timestamp per bucket (ref: TimeDownsampler)
        cell_ms = (torch.arange(Tds * k, dtype=torch.float64, device=dev)
                   * interval_ms + base_ts)
        out["tTime"] = buckets(torch.where(
            valid, cell_ms[None, :].expand(S, -1),
            torch.full((S, Tds * k), float("-inf"), dtype=torch.float64,
                       device=dev))).amax(dim=2)
    names = [a for a in aggs if a in out]
    host = (torch.stack([out[a].double() for a in names]).cpu().numpy()
            if names else np.zeros((0, S, Tds)))
    empty = (cnt == 0).cpu().numpy()
    out_ts = base_ts + (np.arange(Tds) * k + (k - 1)) * interval_ms
    blocks = []
    for i, agg in enumerate(names):
        vals = host[i].copy()
        vals[empty] = np.nan
        blocks.append(DownsampledBlock(agg, out_ts, vals))
    return blocks


def _group_by_series_bucket(pids, ts, vals, resolution_ms: int):
    """Shared (series, time-bucket) grouping: time-sorted values+timestamps
    per group, dense group index, each group's pid + bucket-end timestamp."""
    bucket = ts // resolution_ms
    order = np.lexsort((ts, bucket, pids))
    p, b, t, v = pids[order], bucket[order], ts[order], vals[order]
    newgrp = np.concatenate([[True], (p[1:] != p[:-1]) | (b[1:] != b[:-1])])
    gidx = np.cumsum(newgrp) - 1
    out_pids = p[newgrp]
    out_ts = (b[newgrp] + 1) * resolution_ms - 1    # bucket-end timestamp
    return v, t, gidx, int(gidx[-1] + 1), out_pids, out_ts


def downsample_records_hist(pids, ts, vals, resolution_ms: int) -> dict[str, tuple]:
    """Histogram flavor: vals [N, B] cumulative bucket counts -> per-(series,
    time-bucket) per-bucket sums (ref: HistSumDownsampler ``hSum``,
    ChunkDownsampler.scala:26,136 — histReader.sum over the bucket's rows)."""
    if len(pids) == 0:
        return {}
    v, _t, gidx, ngroups, out_pids, out_ts = _group_by_series_bucket(
        pids, ts, vals, resolution_ms)
    sums = np.zeros((ngroups, v.shape[1]))
    np.add.at(sums, gidx, v)
    return {"hSum": (out_pids, out_ts, sums)}


def downsample_records(pids, ts, vals, resolution_ms: int,
                       aggs=DOWNSAMPLERS) -> dict[str, tuple]:
    """Host-side inline downsampling of one flush group's raw samples (ref:
    ShardDownsampler emitting records during doFlushSteps). Input arrays are the
    pending flush buffers (unsorted); returns per-agg (pids, ts, values) arrays
    keyed on (series, bucket)."""
    if len(pids) == 0:
        return {}
    v, t, gidx, ngroups, out_pids, out_ts = _group_by_series_bucket(
        pids, ts, vals, resolution_ms)
    res: dict[str, tuple] = {}
    sums = np.bincount(gidx, weights=v, minlength=ngroups)
    cnts = np.bincount(gidx, minlength=ngroups).astype(np.float64)
    for agg in aggs:
        if agg == "dSum":
            res[agg] = (out_pids, out_ts, sums)
        elif agg == "dCount":
            res[agg] = (out_pids, out_ts, cnts)
        elif agg == "dAvg":
            res[agg] = (out_pids, out_ts, sums / cnts)
        elif agg == "dMin":
            m = np.full(ngroups, np.inf)
            np.minimum.at(m, gidx, v)
            res[agg] = (out_pids, out_ts, m)
        elif agg == "dMax":
            m = np.full(ngroups, -np.inf)
            np.maximum.at(m, gidx, v)
            res[agg] = (out_pids, out_ts, m)
        elif agg == "dLast":
            last = np.zeros(ngroups)
            last[gidx] = v                        # last write wins (time-sorted)
            res[agg] = (out_pids, out_ts, last)
        elif agg == "tTime":
            # last actual sample timestamp in the bucket (ref: TimeDownsampler
            # reads the END row's timestamp, not the bucket boundary)
            tl = np.zeros(ngroups, np.int64)
            tl[gidx] = t
            res[agg] = (out_pids, out_ts, tl.astype(np.float64))
    return res


def downsample_avg_ac(pids, ts, avg_vals, cnt_vals, resolution_ms: int):
    """Second-level average from an (avg, count) pair — count-weighted, so
    cascaded downsampling (1m -> 1h) stays exact (ref: AvgAcDownsampler,
    ChunkDownsampler.scala AvgAcD). Returns {"dAvg", "dCount"} records."""
    if len(pids) == 0:
        return {}
    w = np.asarray(avg_vals) * np.asarray(cnt_vals)
    v2 = np.stack([w, np.asarray(cnt_vals)], axis=1)
    v, _t, gidx, ngroups, out_pids, out_ts = _group_by_series_bucket(
        np.asarray(pids), np.asarray(ts), v2, resolution_ms)
    wsum = np.bincount(gidx, weights=v[:, 0], minlength=ngroups)
    csum = np.bincount(gidx, weights=v[:, 1], minlength=ngroups)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = np.where(csum > 0, wsum / csum, np.nan)
    return {"dAvg": (out_pids, out_ts, avg),
            "dCount": (out_pids, out_ts, csum)}


def downsample_avg_sc(pids, ts, sum_vals, cnt_vals, resolution_ms: int):
    """Second-level average from a (sum, count) pair (ref: AvgScDownsampler)."""
    if len(pids) == 0:
        return {}
    v2 = np.stack([np.asarray(sum_vals), np.asarray(cnt_vals)], axis=1)
    v, _t, gidx, ngroups, out_pids, out_ts = _group_by_series_bucket(
        np.asarray(pids), np.asarray(ts), v2, resolution_ms)
    ssum = np.bincount(gidx, weights=v[:, 0], minlength=ngroups)
    csum = np.bincount(gidx, weights=v[:, 1], minlength=ngroups)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = np.where(csum > 0, ssum / csum, np.nan)
    return {"dAvg": (out_pids, out_ts, avg),
            "dSum": (out_pids, out_ts, ssum),
            "dCount": (out_pids, out_ts, csum)}
