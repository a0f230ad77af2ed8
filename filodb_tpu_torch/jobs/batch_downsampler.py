"""Batch downsampling job — the spark-jobs/DownsamplerMain equivalent.

Reference: spark-jobs/.../DownsamplerMain.scala:6-31 (cron every 6h, 2h widen for
late data), BatchDownsampler.scala (per-partition chunk reassembly + ChunkDownsampler
kernels off-heap), PerThreadOffHeapMemory.

Port of ``filodb_tpu/jobs/batch_downsampler.py``, host numpy throughout.
Instead of a Spark cluster mapping over Cassandra token ranges, the job
streams chunksets from the column store, reassembles per-series arrays,
downsamples them (``downsample_records``), and writes one multi-column
family ``{dataset}:ds_{res}`` back — directly queryable once loaded
(``load_downsampled`` builds its device store).
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

log = logging.getLogger(__name__)

from ..core.downsample import (DOWNSAMPLERS, downsample_records,
                               downsample_records_hist, ds_family)
from ..core.store import ChunkSetRecord, FileColumnStore


def _serving_config(n_series: int, max_samples: int) -> "StoreConfig":
    """StoreConfig sized to the loaded family (pow2-padded) — the raw-scale
    default (1M x 1024) would allocate GBs for a few thousand buckets."""
    from ..core.memstore import StoreConfig
    p2 = lambda n: 1 << max(n - 1, 1).bit_length()  # noqa: E731
    return StoreConfig(max_series_per_shard=p2(max(n_series, 16)),
                       samples_per_series=p2(max(max_samples, 64)),
                       flush_batch_size=10**9, groups_per_shard=1)


def run_batch_downsample(store: FileColumnStore, dataset: str, shard: int,
                         resolution_ms: int, start_ms: int = 0,
                         end_ms: int = 1 << 62, aggs=DOWNSAMPLERS) -> dict[str, int]:
    """Downsample one shard's persisted raw chunks; returns per-agg record counts."""
    per_series_ts: dict[int, list] = defaultdict(list)
    per_series_val: dict[int, list] = defaultdict(list)
    for _group, records in store.read_chunksets(dataset, shard, start_ms, end_ms):
        for r in records:
            sel = (r.ts >= start_ms) & (r.ts <= end_ms)
            if sel.any():
                vals = np.asarray(r.values)
                if r.layout is not None:
                    # multi-column record (e.g. prom-histogram sum+count+h):
                    # downsample the HISTOGRAM column (hSum); the scalar
                    # columns are derivable from it (count = top bucket)
                    hist = [(off, w) for _nm, off, w, ih in r.layout if ih]
                    if hist:
                        off, w = hist[0]
                        vals = vals[:, off:off + w]
                    else:
                        vals = vals[:, 0]
                per_series_ts[r.part_id].append(r.ts[sel])
                per_series_val[r.part_id].append(vals[sel])
    if not per_series_ts:
        return {}
    pids = np.concatenate([np.full(sum(map(len, per_series_ts[p])), p, np.int32)
                           for p in per_series_ts])
    ts = np.concatenate([t for p in per_series_ts for t in per_series_ts[p]])
    vals = np.concatenate([v for p in per_series_val for v in per_series_val[p]])
    if vals.ndim == 2:
        # native histogram dataset: hSum downsampling (per-bucket sums) —
        # the histogram aggregate keeps its own dataset (one hist column)
        dsrec = downsample_records_hist(pids, ts, vals, resolution_ms)
        meta = store.read_meta(dataset, shard) if hasattr(store, "read_meta") else {}
        written = {}
        for agg, (opids, ots, ovals) in dsrec.items():
            ds_name = f"{ds_family(dataset, resolution_ms)}:{agg}"
            written[agg] = _write_split_records(store, ds_name, shard,
                                                opids, ots, ovals,
                                                src_keys_from=dataset)
            if meta and hasattr(store, "write_meta"):
                store.write_meta(ds_name, shard, meta)  # bucket scheme rides
        return written
    # scalar dataset: ONE multi-column family, one column per aggregate
    dsrec = downsample_records(pids, ts, vals, resolution_ms, aggs)
    return _write_family(store, ds_family(dataset, resolution_ms), shard,
                         dsrec, src_keys_from=dataset)


def make_inline_publisher(sink, dataset: str, resolution_ms: int):
    """Publish callback for the streaming InlineDownsampler: ONE durable
    multi-column dataset per resolution — every aggregate is a value column
    of ``{dataset}:ds_{res}``, selected at query time via ``::dAvg`` /
    ``{__col__="dAvg"}`` (ref: ShardDownsampler -> DownsamplePublisher into
    the reference's multi-column downsample datasets; the Kafka hop is
    replaced by a direct sink write). Each series' part keys are mirrored
    the first time IT appears — a pod starting long after the shard is
    still queryable in the downsample dataset. ``publish.published_max``
    tracks, per shard, the latest bucket timestamp durably written: the
    cascade scheduler advances its window from this, never from in-memory
    ingest state."""
    mirrored: dict[int, set] = {}
    family = ds_family(dataset, resolution_ms)

    def publish(shard, recs):
        done = mirrored.setdefault(shard.shard_num, set())
        new_pids = sorted({int(p) for _a, (pids, _t, _v) in recs.items()
                           for p in pids} - done)
        if new_pids:
            entries = [(pid, shard.index.labels_of(pid),
                        shard.index.start_time(pid)) for pid in new_pids]
            sink.write_part_keys(family, shard.shard_num, entries)
        hi = 0
        written = _write_family(sink, family, shard.shard_num, recs)
        if written:
            _p, ts, _v = recs[next(iter(written))]
            if len(ts):
                hi = int(np.max(ts))
        # state advances only after every write succeeded. A mid-batch
        # failure retries the WHOLE batch next flush; aggregates already
        # written get duplicate records, which every reader dedups
        # (load_downsampled's out-of-order drop, the cascade's keep-first).
        done.update(new_pids)
        if hi:
            cur = publish.published_max.get(shard.shard_num, 0)
            hi = max(cur, hi)
            publish.published_max[shard.shard_num] = hi
            if hasattr(sink, "write_meta"):
                # durable publish floor: restart resumes (and re-seeds open
                # buckets) from here instead of re-emitting partial buckets
                # (merged — _write_family keeps the column order in the same
                # meta)
                m = (sink.read_meta(family, shard.shard_num) or {}
                     if hasattr(sink, "read_meta") else {})
                m["published_through"] = hi
                sink.write_meta(family, shard.shard_num, m)

    publish.published_max = {}
    publish.family = family
    publish.sink = sink
    return publish


def _write_split_records(store, ds_name: str, shard: int, pids, ts, vals,
                         src_keys_from=None, layout=None) -> int:
    """Split (pids, ts, vals) into per-series ChunkSetRecords and persist them
    (shared by the first-level and cascade batch jobs); optionally mirror the
    part keys from a source dataset so the output stays queryable.
    ``layout`` marks multi-column rows (one column per aggregate)."""
    order = np.argsort(pids, kind="stable")
    op, ot, ov = pids[order], ts[order], vals[order]
    bounds = np.concatenate([[0], np.nonzero(np.diff(op))[0] + 1, [len(op)]])
    recs = [ChunkSetRecord(int(op[bounds[i]]), ot[bounds[i]:bounds[i + 1]],
                           ov[bounds[i]:bounds[i + 1]], layout)
            for i in range(len(bounds) - 1)]
    store.write_chunkset(ds_name, shard, 0, recs)
    if src_keys_from is not None:
        entries = list(store.read_part_keys(src_keys_from, shard) or ())
        if entries:
            store.write_part_keys(ds_name, shard, entries)
    return len(recs)


def _dedup_keep_first(p, t, v):
    """keep-first dedup on (pid, bucket): publish retries after partial
    failures append duplicate identical records."""
    k = p.astype(np.int64) << 42 | t.astype(np.int64) % (1 << 42)
    _u, idx = np.unique(k, return_index=True)
    idx.sort()
    return p[idx], t[idx], v[idx]


def _write_family(store, family: str, shard: int, dsrec: dict,
                  src_keys_from=None) -> dict[str, int]:
    """Persist one multi-column downsample batch: stack the aggregates (all
    sharing (pids, ts)) in canonical DS_AGG_ORDER, write the records with
    their layout, and record the column-name order in the family meta
    (merged — the wire carries offsets/widths only). The single writer for
    the batch job, the inline publisher, and the cascade."""
    from ..core.downsample import DS_AGG_ORDER
    order = tuple(a for a in DS_AGG_ORDER if a in dsrec)
    if not order:
        return {}
    opids, ots, _ = dsrec[order[0]]
    ovals = np.stack([dsrec[a][2] for a in order], axis=1)
    layout = tuple((a, i, 1, False) for i, a in enumerate(order))
    n = _write_split_records(store, family, shard, opids, ots, ovals,
                             src_keys_from=src_keys_from, layout=layout)
    if hasattr(store, "write_meta"):
        meta = (store.read_meta(family, shard) or {}
                if hasattr(store, "read_meta") else {})
        existing = meta.get("columns")
        if existing and existing != list(order):
            # one family = one column set: silently rebinding names to a
            # same-width record stream would downsample one aggregate as
            # another on the next read
            raise ValueError(
                f"downsample family {family} already has columns {existing}; "
                f"refusing to write {list(order)}")
        meta["columns"] = list(order)
        store.write_meta(family, shard, meta)
    return {a: n for a in order}


def _load_family(store, family: str, shard: int, start_ms: int, end_ms: int):
    """Read a multi-column downsample family: (pids, ts, {agg: vals}) with
    keep-first dedup on (pid, bucket), or None when the family has no
    multi-column records (legacy per-aggregate layout). Column names come
    from the family meta (the wire carries offsets/widths only)."""
    meta = store.read_meta(family, shard) if hasattr(store, "read_meta") else {}
    names = meta.get("columns")
    if not names:
        # no durable column map: refusing to guess (mislabeled aggregates
        # would silently downsample sums as mins); callers fall back to the
        # legacy per-aggregate layout
        return None
    pids, ts, vals = [], [], []
    skipped = 0
    for _g, recs in store.read_chunksets(family, shard, start_ms, end_ms) or ():
        for r in recs:
            if r.layout is None:
                continue
            if np.asarray(r.values).shape[1] != len(names):
                skipped += 1   # written under a different column set
                continue
            sel = (r.ts >= start_ms) & (r.ts <= end_ms)
            if sel.any():
                pids.append(np.full(int(sel.sum()), r.part_id, np.int32))
                ts.append(r.ts[sel])
                vals.append(np.asarray(r.values, np.float64)[sel])
    if skipped:
        log.warning("family %s shard %d: %d records skipped (column-width "
                    "mismatch vs meta %s)", family, shard, skipped, names)
    if not pids:
        return None
    p = np.concatenate(pids)
    t = np.concatenate(ts)
    v = np.concatenate(vals)
    p, t, v = _dedup_keep_first(p, t, v)
    return p, t, {nm: v[:, i] for i, nm in enumerate(names)}


def _join_by_pid_ts(a, b):
    """Vectorized inner join of two (pids, ts, vals) triples on (pid, ts)."""
    # pid in the high bits (<= 2^20 series), epoch-ms in the low 42 (covers
    # to year ~2109): fits signed int64
    ka = a[0].astype(np.int64) << 42 | a[1].astype(np.int64) % (1 << 42)
    kb = b[0].astype(np.int64) << 42 | b[1].astype(np.int64) % (1 << 42)
    oa, ob = np.argsort(ka, kind="stable"), np.argsort(kb, kind="stable")
    ka, kb = ka[oa], kb[ob]
    pos = np.searchsorted(kb, ka)
    pos_c = np.clip(pos, 0, len(kb) - 1)
    hit = kb[pos_c] == ka
    ia = oa[hit]
    ib = ob[pos_c[hit]]
    return a[0][ia], a[1][ia], a[2][ia], b[2][ib]


def run_cascade_downsample(store: FileColumnStore, dataset: str, shard: int,
                           from_res_ms: int, to_res_ms: int,
                           start_ms: int = 0, end_ms: int = 1 << 62) -> dict[str, int]:
    """Second-level downsampling: compact an existing downsample family (e.g.
    1m) to a coarser one (e.g. 1h) over ``[start_ms, end_ms]`` — the periodic
    job passes its window (plus late-data widening) exactly like the raw
    batch job, so reruns don't re-append history. Averages cascade through
    the (sum, count) pair when a dSum dataset exists (ref: AvgScDownsampler
    dAvgSc), else the (avg, count) pair (AvgAcDownsampler dAvgAc) — both
    count-weighted and exact. DownsamplerMain runs this 6-hourly upstream."""
    from ..core.downsample import (downsample_avg_ac, downsample_avg_sc,
                                   downsample_records)

    src = ds_family(dataset, from_res_ms)
    dst = ds_family(dataset, to_res_ms)

    # primary path: the multi-column family dataset (one record stream, all
    # aggregates as columns; names from the family meta)
    fam = _load_family(store, src, shard, start_ms, end_ms)
    if fam is not None:
        pids, ts, cols = fam
        out_cols = {}
        for agg, op in (("dMin", "dMin"), ("dMax", "dMax"), ("dSum", "dSum"),
                        ("dCount", "dSum"), ("dLast", "dLast"),
                        ("tTime", "dMax")):
            if agg in cols:
                out_cols[agg] = downsample_records(pids, ts, cols[agg],
                                                   to_res_ms, aggs=(op,))[op]
        # the average cascades count-weighted through (sum, count) when
        # present (ref AvgScDownsampler dAvgSc), else (avg, count) (dAvgAc)
        if "dSum" in cols and "dCount" in cols:
            out_cols["dAvg"] = downsample_avg_sc(pids, ts, cols["dSum"],
                                                 cols["dCount"], to_res_ms)["dAvg"]
        elif "dAvg" in cols and "dCount" in cols:
            out_cols["dAvg"] = downsample_avg_ac(pids, ts, cols["dAvg"],
                                                 cols["dCount"], to_res_ms)["dAvg"]
        return _write_family(store, dst, shard, out_cols, src_keys_from=src)

    def load(agg):
        pids, ts, vals = [], [], []
        for _g, recs in store.read_chunksets(f"{src}:{agg}", shard,
                                             start_ms, end_ms) or ():
            for r in recs:
                sel = (r.ts >= start_ms) & (r.ts <= end_ms)
                if sel.any():
                    pids.append(np.full(int(sel.sum()), r.part_id, np.int32))
                    ts.append(r.ts[sel])
                    vals.append(np.asarray(r.values, np.float64)[sel])
        if not pids:
            return None
        p, t, v = (np.concatenate(pids), np.concatenate(ts),
                   np.concatenate(vals))
        return _dedup_keep_first(p, t, v)

    def write(agg, rec_tuple, keys_from):
        opids, ots, ovals = rec_tuple
        return _write_split_records(store, f"{dst}:{agg}", shard,
                                    opids, ots, ovals,
                                    src_keys_from=f"{src}:{keys_from}")

    written: dict[str, int] = {}
    loaded_cache: dict[str, object] = {}
    # distributive aggregates reduce over their own first-level dataset
    for agg, op in (("dMin", "dMin"), ("dMax", "dMax"), ("dSum", "dSum"),
                    ("dCount", "dSum"), ("dLast", "dLast"), ("tTime", "dMax")):
        loaded = loaded_cache.setdefault(agg, load(agg))
        if loaded is None:
            continue
        pids, ts, vals = loaded
        out = downsample_records(pids, ts, vals, to_res_ms, aggs=(op,))
        written[agg] = write(agg, out[op], keys_from=agg)
    # the average cascades through (sum, count) when possible, else (avg, count)
    cn = loaded_cache.get("dCount") or load("dCount")
    sm = loaded_cache.get("dSum")
    if cn is not None and sm is not None:
        pids, ts, svals, cvals = _join_by_pid_ts(sm, cn)
        out = downsample_avg_sc(pids, ts, svals, cvals, to_res_ms)
        # part keys mirror from dSum — this branch runs exactly when the
        # first level has it (a dAvg source dataset may not exist)
        written["dAvg"] = write("dAvg", out["dAvg"], keys_from="dSum")
    elif cn is not None:
        av = load("dAvg")
        if av is not None:
            pids, ts, avals, cvals = _join_by_pid_ts(av, cn)
            out = downsample_avg_ac(pids, ts, avals, cvals, to_res_ms)
            written["dAvg"] = write("dAvg", out["dAvg"], keys_from="dAvg")
    return written


def load_downsampled(store: FileColumnStore, dataset: str, shard: int,
                     resolution_ms: int, agg: str, memstore, config=None):
    """Load a downsampled dataset into a memstore for querying.

    Multi-column families load as ONE dataset named ``{ds}:ds_{res}`` whose
    store carries every aggregate column — query with ``metric::dAvg`` or
    ``{__col__="dAvg"}``. Histogram aggregates (and legacy per-aggregate
    layouts) load as the ``{ds}:ds_{res}:{agg}`` dataset."""
    from ..core.downsample import ds_schema
    from ..core.memstore import StoreConfig
    from ..core.record import RecordBuilder
    from ..core.schemas import GAUGE, PROM_HISTOGRAM

    family = ds_family(dataset, resolution_ms)
    try:
        # already loaded (e.g. a second aggregate of the same family): the
        # multi-column store serves every column
        existing = memstore.shard(family, shard)
        if existing.schema.column_named(agg) is not None:
            return existing
    except KeyError:
        pass
    fam = _load_family(store, family, shard, 0, 1 << 62)
    if fam is not None and agg in fam[2]:
        pids, ts, cols = fam
        names = tuple(cols)
        schema = ds_schema(names)
        if config is None:
            uniq, counts = np.unique(pids, return_counts=True)
            config = _serving_config(len(uniq), int(counts.max()))
        shard_obj = memstore.setup(family, schema, shard, config)
        labels_by_pid = {pid: labels for pid, labels, _ in
                         (store.read_part_keys(family, shard) or ())}
        # one add_batch a series, in (pid, ts) order: the container holds
        # the reference's per-sample adds' label sets, samples and order
        order = np.lexsort((ts, pids))
        sp, st = pids[order], ts[order]
        scols = {nm: cols[nm][order] for nm in names}
        bounds = np.concatenate([[0], np.nonzero(np.diff(sp))[0] + 1,
                                 [len(sp)]])
        b = RecordBuilder(schema)
        for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            labels = labels_by_pid.get(int(sp[lo]), {"_metric_": "unknown"})
            b.add_batch(labels, st[lo:hi],
                        {nm: scols[nm][lo:hi] for nm in names})
        shard_obj.ingest(b.build())
        shard_obj.flush()
        return shard_obj

    ds_name = f"{family}:{agg}"
    meta = store.read_meta(ds_name, shard) if hasattr(store, "read_meta") else {}
    les = np.asarray(meta["bucket_les"]) if meta.get("bucket_les") else None
    schema = PROM_HISTOGRAM if les is not None else GAUGE
    chunk_groups = list(store.read_chunksets(ds_name, shard) or ())
    if not chunk_groups:
        # nothing published under either layout: loading must not fabricate
        # an empty dataset (or allocate a raw-scale default store for it)
        raise KeyError(f"no downsampled data for {ds_name} shard {shard}")
    if config is None:
        per_pid: dict[int, int] = {}
        for _g, records in chunk_groups:
            for r in records:
                per_pid[r.part_id] = per_pid.get(r.part_id, 0) + len(r.ts)
        config = _serving_config(len(per_pid), max(per_pid.values()))
    shard_obj = memstore.setup(ds_name, schema, shard, config)
    labels_by_pid = {pid: labels for pid, labels, _ in
                     (store.read_part_keys(ds_name, shard) or ())}
    for _g, records in chunk_groups:
        for r in records:
            b = RecordBuilder(schema, bucket_les=les)
            labels = labels_by_pid.get(r.part_id, {"_metric_": "unknown"})
            for t, v in zip(r.ts, np.asarray(r.values)):
                b.add(labels, int(t),
                      v.astype(np.float64) if les is not None else float(v))
            shard_obj.ingest(b.build())
    shard_obj.flush()
    return shard_obj
