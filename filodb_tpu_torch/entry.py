"""The flagship step as one function on tensors.

Port of ``__graft_entry__.entry()``: ``sum(rate(m[5m]))`` over a 512 x 128
example store through the fused map phase (K1 on the card, its plain twin
on the CPU) and the ``sum`` present, the same kernel the bench measures.

    from filodb_tpu_torch.entry import entry
    fn, args = entry()              # device="cpu" to run on the CPU
    out = fn(*args)                 # [1, 17] f32 on args' device
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops import aggregators, fusedgrid

S, C, N_SAMPLES = 512, 128, 100
BASE_TS = 1_700_000_000_000
WINDOW_MS, INTERVAL_MS = 300_000, 10_000
# 17 steps, 400 s to 900 s into the store's data
OUT_TS = BASE_TS + np.arange(400_000, 900_001, 30_000, dtype=np.int64)


def example_store(device, seed: int = 0):
    """(val [S, C] f32, n [S] i32) on ``device``: counters of exponential
    increments, ``N_SAMPLES`` cells filled per row, made with numpy exactly
    as the reference's ``_example_store``."""
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.exponential(5.0, (S, N_SAMPLES)), axis=1)
    val = np.zeros((S, C), np.float32)
    val[:, :N_SAMPLES] = vals
    n = np.full(S, N_SAMPLES, np.int32)
    return torch.from_numpy(val).to(device), torch.from_numpy(n).to(device)


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(*example_args)`` is the
    ``sum(rate(m[5m]))`` step over the example store on ``device`` (default
    ``cuda``; raises ``DeviceUnavailable`` without a card unless the CPU is
    asked for), a [1, 17] f32 tensor. The arguments are the store (val, n),
    the group ids and the window operands (band, ohlo, lo, hi, rel) of the
    reference's entry, in its order; the window operands are copies of the
    query engine's cached ones, so a caller may change them in place."""
    dev = resolve_device(device)
    T = len(OUT_TS)
    Tp = -(-T // 128) * 128
    val, n = example_store(dev)
    gids = torch.zeros(S, dtype=torch.int32, device=dev)
    *ops, c0, Ca = fusedgrid.device_operands(
        C, Tp, OUT_TS.tobytes(), WINDOW_MS, BASE_TS, INTERVAL_MS, "rate",
        False, dev)

    def sum_rate_query(val, n, gids, band, ohlo, lo, hi, rel):
        outs = fusedgrid.fused_grid_partials(
            "rate", False, WINDOW_MS, INTERVAL_MS, val, n, gids, band, ohlo,
            lo, hi, rel, 8, c0, Ca)
        parts = {"sum": outs[0], "count": outs[1]}
        return aggregators.present_partials("sum", parts)[:1, :T]

    return sum_rate_query, (val, n, gids, *(o.clone() for o in ops))


# -- seeded counter shards and the cluster node process ---------------------

CLUSTER_DATASET = "prometheus"
CLUSTER_QUERY = "sum(rate(m[5m]))"


def seeded_counter_shard(memstore, dataset: str, shard_num: int,
                         num_series: int, num_samples: int, capacity: int,
                         seed: int, interval_ms: int = 10_000,
                         base_ts: int = BASE_TS, batch: int = 1 << 14):
    """(shard, registration seconds): shard ``shard_num`` of ``dataset`` in
    ``memstore``, ``num_series`` series registered through the real ingest
    path (``add_series_batch`` -> ``shard.ingest``, the staged samples then
    dropped), each holding ``num_samples`` grid-aligned samples installed
    on the shard's device from a ``torch.Generator`` seeded with ``seed +
    shard_num``: counters with integer anchors below 2^20 and integer
    increments in [0, 8], exact in f32 and in every narrow kind. Series
    ``h<i>`` are numbered across shards (shard ``s`` holds ``s *
    num_series`` on) with ``grp`` g0-g3, so one memstore holding every
    shard and nodes holding one each hold the same rows."""
    import time
    from .core.memstore import StoreConfig
    from .core.record import RecordBuilder
    from .core.schemas import GAUGE
    dev = memstore.device
    shard = memstore.setup(dataset, GAUGE, shard_num, StoreConfig(
        max_series_per_shard=num_series, samples_per_series=capacity,
        flush_batch_size=10**9, device=dev))
    first = shard_num * num_series
    t0 = time.perf_counter()
    for r0 in range(0, num_series, batch):
        ids = range(first + r0, first + min(r0 + batch, num_series))
        b = RecordBuilder(GAUGE)
        b.add_series_batch({"_metric_": "m", "host": [f"h{i}" for i in ids],
                            "grp": [f"g{i % 4}" for i in ids]}, base_ts, 0.0)
        shard.ingest(b.build())
    shard.discard_staged()
    reg_s = time.perf_counter() - t0
    assert shard.num_series == num_series, shard.num_series
    st = shard.store
    g = torch.Generator(device=dev).manual_seed(seed + shard_num)
    last = base_ts + (num_samples - 1) * interval_ms
    with shard.lock:
        for r0 in range(0, num_series, batch):
            rows = min(batch, num_series - r0)
            inc = torch.randint(0, 9, (rows, num_samples), generator=g,
                                device=dev).to(st.val.dtype)
            anchor = torch.randint(0, 1 << 20, (rows, 1), generator=g,
                                   device=dev).to(st.val.dtype)
            st.val[r0:r0 + rows, :num_samples] = anchor + torch.cumsum(inc, 1)
        st.val[:, num_samples:] = 0.0
        st.ts[:, :num_samples] = (base_ts + torch.arange(
            num_samples, device=dev) * interval_ms)
        st.n.fill_(num_samples)
        st.n_host[:] = num_samples
        st.first_ts[:] = base_ts
        st.last_ts[:] = last
        st.grid_base, st.grid_interval, st.grid_ok = (base_ts, interval_ms,
                                                      True)
        st.stats.samples_appended += num_series * num_samples
        # a direct write of query-visible rows: bump the epoch and the lead
        # as the staged flush it stands in for would
        shard._bump_epoch_locked(base_ts)
        shard.visible_lead_ms = last
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return shard, reg_s


def _cluster_node_args(argv):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m filodb_tpu_torch.entry --cluster-node",
        description="One node of a multi-process cluster: registers with a "
                    "file registrar, agrees on the world, joins a Gloo "
                    "process group, builds its seeded shard and serves "
                    "its HTTP API until the stop file appears.")
    p.add_argument("--registrar", required=True,
                   help="shared registrar directory (the stop file lives "
                        "there)")
    p.add_argument("--addr", required=True,
                   help="this member's address, host:port; the first in "
                        "sort order serves the process group's rendezvous")
    p.add_argument("--members", type=int, default=2)
    p.add_argument("--series", type=int, default=64)
    p.add_argument("--samples", type=int, default=60)
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--device", default=None)
    p.add_argument("--range", default=None,
                   help="start,end,step of the all-reduce check (ms)")
    p.add_argument("--window", type=int, default=300_000)
    return p.parse_args(argv)


def cluster_node(argv=None) -> int:
    """Run one cluster node in this process (see ``_cluster_node_args``).

    Prints ``NODE {json}`` once it serves: its rank, world size, HTTP
    endpoint, shard, registration seconds, K1's launches so far, and the
    presented ``sum(rate(m[5m]))`` over the ``--range`` from a Gloo
    ``all_reduce`` of every rank's host partials (the f64 sum of two
    partials, in rank order, is the fold the reduce makes). After the stop
    file (``<registrar>/stop``) appears, prints ``DONE {json}`` with K1's
    launches and exits. A CUDA node must be a fresh interpreter."""
    import json
    import os
    import time

    import torch.distributed as dist

    from .core.memstore import TimeSeriesMemStore
    from .http.api import FiloHttpServer
    from .ops import fusedgrid as fg
    from .parallel.bootstrap import (ClusterBootstrap, FileRegistrarDiscovery,
                                     MembershipMonitor)
    from .parallel.cluster import ShardManager
    from .parallel.shardmapper import ShardMapper
    from .promql import parser as promql
    from .query.engine import QueryEngine

    a = _cluster_node_args(argv)
    dev = resolve_device(a.device)
    reg = FileRegistrarDiscovery(a.registrar, stale_s=30.0)
    boot = ClusterBootstrap(reg, a.addr)
    world = boot.resolve_world(min_members=a.members, timeout_s=120.0)
    boot.initialize_torch(world)
    rank, size = world.process_id, world.num_processes
    # shard i is member i's: every member derives the same assignment
    mgr = ShardManager()
    for m in world.members:
        mgr.add_node(m)
    mgr.add_dataset(CLUSTER_DATASET, size,
                    claimed={i: m for i, m in enumerate(world.members)})
    ms = TimeSeriesMemStore(device=dev)
    _shard, reg_s = seeded_counter_shard(
        ms, CLUSTER_DATASET, rank, a.series, a.samples, a.capacity, a.seed)
    engine = QueryEngine(ms, CLUSTER_DATASET, ShardMapper(size), device=dev,
                         cluster=mgr, node=a.addr,
                         endpoint_resolver=lambda n: reg.endpoints().get(n))
    srv = FiloHttpServer({CLUSTER_DATASET: engine}, port=0).start()
    mon = MembershipMonitor(reg, a.addr, on_down=mgr.remove_node,
                            interval_s=1.0)
    mon.http_addr = f"127.0.0.1:{srv.port}"
    mon.publish_now()
    mon.start()
    try:
        # every peer's endpoint published before anyone reports ready
        deadline = time.monotonic() + 120.0
        while len(reg.endpoints()) < size:
            if time.monotonic() > deadline:
                raise TimeoutError("peer endpoints never published")
            time.sleep(0.1)
        out = {"rank": rank, "world": size, "http": mon.http_addr,
               "shard": rank, "registration_s": reg_s}
        if a.range:
            start, end, step = (int(x) for x in a.range.split(","))
            plan = promql.query_to_logical_plan(CLUSTER_QUERY, start, end,
                                                step)
            local = QueryEngine(ms, CLUSTER_DATASET, ShardMapper(size),
                                device=dev)
            leaf = local.planner.materialize(plan).children[rank]
            part = leaf.execute(local._ctx())
            parts = aggregators.host_partials(
                aggregators.resolve_partials(part.parts))
            red = {}
            for name in ("sum", "count"):
                t = torch.from_numpy(np.asarray(parts[name][:1],
                                                np.float64)).contiguous()
                dist.all_reduce(t)
                red[name] = t.numpy()
            vals = aggregators.present_partials("sum", red)[0]
            out["allreduce"] = [float(v) for v in vals]
        out["k1_launches"] = fg.fused_grid_kernel.launches
        print("NODE " + json.dumps(out), flush=True)
        stop = os.path.join(a.registrar, "stop")
        while not os.path.exists(stop):
            time.sleep(0.05)
        print("DONE " + json.dumps(
            {"rank": rank, "k1_launches": fg.fused_grid_kernel.launches}),
            flush=True)
    finally:
        mon.stop()
        mon.join(timeout=5)
        srv.stop()
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


# -- the multi-device dry run -----------------------------------------------

def _dry_install(shard, vals: np.ndarray, nsamp: int, base: int, iv: int):
    """Install ``vals`` [rows, nsamp] as the first rows of ``shard``'s
    store on its device, grid-aligned at ``base`` every ``iv`` ms."""
    from .core.chunkstore import TS_PAD
    st = shard.store
    dev = st.val.device
    rows = len(vals)
    ts = np.full((st.S, st.C), TS_PAD, np.int64)
    ts[:rows, :nsamp] = base + np.arange(nsamp, dtype=np.int64) * iv
    val = np.zeros((st.S, st.C), np.float32)
    val[:rows, :nsamp] = vals
    n = np.zeros(st.S, np.int32)
    n[:rows] = nsamp
    with shard.lock:
        st.ts.copy_(torch.from_numpy(ts).to(dev))
        st.val.copy_(torch.from_numpy(val).to(dev))
        st.n.copy_(torch.from_numpy(n).to(dev))
        st.n_host[:] = n
        st.first_ts[:] = np.where(n > 0, base, -1)
        st.last_ts[:] = np.where(n > 0, base + (nsamp - 1) * iv, -(1 << 62))
        st.grid_base, st.grid_interval, st.grid_ok = base, iv, True
        shard._bump_epoch_locked(base)
        shard.visible_lead_ms = base + (nsamp - 1) * iv


def _dry_register(shard, names: list[str], base: int):
    """Register series ``names`` through the real ingest path."""
    from .core.record import RecordBuilder
    from .core.schemas import GAUGE
    b = RecordBuilder(GAUGE)
    b.add_series_batch({"_metric_": "m", "host": names,
                        "grp": [f"g{i % 4}" for i in range(len(names))]},
                       base, 0.0)
    shard.ingest(b.build())
    shard.discard_staged()


def _one(res) -> np.ndarray:
    (_k, _t, v), = list(res.matrix.iter_series())
    return np.asarray(v)


def dryrun_multichip(n_devices: int = 8, device=None) -> dict:
    """The multi-device sharded query and ingest step on ``n_devices``
    shards, each on its own mesh device (every card of this process by
    default, round robin; ``device="cpu"``: ``["cpu"] * n_devices``).
    Port of steps 1-4 of ``__graft_entry__._dryrun_impl`` (ref: the
    multi-jvm specs' ingest -> churn -> recover -> query parity,
    IngestionAndRecoverySpec.scala:41-59):

    1. 1024 series x 200 samples a shard, registered through the real
       ingest path, the samples installed on each shard's device;
    2. sum(rate) over the mesh takes the fused route (K1 a shard) and
       matches one shard holding every series (rtol 2e-4);
    3. a late-start cohort ingested through the real path demotes the mesh
       to the two-step kernels; parity holds; topk and quantile on the
       mesh against the host route; a sharded prom-histogram's
       histogram_quantile against one shard;
    4. a shard killed and recovered from its durable sink, then queried
       again on the mesh; eviction under slot pressure and an on-demand
       page-in on a sink-backed store.

    The reference's step 5 (two standalone servers over a broker) waits
    for the port's standalone server and broker. Returns the routes and
    checks; raises on any divergence."""
    import tempfile

    from .core.memstore import StoreConfig, TimeSeriesMemStore
    from .core.record import RecordBuilder
    from .core.schemas import GAUGE, PROM_HISTOGRAM
    from .core.store import FileColumnStore
    from .parallel import distributed
    from .query.engine import QueryEngine

    if device is not None and resolve_device(device).type == "cpu":
        mesh = distributed.make_mesh(["cpu"] * n_devices)
    else:
        mesh = distributed.make_mesh(None if device is None else [device])
    devs = [mesh[i % len(mesh)] for i in range(n_devices)]
    S, C, NSAMP, IV = 1024, 256, 200, 10_000
    base = BASE_TS
    out: dict = {"devices": [str(d) for d in mesh], "shards": n_devices}
    ms = TimeSeriesMemStore(device=devs[0])
    cfg = StoreConfig(max_series_per_shard=S, samples_per_series=C,
                      flush_batch_size=10**9)
    shards = [ms.setup("prometheus", GAUGE, i, cfg, device=d)
              for i, d in enumerate(devs)]
    ref_ms = TimeSeriesMemStore(device=devs[0])
    ref = ref_ms.setup("prometheus", GAUGE, 0, StoreConfig(
        max_series_per_shard=S * n_devices, samples_per_series=C,
        flush_batch_size=10**9))
    live = S - 64                         # headroom for the churn cohort
    rng = np.random.default_rng(3)
    all_vals = []
    for i, sh in enumerate(shards):
        _dry_register(sh, [f"h{i}-{r}" for r in range(live)], base)
        vals = np.cumsum(rng.exponential(5.0, (live, NSAMP)),
                         axis=1).astype(np.float32)
        all_vals.append(vals)
        _dry_install(sh, vals, NSAMP, base, IV)
    _dry_register(ref, [f"h{i}-{r}" for i in range(n_devices)
                        for r in range(live)], base)
    _dry_install(ref, np.concatenate(all_vals), NSAMP, base, IV)

    mesh_eng = QueryEngine(ms, "prometheus", device=devs[0], mesh=mesh)
    host_eng = QueryEngine(ms, "prometheus", device=devs[0])
    one = QueryEngine(ref_ms, "prometheus", device=devs[0])
    start, end, step = base + 300_000, base + NSAMP * IV, 60_000
    q = "sum(rate(m[5m]))"
    r = mesh_eng.query_range(q, start, end, step)
    assert r.exec_path == "mesh-fused", r.exec_path
    np.testing.assert_allclose(_one(r), _one(one.query_range(q, start, end,
                                                             step)),
                               rtol=2e-4, atol=1e-3)
    out["fused"] = r.exec_path

    # churn: a late-start cohort through the real ingest path on every
    # shard and on the oracle: starts no longer uniform -> two-step kernels
    churn = NSAMP // 2
    for i, sh in enumerate(shards):
        b, rb = RecordBuilder(GAUGE), RecordBuilder(GAUGE)
        for r_ in range(16):
            cv = np.cumsum(rng.exponential(5.0, NSAMP - churn))
            ts = base + np.arange(churn, NSAMP, dtype=np.int64) * IV
            b.add_batch({"_metric_": "m", "host": f"h{i}-c{r_}",
                         "grp": "gc"}, ts, cv)
            rb.add_batch({"_metric_": "m", "host": f"rh{i}-c{r_}",
                          "grp": "gc"}, ts, cv)
        sh.ingest(b.build())
        sh.flush()
        ref.ingest(rb.build())
    ref.flush()
    r2 = mesh_eng.query_range(q, start, end, step)
    assert r2.exec_path == "mesh-twostep", r2.exec_path
    np.testing.assert_allclose(_one(r2), _one(one.query_range(
        q, start, end, step)), rtol=2e-4, atol=1e-3)
    out["churned"] = r2.exec_path

    # order statistics on the mesh against the host route, same store
    tq = "topk(5, rate(m[5m]))"
    rq = mesh_eng.query_range(tq, start, end, step)
    assert rq.exec_path == "mesh-topk", rq.exec_path
    got = {k: (t.tolist(), v) for k, t, v in rq.matrix.iter_series()}
    want = {k: (t.tolist(), v) for k, t, v in
            host_eng.query_range(tq, start, end, step).matrix.iter_series()}
    assert set(got) == set(want) and got, "mesh topk winners diverge"
    for k, (t, v) in want.items():
        assert got[k][0] == t
        np.testing.assert_allclose(got[k][1], v, rtol=2e-4, atol=1e-4)
    qq = "quantile(0.9, rate(m[5m]))"
    rq = mesh_eng.query_range(qq, start, end, step)
    assert rq.exec_path == "mesh-sketch", rq.exec_path
    np.testing.assert_allclose(_one(rq), _one(host_eng.query_range(
        qq, start, end, step)), rtol=2.5e-2, equal_nan=True)
    out["order_stats"] = ["mesh-topk", "mesh-sketch"]

    # a sharded prom-histogram: histogram_quantile(sum(rate)) over every
    # shard against one shard holding them all
    les = np.array([1.0, 2.0, 4.0, 8.0, np.inf])
    hms = TimeSeriesMemStore(device=devs[0])
    hcfg = StoreConfig(max_series_per_shard=8, samples_per_series=128,
                       flush_batch_size=10**9, dtype="float64")
    hshards = [hms.setup("histds", PROM_HISTOGRAM, i, hcfg, device=d)
               for i, d in enumerate(devs)]
    href_ms = TimeSeriesMemStore(device=devs[0])
    href = href_ms.setup("histds", PROM_HISTOGRAM, 0, StoreConfig(
        max_series_per_shard=8 * n_devices, samples_per_series=128,
        flush_batch_size=10**9, dtype="float64"))
    NH = 100
    hts = base + np.arange(NH, dtype=np.int64) * IV
    for i, hsh in enumerate(hshards):
        b = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
        rb = RecordBuilder(PROM_HISTOGRAM, bucket_les=les)
        for r_ in range(4):
            counts = np.cumsum(np.cumsum(rng.poisson(0.4, (NH, 5)), axis=0),
                               axis=1).astype(np.float64)
            for t in range(NH):
                for bb in (b, rb):
                    bb.add({"_metric_": "lat", "pod": f"p{i}-{r_}"},
                           int(hts[t]), counts[t])
        hsh.ingest(b.build())
        hsh.flush()
        href.ingest(rb.build())
    href.flush()
    hq = "histogram_quantile(0.9, sum(rate(lat[5m])))"
    hrange = (base + 400_000, base + (NH - 1) * IV, 60_000)
    np.testing.assert_allclose(
        _one(QueryEngine(hms, "histds", device=devs[0]).query_range(
            hq, *hrange)),
        _one(QueryEngine(href_ms, "histds", device=devs[0]).query_range(
            hq, *hrange)), rtol=1e-9, equal_nan=True)
    out["histogram"] = True

    # kill a shard -> recover it from the durable sink -> re-query on the
    # mesh route
    with tempfile.TemporaryDirectory() as tmp:
        rms = TimeSeriesMemStore(device=devs[0])
        sink = FileColumnStore(tmp)
        rcfg = StoreConfig(max_series_per_shard=16, samples_per_series=64,
                           flush_batch_size=10**9, groups_per_shard=1)
        rshards = [rms.setup("prometheus", GAUGE, i, rcfg, sink=sink,
                             device=d) for i, d in enumerate(devs)]
        rts = base + np.arange(60, dtype=np.int64) * IV
        for i, rsh in enumerate(rshards):
            b = RecordBuilder(GAUGE)
            for r_ in range(8):
                b.add_batch({"_metric_": "rm", "host": f"r{i}-{r_}"}, rts,
                            np.cumsum(rng.exponential(5.0, 60)))
            rsh.ingest(b.build())
            rsh.flush_all_groups()
        reng = QueryEngine(rms, "prometheus", device=devs[0], mesh=mesh)
        rrange = (base + 200_000, base + 59 * IV, 30_000)
        r1 = reng.query_range("sum(rate(rm[2m]))", *rrange)
        assert r1.exec_path.startswith("mesh"), r1.exec_path
        dead = n_devices - 1
        del rms._shards[("prometheus", dead)]
        rms.setup("prometheus", GAUGE, dead, rcfg, sink=sink,
                  device=devs[dead]).recover()
        r2 = reng.query_range("sum(rate(rm[2m]))", *rrange)
        assert r2.exec_path.startswith("mesh"), r2.exec_path
        np.testing.assert_allclose(_one(r2), _one(r1), rtol=2e-4, atol=1e-3)
    out["recovered"] = r2.exec_path

    # eviction under slot pressure + an on-demand page-in, sink-backed
    with tempfile.TemporaryDirectory() as tmp:
        ms2 = TimeSeriesMemStore(device=devs[0])
        sh2 = ms2.setup("prometheus", GAUGE, 0, StoreConfig(
            max_series_per_shard=8, samples_per_series=64,
            flush_batch_size=10**9, groups_per_shard=1),
            sink=FileColumnStore(tmp))
        for r_ in range(12):          # 12 series through 8 slots
            t0 = base + r_ * 5 * IV
            b = RecordBuilder(GAUGE)
            b.add_batch({"_metric_": "m", "host": f"e{r_}"},
                        t0 + np.arange(40, dtype=np.int64) * IV,
                        np.arange(40, dtype=np.float64))
            sh2.ingest(b.build())
            sh2.flush_group(0)
        assert sh2.stats.partitions_evicted > 0, "no eviction"
        horizon = base + 11 * 5 * IV + 40 * IV
        sh2.store.compact(horizon - 20 * IV)
        pids = sh2.part_ids_from_filters([], base, horizon)
        assert sh2.needs_paging(pids, base)
        _ts, val_a, n_a = sh2.read_with_paging(pids, base, horizon)
        assert (n_a == 40).all(), n_a
        for i in range(len(pids)):
            np.testing.assert_allclose(val_a[i, :40], np.arange(40.0))
    out["evicted_paged"] = True
    return out


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--cluster-node"]:
        sys.exit(cluster_node(sys.argv[2:]))
    sys.exit("usage: python -m filodb_tpu_torch.entry --cluster-node ...")
