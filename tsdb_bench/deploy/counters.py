"""Install a counter deployment (``configs/prom_counters_*.json``) into
``filodb_tpu_torch``: the method of the port's ``bench.build_engine``,
seeded by the run.

Every series registers through the real ingest path
(``RecordBuilder.add_series_batch`` -> ``shard.ingest``); the staged
registration samples are dropped, and the samples of ``data/counters.py``
are written into the shard's store on the card, as a flush of them would
leave it. The store fields this depends on: ``val``, ``ts``, ``n``,
``n_host``, ``first_ts``, ``last_ts``, ``grid_base``, ``grid_interval``,
``grid_ok``; on the shard: ``lock``, ``discard_staged()``,
``_bump_epoch_locked()``, ``visible_lead_ms``.
"""

from __future__ import annotations

import time

import torch

from ..data import counters as data
from . import Deployment, register_series, resident_bytes_since


def build(cfg: dict, seed: int, device) -> Deployment:
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    from filodb_tpu_torch.core.schemas import GAUGE
    from filodb_tpu_torch.query.engine import QueryEngine

    stages = {}
    mem0 = resident_bytes_since(device, None)
    S, N = cfg["series"], cfg["samples_per_series"]
    base, iv = cfg["base_ts_ms"], cfg["interval_ms"]
    ms = TimeSeriesMemStore(device=device)
    shard = ms.setup(cfg["dataset"], GAUGE, 0, StoreConfig(
        max_series_per_shard=S, samples_per_series=cfg["capacity"],
        flush_batch_size=10**9,
        compressed_residency=cfg["compressed_residency"], device=device))
    t0 = time.perf_counter()
    register_series(cfg, shard, GAUGE, 0.0)
    stages["registration_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = shard.store
    with shard.lock:
        for r0, vals in data.blocks(cfg, seed, device):
            st.val[r0:r0 + vals.shape[0], :N] = vals
        del vals
        st.val[:, N:] = 0.0
        st.ts[:, :N] = torch.from_numpy(data.timestamps(cfg)).to(st.ts.device)
        st.n.fill_(N)
        st.n_host[:] = N
        st.first_ts[:] = base
        st.last_ts[:] = base + (N - 1) * iv
        st.grid_base, st.grid_interval, st.grid_ok = base, iv, True
        # a direct write of query-visible rows: bump the shard's epoch and
        # lead as the staged flush it stands in for would
        shard._bump_epoch_locked(base)
        shard.visible_lead_ms = base + (N - 1) * iv
    stages["install_s"] = time.perf_counter() - t0
    engine = QueryEngine(ms, cfg["dataset"], device=device)
    return Deployment(engine=engine, shards=[shard],
                      samples=S * N,
                      resident_bytes=resident_bytes_since(device, mem0),
                      program_resident_bytes=st.resident_sample_bytes(),
                      stages=stages)

