"""Install a histogram deployment (``configs/prom_hist_*.json``) into
``filodb_tpu_torch``: the method of the port's ``chip_smoke.py`` phase 7,
seeded by the run.

Every series registers through the real ingest path; the samples of
``data/histograms.py`` are written into the raw store on the card, and the
shard's own ``flush()`` then compresses them into the configured residency
(rows its lossless gate refused would stay raw in its pool; the whole
counts of ``data/histograms.py`` leave it empty). The store fields
this depends on: ``val``, ``extra["count"]``, ``extra["sum"]``, ``ts``,
``n``, ``n_host``, ``first_ts``, ``last_ts``, ``grid_base``,
``grid_interval``, ``grid_ok``, ``stats.samples_appended``; on the shard:
``lock``, ``discard_staged()``, ``flush()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data import histograms as data
from . import Deployment, register_series, resident_bytes_since


def build(cfg: dict, seed: int, device) -> Deployment:
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM
    from filodb_tpu_torch.query.engine import QueryEngine

    stages = {}
    mem0 = resident_bytes_since(device, None)
    S, N, B = cfg["series"], cfg["samples_per_series"], cfg["buckets"]
    base, iv = cfg["base_ts_ms"], cfg["interval_ms"]
    ms = TimeSeriesMemStore(device=device)
    shard = ms.setup(cfg["dataset"], PROM_HISTOGRAM, 0, StoreConfig(
        max_series_per_shard=S, samples_per_series=cfg["capacity"],
        flush_batch_size=10**9,
        compressed_residency=cfg["compressed_residency"], device=device))
    t0 = time.perf_counter()
    register_series(cfg, shard, PROM_HISTOGRAM, np.zeros(B),
                    {"bucket_les": data.les(cfg)})
    stages["registration_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = shard.store
    with shard.lock:
        for r0, c, count, total in data.blocks(cfg, seed, device):
            rows = c.shape[0]
            st.val[r0:r0 + rows, :N] = c
            st.extra["count"][r0:r0 + rows, :N] = count
            st.extra["sum"][r0:r0 + rows, :N] = total
        del c, count, total
        st.ts[:, :N] = torch.from_numpy(data.timestamps(cfg)).to(st.ts.device)
        st.n.fill_(N)
        st.n_host[:] = N
        st.first_ts[:] = base
        st.last_ts[:] = base + (N - 1) * iv
        st.grid_base, st.grid_interval, st.grid_ok = base, iv, True
        st.stats.samples_appended += S * N
    stages["install_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard.flush()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    stages["flush_s"] = time.perf_counter() - t0
    engine = QueryEngine(ms, cfg["dataset"], device=device)
    return Deployment(engine=engine, shards=[shard],
                      samples=S * N,
                      resident_bytes=resident_bytes_since(device, mem0),
                      program_resident_bytes=st.resident_sample_bytes(),
                      stages=stages)
