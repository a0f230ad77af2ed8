"""Ingestion sources: the stream abstraction + CSV and synthetic generators.

Reference: coordinator/.../IngestionStream.scala:14,43 (trait + factory),
sources/CsvStream.scala (sample CSV source), gateway/.../TestTimeseriesProducer
(synthetic series for dev/benchmarks).
"""

from __future__ import annotations

import csv
from typing import Iterator

import numpy as np

from ..core.record import RecordBuilder, RecordContainer
from ..core.schemas import GAUGE, Schema


class IngestionStream:
    """Iterable of (offset, RecordContainer); teardown() releases resources."""

    def __iter__(self) -> Iterator[tuple[int, RecordContainer]]:  # pragma: no cover
        raise NotImplementedError

    def teardown(self) -> None:
        pass


class CsvStream(IngestionStream):
    """CSV rows -> containers. Columns: metric,timestamp(ms),value,then labels
    as name=value pairs in remaining columns (header optional)."""

    def __init__(self, path: str, schema: Schema = GAUGE, batch_size: int = 1000,
                 ws: str = "default", ns: str = "default"):
        self.path = path
        self.schema = schema
        self.batch_size = batch_size
        self.ws, self.ns = ws, ns

    def __iter__(self):
        b = RecordBuilder(self.schema)
        offset = 0
        count = 0
        with open(self.path) as f:
            for row in csv.reader(f):
                if not row or row[0] == "metric":
                    continue
                metric, ts, value, *labelcols = row
                labels = {"_metric_": metric, "_ws_": self.ws, "_ns_": self.ns}
                for lc in labelcols:
                    if "=" in lc:
                        k, v = lc.split("=", 1)
                        labels[k] = v
                b.add(labels, int(ts), float(value))
                count += 1
                if count >= self.batch_size:
                    yield offset, b.build()
                    offset += 1
                    count = 0
        if count:
            yield offset, b.build()


class SyntheticStream(IngestionStream):
    """Deterministic synthetic gauge/counter series (ref:
    TestTimeseriesProducer.timeSeriesData: sinusoidal gauges keyed by instance)."""

    def __init__(self, schema: Schema = GAUGE, n_series: int = 100,
                 n_batches: int = 10, samples_per_batch: int = 10,
                 start_ms: int = 1_000_000, interval_ms: int = 10_000,
                 metric: str = "heap_usage0", kind: str = "gauge"):
        self.schema = schema
        self.n_series = n_series
        self.n_batches = n_batches
        self.samples_per_batch = samples_per_batch
        self.start_ms = start_ms
        self.interval_ms = interval_ms
        self.metric = metric
        self.kind = kind

    def labels(self, i: int) -> dict[str, str]:
        return {"_metric_": self.metric, "_ws_": "demo", "_ns_": "App-0",
                "instance": f"Instance-{i}", "host": f"H{i % 10}",
                "dc": f"DC{i % 2}"}

    def __iter__(self):
        counter_base = np.zeros(self.n_series)
        t_idx = 0
        idx = np.arange(self.n_series)[:, None]
        for batch in range(self.n_batches):
            b = RecordBuilder(self.schema)
            k = self.samples_per_batch
            steps = t_idx + np.arange(k)[None, :]
            ts = self.start_ms + steps[0] * self.interval_ms
            if self.kind == "counter":
                incs = np.abs(np.sin(steps / 10 + idx)) * 10     # [S, k]
                vals = counter_base[:, None] + np.cumsum(incs, axis=1)
                counter_base = vals[:, -1].copy()
            else:
                vals = 15.0 * (idx + 1) + 8 * np.sin(steps / 10 + idx)
            # one bulk append per series per batch (samples stay time-ordered
            # per series; cross-series interleaving is irrelevant downstream)
            for i in range(self.n_series):
                b.add_batch(self.labels(i), ts, vals[i])
            t_idx += k
            yield batch, b.build()
