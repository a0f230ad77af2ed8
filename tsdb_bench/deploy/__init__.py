"""Installs of the configurations into the program under test.

A builder module ``deploy/<builder>.py`` has ``build(cfg, seed, device)``
returning a :class:`Deployment`. It alone of the benchmark's modules
imports ``filodb_tpu_torch``, and only inside ``build``.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, field

import torch


@dataclass
class Deployment:
    engine: object                    # filodb_tpu_torch QueryEngine
    shards: list
    samples: int                      # samples stored
    resident_bytes: int | None        # device bytes the install left held
    program_resident_bytes: int       # the store's own resident_sample_bytes()
    stages: dict = field(default_factory=dict)


def resident_bytes_since(device, before: int | None) -> int | None:
    """Device bytes allocated now, less ``before`` (None off the card: the
    CPU has no allocator reading)."""
    if torch.device(device).type != "cuda":
        return None
    gc.collect()
    torch.cuda.synchronize(device)
    now = torch.cuda.memory_allocated(device)
    return now if before is None else now - before


def register_series(cfg: dict, shard, schema, zero, builder_kw=None) -> None:
    """Every series of ``cfg`` through the real ingest path, in batches of
    ``registration_batch``; the staged registration samples are then
    dropped (the samples are installed apart)."""
    from filodb_tpu_torch.core.record import RecordBuilder
    S, batch = cfg["series"], cfg["registration_batch"]
    fmt = cfg["label_format"]
    for start in range(0, S, batch):
        b = RecordBuilder(schema, **(builder_kw or {}))
        b.add_series_batch(
            {"_metric_": cfg["metric"],
             cfg["label"]: [fmt.format(i)
                            for i in range(start, min(start + batch, S))]},
            cfg["base_ts_ms"], zero)
        shard.ingest(b.build())
    shard.discard_staged()
    if shard.num_series != S:
        raise RuntimeError(f"registered {shard.num_series} of {S} series")
