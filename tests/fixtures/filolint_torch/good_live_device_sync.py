"""Clean twin of bad_live_device_sync: the launches that read the store
stay under the lock; the host copy and the stream wait come after it."""

import torch

LATENCY_SPEC = {
    "locks": {"lock": "shard"},
    "blocking": {"cpu": "device-sync", "item": "device-sync",
                 "synchronize": "device-sync"},
    "sites": {},
    "wait_ok": {},
}


def total(shard, rows):
    with shard.lock:
        part = shard.store.val[rows].sum()
    return part.item()


def snapshot(shard, rows):
    with shard.lock:
        part = shard.store.val[rows].clone()
    return part.cpu()


class Shard:
    def __init__(self, lock, store):
        self.lock = lock
        self.store = store

    def _flush_locked(self):
        self.store.val.add_(1.0)

    def flush(self):
        with self.lock:
            self._flush_locked()
        torch.cuda.synchronize()
