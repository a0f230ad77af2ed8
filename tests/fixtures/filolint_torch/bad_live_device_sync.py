"""MUST flag live-block-under-lock with the port's device-sync kind: a
host copy (``.item()``, ``.cpu()``) under ``with shard.lock:``, and a
stream wait inside a ``_locked`` caller-holds method on a lock-owner class
— each blocks the host for the card's backlog while every reader and
writer of the shard queues behind the lock."""

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
        # BAD: waits for every kernel queued ahead on the stream
        return part.item()


def snapshot(shard, rows):
    with shard.lock:
        # BAD: a device-to-host copy under the lock
        return shard.store.val[rows].cpu()


class Shard:
    def __init__(self, lock, store):
        self.lock = lock
        self.store = store

    def _flush_locked(self):
        self.store.val.add_(1.0)
        # BAD: `_locked` caller-holds contract — the lock is held across
        # the stream wait
        torch.cuda.synchronize()
