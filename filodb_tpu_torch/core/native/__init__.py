"""ctypes binding for the native partition-set library (C++).

``NativePartSet`` is the ingest hot-path part-key table (ref:
core/.../memstore/PartitionSet.scala — zero-alloc open-addressing probes
against ingest records, under getOrAddPartitionAndIngest,
TimeSeriesShard.scala:1183). The shard keeps a Python-dict fallback when the
toolchain is unavailable (``available()`` False).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_DIR, "libfilodb_partset.so")

_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    src = os.path.join(_DIR, "partset.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src))
    if stale:   # built per host (-march=native): never ship binaries
        try:
            subprocess.run(["sh", os.path.join(_DIR, "build.sh")], check=True,
                           capture_output=True)
        except Exception:
            _load_failed = True   # no toolchain: don't re-fork per build()
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _load_failed = True
        return None
    lib.ps_new.restype = ctypes.c_void_p
    lib.ps_new.argtypes = [ctypes.c_uint64]
    lib.ps_free.argtypes = [ctypes.c_void_p]
    lib.ps_size.restype = ctypes.c_uint64
    lib.ps_size.argtypes = [ctypes.c_void_p]
    lib.ps_insert.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
                              ctypes.c_uint32, ctypes.c_int32]
    lib.ps_remove.restype = ctypes.c_int32
    lib.ps_remove.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
                              ctypes.c_uint32]
    lib.ps_resolve_batch.restype = ctypes.c_int64
    lib.ps_resolve_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_void_p]
    lib.fnv1a64_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_void_p]
    lib.ps_insert_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int64]
    lib.sorted_intersect_i32.restype = ctypes.c_int64
    lib.sorted_intersect_i32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _concat_keys(keys: list[bytes]):
    offs = np.zeros(len(keys) + 1, np.uint64)
    np.cumsum([len(k) for k in keys], out=offs[1:])
    return b"".join(keys), offs


def fnv1a64_batch(keys: list[bytes]) -> np.ndarray:
    """Vectorized wire-stable FNV-1a64 of each key (matches record.fnv1a64)."""
    lib = _load()
    blob, offs = _concat_keys(keys)
    out = np.empty(len(keys), np.uint64)
    lib.fnv1a64_batch(blob, offs.ctypes.data, len(keys), out.ctypes.data)
    return out


def sorted_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """Intersection of two sorted-unique int32 arrays in native code
    (galloping for skewed sizes); None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    out = np.empty(min(len(a), len(b)), np.int32)
    k = lib.sorted_intersect_i32(a.ctypes.data, len(a), b.ctypes.data, len(b),
                                 out.ctypes.data)
    return out[:k]


class NativePartSet:
    """Open-addressing part-key -> pid table with exact-bytes verification."""

    def __init__(self, cap_hint: int = 1024):
        self._lib = _load()
        assert self._lib is not None, "native partset unavailable"
        self._h = self._lib.ps_new(cap_hint)

    def __len__(self) -> int:
        return int(self._lib.ps_size(self._h))

    def insert(self, hash_: int, key: bytes, pid: int) -> None:
        self._lib.ps_insert(self._h, hash_, key, len(key), pid)

    def insert_batch(self, entries: list) -> None:
        """[(hash, key bytes, pid)] in ONE native call (per-key ctypes
        costs ~10us; a cold container registers thousands of new series)."""
        if not entries:
            return
        hashes = np.fromiter((e[0] for e in entries), np.uint64,
                             count=len(entries))
        blob, offs = _concat_keys([e[1] for e in entries])
        pids = np.fromiter((e[2] for e in entries), np.int32,
                           count=len(entries))
        self._lib.ps_insert_batch(self._h, hashes.ctypes.data, blob,
                                  offs.ctypes.data, pids.ctypes.data,
                                  len(entries))

    def insert_arrays(self, hashes: np.ndarray, keys: list[bytes],
                      pids: np.ndarray) -> None:
        """Array form of insert_batch (registration hot path: no per-entry
        tuples or int() conversions on the Python side)."""
        if not len(keys):
            return
        blob, offs = _concat_keys(keys)
        h = np.ascontiguousarray(hashes, np.uint64)
        p = np.ascontiguousarray(pids, np.int32)
        self._lib.ps_insert_batch(self._h, h.ctypes.data, blob,
                                  offs.ctypes.data, p.ctypes.data, len(keys))

    def remove(self, hash_: int, key: bytes) -> bool:
        return bool(self._lib.ps_remove(self._h, hash_, key, len(key)))

    def resolve_batch(self, hashes: np.ndarray, keys: list[bytes]) -> np.ndarray:
        """pids[i] for each key (or -1 on miss) in one native call."""
        blob, offs = _concat_keys(keys)
        out = np.empty(len(keys), np.int32)
        h = np.ascontiguousarray(hashes, np.uint64)
        self._lib.ps_resolve_batch(self._h, h.ctypes.data, blob,
                                   offs.ctypes.data, len(keys),
                                   out.ctypes.data)
        return out

    def __del__(self):
        try:
            self._lib.ps_free(self._h)
        except Exception:  # noqa: BLE001  # filolint: ignore[except-swallow]
            # interpreter shutdown: ctypes globals may already be torn down,
            # and running ANY further code (even a counter) can itself fail
            pass
