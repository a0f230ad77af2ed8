"""ctypes binding for the native codec library (C++), with transparent build.

The numpy implementations in ``memory/nibblepack.py`` are the spec reference;
these native functions are bit-identical and used on ingest/persistence hot
paths. If the toolchain is unavailable the package degrades gracefully:
``available`` is False and callers fall back to numpy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_DIR, "libfilodb_codecs.so")

_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    src = os.path.join(_DIR, "codecs.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src))
    if stale:   # built per host (-march=native): never ship binaries
        try:
            subprocess.run(["sh", os.path.join(_DIR, "build.sh")], check=True,
                           capture_output=True)
        except Exception:
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _load_failed = True
        return None
    lib.np_pack_u64.restype = ctypes.c_size_t
    lib.np_pack_u64.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.np_unpack_u64.restype = ctypes.c_size_t
    lib.np_unpack_u64.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.xor_chain.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.xor_unchain.argtypes = [ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_void_p]
    lib.dd_residuals.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p]
    lib.dd_restore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_void_p]
    lib.hist_encode.restype = ctypes.c_size_t
    lib.hist_encode.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_size_t, ctypes.c_void_p]
    lib.hist_decode.restype = ctypes.c_size_t
    lib.hist_decode.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_size_t, ctypes.c_void_p]
    lib.np_pack_subbyte.restype = ctypes.c_size_t
    lib.np_pack_subbyte.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.np_unpack_subbyte.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_int, ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def pack_u64(vals: np.ndarray) -> bytes:
    lib = _load()
    v = np.ascontiguousarray(vals, np.uint64)
    # worst case per 8-word group: 2 header bytes + 8*16 nibbles = 66 bytes
    out = np.empty((len(v) // 8 + 1) * 66, np.uint8)
    n = lib.np_pack_u64(v.ctypes.data, len(v), out.ctypes.data)
    return out[:n].tobytes()


def unpack_u64(buf: bytes, n: int) -> np.ndarray:
    lib = _load()
    out = np.empty(((n + 7) // 8) * 8, np.uint64)
    raw = np.frombuffer(buf, np.uint8)
    lib.np_unpack_u64(raw.ctypes.data, n, out.ctypes.data)
    return out[:n]


def pack_doubles(vals: np.ndarray) -> bytes:
    lib = _load()
    v = np.ascontiguousarray(vals, np.float64)
    bits = v.view(np.uint64)
    if len(v) == 1:
        return bits[:1].tobytes()
    xored = np.empty(len(v) - 1, np.uint64)
    lib.xor_chain(bits.ctypes.data, len(v), xored.ctypes.data)
    return bits[:1].tobytes() + pack_u64(xored)


def pack_subbyte(off: np.ndarray, bits: int) -> bytes:
    lib = _load()
    v = np.ascontiguousarray(off, np.uint64)
    per = 8 // bits
    out = np.empty((len(v) + per - 1) // per, np.uint8)
    n = lib.np_pack_subbyte(v.ctypes.data, len(v), bits, out.ctypes.data)
    return out[:n].tobytes()


def unpack_subbyte(buf, n: int, bits: int) -> np.ndarray:
    lib = _load()
    raw = np.ascontiguousarray(np.frombuffer(buf, np.uint8))
    out = np.empty(n, np.uint64)
    lib.np_unpack_subbyte(raw.ctypes.data, n, bits, out.ctypes.data)
    return out


def dd_residuals_zigzag(v: np.ndarray, first: int, slope: int) -> np.ndarray:
    lib = _load()
    v = np.ascontiguousarray(v, np.int64)
    out = np.empty(len(v), np.uint64)
    lib.dd_residuals(v.ctypes.data, len(v), first, slope, out.ctypes.data)
    return out


def dd_restore(zz: np.ndarray, first: int, slope: int) -> np.ndarray:
    lib = _load()
    z = np.ascontiguousarray(zz, np.uint64)
    out = np.empty(len(z), np.int64)
    lib.dd_restore(z.ctypes.data, len(z), first, slope, out.ctypes.data)
    return out


def hist_encode(counts: np.ndarray) -> bytes:
    """Whole [n, B] cumulative series -> 2D-delta payload (no header)."""
    lib = _load()
    c = np.ascontiguousarray(counts, np.int64)
    n, B = c.shape
    # worst case per 8-word NibblePack group: 2 header bytes + 8*16 nibbles
    # = 66 bytes (matches pack_u64's sizing above)
    out = np.empty(n * ((B + 7) // 8) * 66 + 66, np.uint8)
    sz = lib.hist_encode(c.ctypes.data, n, B, out.ctypes.data)
    return out[:sz].tobytes()


def hist_decode(buf, n: int, B: int) -> np.ndarray:
    lib = _load()
    raw = np.ascontiguousarray(np.frombuffer(buf, np.uint8))
    out = np.empty((n, B), np.int64)
    lib.hist_decode(raw.ctypes.data, n, B, out.ctypes.data)
    return out


def unpack_doubles(buf: bytes, n: int) -> np.ndarray:
    lib = _load()
    head = np.frombuffer(buf[:8], np.uint64)[0]
    if n == 1:
        return np.array([head]).view(np.float64)
    xored = np.ascontiguousarray(unpack_u64(buf[8:], n - 1))
    out = np.empty(n, np.uint64)
    lib.xor_unchain(int(head), xored.ctypes.data, n, out.ctypes.data)
    return out.view(np.float64)
