"""Shared socket helpers for the TCP services (the store daemon).

Host copy of ``filodb_tpu/utils/netio.py``.
"""

from __future__ import annotations

import socket


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes (bytearray accumulation: no O(n^2) concat)."""
    buf = bytearray()
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise ConnectionError("connection closed")
        buf += got
    return bytes(buf)
