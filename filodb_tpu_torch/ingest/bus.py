"""Durable ingest bus — the Kafka-equivalent data plane.

Reference: kafka/src/main/scala/filodb/kafka/KafkaIngestionStream.scala
(1 shard == 1 partition, seek to checkpointed offset, replay). Host copy
of ``filodb_tpu/ingest/bus.py``, with the same frame format. Here: one
append-only log file per (dataset, shard) of length-prefixed RecordContainer
frames; offsets are frame ordinals. A byte-position index (built on open,
maintained on append) makes seek-to-offset O(1), like a Kafka segment index.
The same interface fronts the reference's TCP broker, which the port has not
ported yet.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Iterator

from ..core.record import RecordContainer

_FRAME = struct.Struct("<Q I")   # offset, payload length


class FileBus:
    """Append-only per-shard container log with offset-addressed replay."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._publish_lock = threading.Lock()   # concurrent producers in-process
        # offset -> byte position of its frame header (the seek index)
        self._positions: list[int] = []
        self.resync()

    def publish(self, container: RecordContainer) -> int:
        """Append a container; returns its offset."""
        return self.publish_bytes(container.to_bytes())

    def publish_bytes(self, payload: bytes) -> int:
        with self._publish_lock:
            off = len(self._positions)
            with open(self.path, "ab") as f:
                pos = f.tell()
                # one write call: keeps the frame contiguous even if another
                # appender (against the single-writer contract) interleaves
                f.write(_FRAME.pack(off, len(payload)) + payload)
            self._positions.append(pos)
        return off

    def publish_many_bytes(self, payloads) -> list[int]:
        """Append many frames with ONE open + ONE write; returns their
        offsets. The broker's PUBLISH_BATCH path: per-frame appends would
        re-open the log once per frame, which dominates small-frame batches.
        The index only adopts the frames after the write succeeds, so a torn
        batch is recovered by resync() exactly like a torn single frame."""
        if not payloads:
            return []
        with self._publish_lock:
            base = len(self._positions)
            blob = bytearray()
            for i, p in enumerate(payloads):
                blob += _FRAME.pack(base + i, len(p)) + p
            with open(self.path, "ab") as f:
                pos = f.tell()
                f.write(blob)
            for p in payloads:
                self._positions.append(pos)
                pos += _FRAME.size + len(p)
        return list(range(base, base + len(payloads)))

    def frames_from(self, from_offset: int = 0) -> Iterator[tuple[int, bytes]]:
        """Raw frames from ``from_offset``, seeking straight to its position."""
        end = len(self._positions)               # snapshot: stable under appends
        if from_offset >= end:
            return
        with open(self.path, "rb") as f:
            f.seek(self._positions[from_offset])
            for off in range(from_offset, end):
                hdr = f.read(_FRAME.size)
                if len(hdr) < _FRAME.size:
                    return
                stored_off, ln = _FRAME.unpack(hdr)
                payload = f.read(ln)
                if len(payload) < ln:
                    return                       # torn tail — stop cleanly
                yield stored_off, payload

    def consume(self, schemas, from_offset: int = 0) -> Iterator[tuple[int, RecordContainer]]:
        """Replay containers from ``from_offset`` (ref: Kafka seek-to-checkpoint).

        Picks up frames appended by *other processes* too: the index is
        re-synced from the file when the caller asks past our known end.
        """
        if from_offset >= len(self._positions):
            self.resync()
        for off, payload in self.frames_from(from_offset):
            yield off, RecordContainer.from_bytes(payload, schemas)

    def resync(self) -> None:
        """Re-scan the log tail for frames appended by another process."""
        with self._publish_lock:
            if not os.path.exists(self.path):
                return
            size = os.path.getsize(self.path)
            pos = 0
            if self._positions:
                # start from the last known frame to find its end
                last = self._positions[-1]
                with open(self.path, "rb") as f:
                    f.seek(last)
                    _, ln = _FRAME.unpack(f.read(_FRAME.size))
                pos = last + _FRAME.size + ln
            with open(self.path, "rb") as f:
                while pos + _FRAME.size <= size:
                    f.seek(pos)
                    _, ln = _FRAME.unpack(f.read(_FRAME.size))
                    if pos + _FRAME.size + ln > size:
                        break
                    self._positions.append(pos)
                    pos += _FRAME.size + ln

    def truncate(self, end_offset: int) -> int:
        """Drop every frame at ``end_offset`` and beyond (the REJOIN
        divergent-tail repair: a restarted deposed leader truncates frames
        the current leader never saw before catching up). Returns the
        number of frames dropped."""
        with self._publish_lock:
            if end_offset >= len(self._positions):
                return 0
            dropped = len(self._positions) - end_offset
            pos = self._positions[end_offset]
            with open(self.path, "r+b") as f:
                f.truncate(pos)
            del self._positions[end_offset:]
        return dropped

    @property
    def end_offset(self) -> int:
        return len(self._positions)

    def close(self) -> None:
        """Bus-interface parity with BrokerBus: FileBus opens its log per
        operation, so there is nothing to release — owners can close any
        bus unconditionally."""
