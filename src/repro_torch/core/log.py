"""Durable partitioned pub-sub log — the port's own copy of the single-host
segment store of ``repro.core.log``, reduced to what serving uses.

Storage layout (byte for byte the JAX package's, so either package reads
the other's logs)::

    root/<topic>/<partition>/<base_offset 20 digits>.seg

Segment record wire format (little-endian):

    crc32(u32) | key_len(u32) | val_len(u32) | key | value

where crc32 covers ``key_len|val_len|key|value``. On open, the tail segment is
scanned and any torn/corrupt suffix (partial write at crash) is truncated.

``append_batch`` packs a batch into one contiguous buffer per partition (one
``write(2)``); a batch is byte-identical to the same records appended one at
a time. Appends are buffered; a read flushes a partition's write buffer
when it trails the append watermark, and ``close`` flushes the rest.
Reads use one ``pread(2)`` per range, parsed from a ``memoryview``.

The contract the server and the consumer group rely on (all methods
thread-safe): topics are created explicitly with a fixed partition count;
appends assign dense consecutive offsets per partition; ``read`` returns
records ``[offset, offset+n)`` of one partition in offset order, so readers
may trail and replay; ``begin_offset``/``end_offset`` bound the retained
range.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from pathlib import Path
from typing import Sequence

from .logstore import LogRecord

__all__ = ["CorruptRecord", "LogRecord", "PartitionedLog", "SEGMENT_BYTES",
           "route_partition"]

_HEADER = struct.Struct("<III")  # crc, key_len, val_len
SEGMENT_BYTES = 8 << 20  # a segment rolls once it holds 8 MiB


class CorruptRecord(Exception):
    pass


def route_partition(key: bytes, num_partitions: int) -> int:
    """The key→partition routing rule (keyless records land on
    partition 0)."""
    return zlib.crc32(key) % num_partitions if key else 0


def _crc(key: bytes, value: bytes) -> int:
    c = zlib.crc32(struct.pack("<II", len(key), len(value)))
    c = zlib.crc32(key, c)
    return zlib.crc32(value, c)


class _Segment:
    """One append-only segment file with an in-memory offset index."""

    def __init__(self, path: Path, base_offset: int) -> None:
        self.path = path
        self.base_offset = base_offset
        self.positions: list[int] = []     # file pos of record i
        self.next_pos = 0
        self._recover()
        self._fh = open(path, "ab")
        self._rfd = os.open(path, os.O_RDONLY)   # positionless pread(2)

    def _recover(self) -> None:
        """Scan existing records, truncating a torn tail."""
        if not self.path.exists():
            self.path.touch()
            return
        size = self.path.stat().st_size
        good_end = 0
        with open(self.path, "rb") as f:
            pos = 0
            while pos + _HEADER.size <= size:
                f.seek(pos)
                crc, klen, vlen = _HEADER.unpack(f.read(_HEADER.size))
                end = pos + _HEADER.size + klen + vlen
                if end > size:
                    break                       # torn write
                key = f.read(klen)
                value = f.read(vlen)
                if _crc(key, value) != crc:
                    break                       # corrupt tail
                self.positions.append(pos)
                good_end = end
                pos = end
        if good_end != size:
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
        self.next_pos = good_end

    @property
    def count(self) -> int:
        return len(self.positions)

    @property
    def bytes(self) -> int:
        return self.next_pos

    def append_batch(self, records: Sequence[tuple[bytes, bytes]]) -> None:
        """Pack all records into one contiguous buffer and write once."""
        buf = bytearray()
        pos = self.next_pos
        offsets = []
        pack, hsize = _HEADER.pack, _HEADER.size
        for key, value in records:
            offsets.append(pos)
            buf += pack(_crc(key, value), len(key), len(value))
            buf += key
            buf += value
            pos += hsize + len(key) + len(value)
        self._fh.write(buf)
        self.positions.extend(offsets)
        self.next_pos = pos

    def seal(self) -> None:
        """Flush and drop the write handle of a segment that stops being
        the active one."""
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    def flush(self) -> None:
        if self._fh is not None:            # else sealed: already flushed
            self._fh.flush()

    def read_range(self, rel_start: int, max_records: int, count: int,
                   end_pos: int) -> list[tuple[bytes, bytes]]:
        """One ``pread`` for the whole range; ``count``/``end_pos`` pin a
        snapshot taken under the partition lock."""
        if rel_start >= count:
            return []
        n = min(max_records, count - rel_start)
        start = self.positions[rel_start]
        stop = (self.positions[rel_start + n]
                if rel_start + n < count else end_pos)
        data = os.pread(self._rfd, stop - start, start)
        if len(data) != stop - start:
            raise CorruptRecord(
                f"{self.path}: short read {len(data)} != {stop - start}")
        mv = memoryview(data)
        out: list[tuple[bytes, bytes]] = []
        unpack_from, hsize = _HEADER.unpack_from, _HEADER.size
        pos = 0
        for _ in range(n):
            crc, klen, vlen = unpack_from(mv, pos)
            ks = pos + hsize
            vs = ks + klen
            ve = vs + vlen
            if ve > len(mv):
                raise CorruptRecord(str(self.path))
            # crc covers key_len|val_len|key|value == bytes [pos+4, ve)
            if zlib.crc32(mv[pos + 4:ve]) != crc:
                raise CorruptRecord(str(self.path))
            out.append((bytes(mv[ks:vs]), bytes(mv[vs:ve])))
            pos = ve
        return out

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._rfd >= 0:
            os.close(self._rfd)
            self._rfd = -1


class _Partition:
    def __init__(self, path: Path) -> None:
        self.path = path
        self.lock = threading.Lock()
        path.mkdir(parents=True, exist_ok=True)
        bases = sorted(int(p.stem) for p in path.glob("*.seg"))
        self.segments = [_Segment(path / f"{b:020d}.seg", b) for b in bases]
        if not self.segments:
            self.segments.append(_Segment(path / f"{0:020d}.seg", 0))
        for seg in self.segments[:-1]:
            seg.seal()                      # only the active segment writes
        # everything recovered from disk is, by definition, flushed
        self._flushed_end = self.end_offset

    @property
    def active(self) -> _Segment:
        return self.segments[-1]

    @property
    def begin_offset(self) -> int:
        return self.segments[0].base_offset

    @property
    def end_offset(self) -> int:
        a = self.active
        return a.base_offset + a.count

    def _roll_locked(self) -> None:
        self.active.seal()
        base = self.end_offset
        self._flushed_end = max(self._flushed_end, base)
        self.segments.append(_Segment(self.path / f"{base:020d}.seg", base))

    def append_batch(self, records: Sequence[tuple[bytes, bytes]]) -> int:
        """Append many records under one lock acquisition; the segment-roll
        check runs once per written chunk. Returns the first assigned
        offset (records get consecutive offsets)."""
        with self.lock:
            first = self.end_offset
            i, n = 0, len(records)
            hsize = _HEADER.size
            while i < n:
                if self.active.bytes >= SEGMENT_BYTES:
                    self._roll_locked()
                # records that keep this segment under its size limit at the
                # moment each is written (a lone record always fits)
                cap = SEGMENT_BYTES - self.active.bytes
                j, size = i, 0
                while j < n and size < cap:
                    k, v = records[j]
                    size += hsize + len(k) + len(v)
                    j += 1
                self.active.append_batch(records[i:j])
                i = j
            return first

    def read(self, offset: int, max_records: int
             ) -> list[tuple[int, bytes, bytes]]:
        with self.lock:
            end = self.end_offset
            if offset >= end:
                return []
            # group-flush: make buffered appends visible only when a reader
            # actually trails the append watermark
            if self._flushed_end < end:
                self.active.flush()
                self._flushed_end = end
            segs = [(s, s.count, s.bytes) for s in self.segments]
        out: list[tuple[int, bytes, bytes]] = []
        for seg, count, end_pos in segs:
            if not out and offset >= seg.base_offset + count:
                continue
            rel = max(0, offset - seg.base_offset)
            for key, value in seg.read_range(rel, max_records - len(out),
                                             count, end_pos):
                out.append((seg.base_offset + rel, key, value))
                rel += 1
            if len(out) >= max_records:
                break
        return out

    def close(self) -> None:
        with self.lock:
            for s in self.segments:
                s.close()


class PartitionedLog:
    """Multi-topic durable log on one host. Thread-safe. ``root`` also
    holds the consumer groups' committed offsets."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._topics: dict[str, list[_Partition]] = {}
        self._lock = threading.Lock()
        # re-open any topics already on disk (crash recovery)
        for tdir in sorted(self.root.iterdir()):
            if tdir.is_dir():
                parts = sorted(int(p.name) for p in tdir.iterdir()
                               if p.is_dir())
                if parts:
                    self._topics[tdir.name] = [
                        _Partition(tdir / str(i))
                        for i in range(max(parts) + 1)]

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        """Idempotent; raises if the topic exists with a different count."""
        with self._lock:
            if topic in self._topics:
                if len(self._topics[topic]) != partitions:
                    raise ValueError(
                        f"topic {topic!r} exists with "
                        f"{len(self._topics[topic])} partitions")
                return
            self._topics[topic] = [
                _Partition(self.root / topic / str(i))
                for i in range(partitions)]

    def num_partitions(self, topic: str) -> int:
        return len(self._part_list(topic))

    def _part_list(self, topic: str) -> list[_Partition]:
        with self._lock:
            if topic not in self._topics:
                raise KeyError(f"unknown topic {topic!r}")
            return self._topics[topic]

    def append(self, topic: str, key: bytes, value: bytes,
               partition: int | None = None) -> tuple[int, int]:
        return self.append_batch(topic, [(key, value)], partition)[0]

    def append_batch(self, topic: str,
                     records: Sequence[tuple[bytes, bytes]],
                     partition: int | None = None) -> list[tuple[int, int]]:
        """With ``partition=None`` each record is routed by key hash and the
        batch is regrouped per partition, order preserved within each.
        Returns ``(partition, offset)`` per record, in input order."""
        if not records:
            return []
        parts = self._part_list(topic)
        if partition is not None:
            first = parts[partition].append_batch(records)
            return [(partition, first + i) for i in range(len(records))]
        groups: dict[int, list[int]] = {}
        for i, (key, _) in enumerate(records):
            groups.setdefault(route_partition(key, len(parts)), []).append(i)
        out: list[tuple[int, int]] = [(0, 0)] * len(records)
        for p, idxs in groups.items():
            first = parts[p].append_batch([records[i] for i in idxs])
            for j, i in enumerate(idxs):
                out[i] = (p, first + j)
        return out

    def read(self, topic: str, partition: int, offset: int,
             max_records: int = 512) -> list[LogRecord]:
        part = self._part_list(topic)[partition]
        return [LogRecord(topic, partition, off, k, v)
                for off, k, v in part.read(offset, max_records)]

    def begin_offset(self, topic: str, partition: int) -> int:
        return self._part_list(topic)[partition].begin_offset

    def end_offset(self, topic: str, partition: int) -> int:
        return self._part_list(topic)[partition].end_offset

    def end_offsets(self, topic: str) -> list[int]:
        return [p.end_offset for p in self._part_list(topic)]

    def close(self) -> None:
        with self._lock:
            for parts in self._topics.values():
                for p in parts:
                    p.close()
            self._topics.clear()
