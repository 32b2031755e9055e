"""Consumer groups and committed offsets — the port's own copy of the part
of ``repro.core.delivery`` that serving uses.

Consumers attach to a topic through a ``ConsumerGroup``: partitions are
range-assigned across members and rebalanced when members join or leave.
Delivery is at-least-once: poll → process → ``commit()``; a crash between
process and commit re-delivers from the last committed offset. The offsets
file has the JAX package's format.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

from .log import PartitionedLog
from .logstore import LogRecord, atomic_write_bytes


class OffsetStore:
    """Durable committed offsets: {group: {topic: {partition: offset}}}.
    Writes are atomic and machine-crash-safe (see
    :func:`~repro_torch.core.logstore.atomic_write_bytes`)."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self._lock = threading.Lock()
        self._data: dict[str, dict[str, dict[str, int]]] = {}
        if self.path.exists():
            try:
                self._data = json.loads(self.path.read_text())
            except (ValueError, OSError):
                # a torn *initial* file means nothing was ever committed
                self._data = {}

    def get(self, group: str, topic: str, partition: int) -> int:
        with self._lock:
            return int(self._data.get(group, {}).get(topic, {})
                       .get(str(partition), 0))

    def commit(self, group: str, topic: str,
               offsets: dict[int, int]) -> None:
        with self._lock:
            g = self._data.setdefault(group, {}).setdefault(topic, {})
            for p, off in offsets.items():
                g[str(p)] = int(off)
            atomic_write_bytes(self.path, json.dumps(self._data).encode())


def range_assign(partitions: int, members: list[str]) -> dict[str, list[int]]:
    """Deterministic range assignment (Kafka's range assignor)."""
    members = sorted(members)
    if not members:
        return {}
    per = partitions // len(members)
    extra = partitions % len(members)
    out: dict[str, list[int]] = {}
    start = 0
    for i, m in enumerate(members):
        n = per + (1 if i < extra else 0)
        out[m] = list(range(start, start + n))
        start += n
    return out


class Consumer:
    """A single group member. Not thread-safe across poll/commit (one owner
    thread per consumer, like Kafka's threading contract)."""

    def __init__(self, group: "ConsumerGroup", member_id: str) -> None:
        self._group = group
        self.member_id = member_id
        self.assignment: list[int] = []
        self._positions: dict[int, int] = {}
        # cached per-partition end offsets: refreshed only when the cache
        # says the reader caught up (idle polls take no log lock)
        self._cached_end: dict[int, int] = {}
        self.generation = -1

    def _on_assign(self, partitions: list[int], generation: int) -> None:
        self.assignment = list(partitions)
        self.generation = generation
        self._cached_end = {}
        store, log = self._group.offsets, self._group.log
        self._positions = {
            p: max(store.get(self._group.group_id, self._group.topic, p),
                   log.begin_offset(self._group.topic, p))
            for p in partitions}

    def poll(self, max_records: int = 256) -> list[LogRecord]:
        """Deterministic in (positions, log state): two sweeps over the
        assigned partitions in order — first a fair per-partition share,
        then fill the remaining budget."""
        self._group.check_generation(self)
        out: list[LogRecord] = []
        n = len(self.assignment)
        if n == 0:
            return out
        share = max(1, max_records // n)
        for cap in (share, max_records):
            for p in sorted(self.assignment):
                budget = min(cap, max_records - len(out))
                if budget <= 0:
                    break
                recs = self._read(p, budget)
                if recs:
                    self._positions[p] = recs[-1].offset + 1
                    out.extend(recs)
        return out

    def _read(self, p: int, budget: int) -> list[LogRecord]:
        pos = self._positions[p]
        if pos >= self._cached_end.get(p, 0):
            end = self._group.log.end_offset(self._group.topic, p)
            self._cached_end[p] = end
            if pos >= end:
                return []
        return self._group.log.read(self._group.topic, p, pos, budget)

    def commit(self) -> None:
        """At-least-once boundary: persist current positions."""
        self._group.offsets.commit(self._group.group_id, self._group.topic,
                                   dict(self._positions))


class StaleGeneration(Exception):
    """Raised when a consumer polls after a rebalance it hasn't joined."""


class ConsumerGroup:
    """Tracks membership and rebalances partition assignment on change."""

    def __init__(self, log: PartitionedLog, topic: str, group_id: str,
                 offset_store: OffsetStore | None = None) -> None:
        self.log = log
        self.topic = topic
        self.group_id = group_id
        self.offsets = offset_store or OffsetStore(
            Path(log.root) / f".offsets-{group_id}.json")
        self._members: dict[str, Consumer] = {}
        self._generation = 0
        self._lock = threading.Lock()

    def add_member(self, member_id: str) -> Consumer:
        with self._lock:
            if member_id in self._members:
                raise ValueError(f"member {member_id!r} already in group")
            c = Consumer(self, member_id)
            self._members[member_id] = c
            self._rebalance()
            return c

    def remove_member(self, member_id: str) -> None:
        with self._lock:
            self._members.pop(member_id, None)
            self._rebalance()

    def _rebalance(self) -> None:
        self._generation += 1
        assignment = range_assign(self.log.num_partitions(self.topic),
                                  list(self._members))
        for mid, consumer in self._members.items():
            consumer._on_assign(assignment.get(mid, []), self._generation)

    def check_generation(self, consumer: Consumer) -> None:
        if consumer.generation != self._generation:
            raise StaleGeneration(
                f"{consumer.member_id}: generation {consumer.generation} "
                f"!= group {self._generation}")
