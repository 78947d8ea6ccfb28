"""EventBuffer — the Kafka-analogue ingress queue (DESIGN.md §2).

Bounded, arrival-timestamped, offset-committed. Events survive engine
reconfiguration (the paper buffers incoming events in Kafka during
Configuration Loading); consumers commit offsets only after the sink accepts
the processed batch, so replays after a failure are idempotent.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from repro_torch.data.workloads import Event


@dataclass
class BufferStats:
    depth: int = 0
    oldest_age_s: float = 0.0
    dropped: int = 0
    replayed: int = 0
    total_in: int = 0
    total_out: int = 0


class EventBuffer:
    """FIFO with commit/replay semantics and bounded capacity."""

    def __init__(self, capacity: int = 1_000_000, drop_policy: str = "never"):
        self.capacity = capacity
        self.drop_policy = drop_policy  # never | oldest | newest
        self._q: deque[tuple[int, Event]] = deque()
        self._inflight: list[tuple[int, Event]] = []
        self._next_offset = 0
        self._committed = -1
        self.stats = BufferStats()

    def put(self, events: Iterable[Event]) -> int:
        n = 0
        for e in events:
            if len(self._q) >= self.capacity:
                self.stats.dropped += 1
                if self.drop_policy == "oldest" and self._q:
                    self._q.popleft()
                elif self.drop_policy == "newest":
                    continue
                else:  # never: block-equivalent — grow (memory metric will show it)
                    pass
            self._q.append((self._next_offset, e))
            self._next_offset += 1
            n += 1
        self.stats.total_in += n
        self.stats.depth = len(self._q)
        return n

    def take(self, max_events: int, now: float) -> list[Event]:
        """Move up to max_events into the in-flight window (uncommitted)."""
        batch: list[tuple[int, Event]] = []
        while self._q and len(batch) < max_events:
            batch.append(self._q.popleft())
        self._inflight.extend(batch)
        self.stats.depth = len(self._q)
        self.stats.oldest_age_s = (now - self._q[0][1].arrival_s) if self._q else 0.0
        return [e for _, e in batch]

    def commit(self) -> None:
        """Sink accepted the in-flight batch: commit offsets."""
        if self._inflight:
            self._committed = self._inflight[-1][0]
            self.stats.total_out += len(self._inflight)
            self._inflight.clear()

    def replay(self) -> None:
        """Failure before commit: re-queue the in-flight events (idempotent
        sink dedupes on event offset)."""
        if self._inflight:
            self.stats.replayed += len(self._inflight)
            for item in reversed(self._inflight):
                self._q.appendleft(item)
            self._inflight.clear()
            self.stats.depth = len(self._q)

    def __len__(self) -> int:
        return len(self._q)


class IdempotentSink:
    """Partitioned sink that dedupes on event offset — replays are no-ops
    (the paper's jobs 'behave idempotently by sinking ... on partitioned
    tables')."""

    def __init__(self, partitions: int = 8):
        self.partitions = max(1, partitions)
        self._seen: set[int] = set()
        self.rows: list[dict] = []
        self.duplicates = 0

    def write(self, offset: int, record: dict) -> bool:
        if offset in self._seen:
            self.duplicates += 1
            return False
        self._seen.add(offset)
        record["partition"] = offset % self.partitions
        self.rows.append(record)
        return True
