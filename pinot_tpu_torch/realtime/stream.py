"""Stream ingestion SPI + in-memory stream implementation.

Parity: pinot-core/.../realtime/stream/ — StreamConfig,
StreamConsumerFactory, PartitionLevelConsumer.fetchMessages(startOffset,
endOffset, timeout) (PartitionLevelConsumer.java:41), StreamMetadataProvider
(partition count / offsets), StreamMessageDecoder SPI. The reference ships a
Kafka 0.9 connector; here the bundled implementation is MemoryStream (an
in-process partitioned log, the embedded-Kafka analogue the reference's
tests use) — external connectors plug in via the same factory SPI.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional

SMALLEST_OFFSET = "smallest"
LARGEST_OFFSET = "largest"


@dataclasses.dataclass
class StreamConfig:
    topic: str
    consumer_factory: "StreamConsumerFactory"
    decoder: "StreamMessageDecoder"
    offset_criteria: str = SMALLEST_OFFSET
    # consuming-segment end criteria (parity: realtime.segment.flush.*)
    flush_threshold_rows: int = 100_000
    flush_threshold_time_ms: int = 6 * 3600 * 1000
    fetch_timeout_ms: int = 5000


@dataclasses.dataclass
class StreamMessage:
    offset: int
    value: bytes


@dataclasses.dataclass
class MessageBatch:
    messages: List[StreamMessage]
    next_offset: int


class PartitionLevelConsumer:
    def fetch_messages(self, start_offset: int, end_offset: Optional[int],
                       timeout_ms: int) -> MessageBatch:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamMetadataProvider:
    def partition_count(self) -> int:
        raise NotImplementedError

    def fetch_offset(self, partition: int, criteria: str) -> int:
        raise NotImplementedError


class StreamLevelConsumer:
    """High-level (HLC) group consumer SPI (parity:
    core/realtime/stream/StreamLevelConsumer used by
    HLRealtimeSegmentDataManager.java:61): the stream, not the server,
    owns partition assignment; the server just drains messages and
    checkpoints a consumer-group position after each durable flush."""

    def next_messages(self, max_count: int) -> List[StreamMessage]:
        """Up to max_count payload messages across partitions; empty
        list when nothing is available right now."""
        raise NotImplementedError

    def checkpoint(self) -> Dict[int, int]:
        """Current per-partition positions covering every message this
        consumer has returned (persist AFTER the rows are durable)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class StreamConsumerFactory:
    def create_partition_consumer(self, config: StreamConfig,
                                  partition: int) -> PartitionLevelConsumer:
        raise NotImplementedError

    def create_metadata_provider(self, config: StreamConfig
                                 ) -> StreamMetadataProvider:
        raise NotImplementedError

    def create_stream_consumer(self, config: StreamConfig,
                               checkpoint: Optional[Dict[int, int]] = None
                               ) -> StreamLevelConsumer:
        """HLC entry: a group consumer resuming from `checkpoint`
        (per-partition positions) or the config's offset criteria."""
        raise NotImplementedError


class StreamMessageDecoder:
    def decode(self, payload: bytes) -> Optional[dict]:
        """bytes → row dict; None drops the message (parity: decoder
        returning null)."""
        raise NotImplementedError


class JsonMessageDecoder(StreamMessageDecoder):
    def decode(self, payload: bytes) -> Optional[dict]:
        try:
            row = json.loads(payload.decode("utf-8"))
            return row if isinstance(row, dict) else None
        except (ValueError, UnicodeDecodeError):
            return None


# ---------------------------------------------------------------------------
# In-memory stream
# ---------------------------------------------------------------------------


class MemoryStream:
    """A partitioned in-process log: the embedded test/quickstart stream."""

    def __init__(self, topic: str, num_partitions: int = 1):
        self.topic = topic
        self._partitions: List[List[bytes]] = [[] for _ in
                                               range(num_partitions)]
        self._lock = threading.Lock()
        self._data = threading.Condition(self._lock)

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    def publish(self, row: dict, partition: Optional[int] = None) -> None:
        payload = json.dumps(row).encode("utf-8")
        self.publish_bytes(payload, partition)

    def publish_bytes(self, payload: bytes,
                      partition: Optional[int] = None) -> None:
        with self._lock:
            if partition is None:
                sizes = [len(p) for p in self._partitions]
                partition = sizes.index(min(sizes))
            self._partitions[partition].append(payload)
            self._data.notify_all()

    def latest_offset(self, partition: int) -> int:
        with self._lock:
            return len(self._partitions[partition])

    def wake(self) -> None:
        """Wake long-poll readers (consumer close / shutdown path)."""
        with self._lock:
            self._data.notify_all()

    def read(self, partition: int, start: int, max_count: int,
             timeout_ms: int = 0, stop=None) -> List[StreamMessage]:
        """Long-poll read (Kafka consumer.poll semantics): when nothing
        is available past `start`, block up to timeout_ms for a publish —
        freshness is then publish-driven, not poll-cadence-driven.
        `stop`: zero-arg callable; a True return (after wake()) aborts
        the wait so consumer close never blocks on the full timeout."""
        deadline = time.monotonic() + timeout_ms / 1e3 if timeout_ms else 0
        with self._lock:
            log_part = self._partitions[partition]
            while timeout_ms and len(log_part) <= start and \
                    not (stop is not None and stop()):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._data.wait(remaining):
                    break
            end = min(len(log_part), start + max_count)
            return [StreamMessage(i, log_part[i]) for i in range(start, end)]


class MemoryStreamConsumerFactory(StreamConsumerFactory):
    def __init__(self, stream: MemoryStream, batch_size: int = 1000):
        self.stream = stream
        self.batch_size = batch_size

    def create_partition_consumer(self, config: StreamConfig,
                                  partition: int) -> PartitionLevelConsumer:
        return _MemoryPartitionConsumer(self.stream, partition,
                                        self.batch_size)

    def create_metadata_provider(self, config: StreamConfig
                                 ) -> StreamMetadataProvider:
        return _MemoryMetadataProvider(self.stream)

    def create_stream_consumer(self, config: StreamConfig,
                               checkpoint: Optional[Dict[int, int]] = None
                               ) -> StreamLevelConsumer:
        return _MemoryStreamLevelConsumer(self.stream, config, checkpoint,
                                          self.batch_size)


class _MemoryStreamLevelConsumer(StreamLevelConsumer):
    """Round-robin group consumer over the in-memory log."""

    def __init__(self, stream: MemoryStream, config: StreamConfig,
                 checkpoint: Optional[Dict[int, int]], batch_size: int):
        self.stream = stream
        self.batch_size = batch_size
        self._pos: Dict[int, int] = {}
        for p in range(stream.num_partitions):
            if checkpoint and p in checkpoint:
                self._pos[p] = int(checkpoint[p])
            elif config.offset_criteria == SMALLEST_OFFSET:
                self._pos[p] = 0
            else:
                self._pos[p] = stream.latest_offset(p)
        self._next_part = 0

    def next_messages(self, max_count: int) -> List[StreamMessage]:
        out: List[StreamMessage] = []
        parts = self.stream.num_partitions
        for _ in range(parts):
            if len(out) >= max_count:
                break
            p = self._next_part
            self._next_part = (self._next_part + 1) % parts
            msgs = self.stream.read(p, self._pos[p],
                                    min(self.batch_size,
                                        max_count - len(out)))
            if msgs:
                self._pos[p] = msgs[-1].offset + 1
                out.extend(msgs)
        return out

    def checkpoint(self) -> Dict[int, int]:
        return dict(self._pos)


class _MemoryPartitionConsumer(PartitionLevelConsumer):
    def __init__(self, stream: MemoryStream, partition: int,
                 batch_size: int):
        self.stream = stream
        self.partition = partition
        self.batch_size = batch_size
        self._closed = False

    def fetch_messages(self, start_offset: int, end_offset: Optional[int],
                       timeout_ms: int) -> MessageBatch:
        limit = self.batch_size if end_offset is None else \
            min(self.batch_size, end_offset - start_offset)
        msgs = self.stream.read(self.partition, start_offset,
                                max(limit, 0), timeout_ms=timeout_ms,
                                stop=lambda: self._closed)
        next_off = msgs[-1].offset + 1 if msgs else start_offset
        return MessageBatch(msgs, next_off)

    def close(self) -> None:
        self._closed = True
        self.stream.wake()


class _MemoryMetadataProvider(StreamMetadataProvider):
    def __init__(self, stream: MemoryStream):
        self.stream = stream

    def partition_count(self) -> int:
        return self.stream.num_partitions

    def fetch_offset(self, partition: int, criteria: str) -> int:
        if criteria == SMALLEST_OFFSET:
            return 0
        return self.stream.latest_offset(partition)


class FlakyConsumerFactory(StreamConsumerFactory):
    """Wraps a factory with a consumer that randomly throws / returns
    garbage (parity: FlakyConsumerRealtimeClusterIntegrationTest)."""

    def __init__(self, inner: StreamConsumerFactory, seed: int = 0,
                 failure_rate: float = 0.3):
        self.inner = inner
        self.seed = seed
        self.failure_rate = failure_rate

    def create_partition_consumer(self, config: StreamConfig,
                                  partition: int) -> PartitionLevelConsumer:
        import random
        inner = self.inner.create_partition_consumer(config, partition)
        rng = random.Random(self.seed + partition)

        class Flaky(PartitionLevelConsumer):
            def fetch_messages(self, start, end, timeout_ms):
                roll = rng.random()
                if roll < 0.15:
                    raise RuntimeError("flaky consumer exception")
                batch = inner.fetch_messages(start, end, timeout_ms)
                if roll < 0.3 and batch.messages:
                    # corrupt a message payload
                    m = batch.messages[0]
                    batch.messages[0] = StreamMessage(m.offset, b"\xff garbage")
                return batch

        return Flaky()

    def create_metadata_provider(self, config: StreamConfig
                                 ) -> StreamMetadataProvider:
        return self.inner.create_metadata_provider(config)

    def create_stream_consumer(self, config: StreamConfig,
                               checkpoint: Optional[Dict[int, int]] = None
                               ) -> StreamLevelConsumer:
        import random
        inner = self.inner.create_stream_consumer(config, checkpoint)
        rng = random.Random(self.seed)

        class FlakyHL(StreamLevelConsumer):
            def next_messages(self, max_count):
                roll = rng.random()
                if roll < 0.15:
                    raise RuntimeError("flaky consumer exception")
                msgs = inner.next_messages(max_count)
                if roll < 0.3 and msgs:
                    m = msgs[0]
                    msgs[0] = StreamMessage(m.offset, b"\xff garbage")
                return msgs

            def checkpoint(self):
                return inner.checkpoint()

            def close(self):
                inner.close()

        return FlakyHL()
