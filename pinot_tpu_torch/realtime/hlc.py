"""High-level consumer (HLC) realtime ingestion.

Parity: pinot-core/.../realtime/HLRealtimeSegmentDataManager.java:61 —
the legacy consumer path. Unlike LLC there is NO controller completion
FSM: the stream's group management owns partition assignment
(StreamLevelConsumer SPI), the server indexes rows into a consuming
segment that is queryable immediately, FULL segments convert to
immutable segments locally and swap into the server's data manager, and
only after a segment is durable does the consumer-group checkpoint
persist (ZK offset commits in the reference; the property store record
``/CONSUMERS/<table>/<group>`` here). Restart resumes from the last
checkpoint, so rows after it replay — the reference's at-least-once
post-persist commit semantics.

HLC segment naming follows the reference's
``<table>__<instance>__<group>__<seq>`` convention.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

import shutil

from pinot_tpu_torch.common.table_name import raw_table
from pinot_tpu_torch.ingestion.transformer import CompoundTransformer
from pinot_tpu_torch.realtime import converter
from pinot_tpu_torch.realtime.mutable_segment import MutableSegmentImpl
from pinot_tpu_torch.realtime.stream import StreamConfig
from pinot_tpu_torch.segment.loader import ImmutableSegmentLoader

log = logging.getLogger(__name__)

CONSUMERS = "/CONSUMERS"
_POLL_S = 0.05


class HLRealtimeSegmentDataManager:
    """Group-consume → index → flush-local → checkpoint loop for one
    (table, consumer group) on one server instance."""

    def __init__(self, table: str, schema, table_config,
                 stream_config: StreamConfig, group_id: str, store,
                 table_data_manager, instance_id: str, work_dir: str,
                 on_segment_flushed: Optional[Callable] = None,
                 batch_rows: int = 1000, stats_history=None):
        self.table = table
        self.schema = schema
        self.table_config = table_config
        self.stream_config = stream_config
        self.group_id = group_id
        self.store = store
        self.tdm = table_data_manager
        self.instance_id = instance_id
        self.work_dir = work_dir
        self.on_segment_flushed = on_segment_flushed
        self.batch_rows = batch_rows
        self.stats_history = stats_history
        self.transformer = CompoundTransformer(schema)
        self.segments_flushed = 0

        rec = store.get(self._ckpt_path) or {}
        self._seq = int(rec.get("sequence", 0))
        checkpoint = {int(k): int(v)
                      for k, v in (rec.get("offsets") or {}).items()}
        self.consumer = stream_config.consumer_factory \
            .create_stream_consumer(stream_config, checkpoint or None)
        # restart: re-serve previously flushed local segments (parity:
        # the reference HLC re-loads its local segments via Helix on
        # restart — the checkpoint skips their rows, so without this
        # they would be lost)
        for seq in range(self._seq):
            seg_dir = os.path.join(work_dir, self._segment_name(seq))
            if os.path.isdir(seg_dir) and \
                    self._segment_name(seq) not in \
                    table_data_manager.segment_names():
                try:
                    table_data_manager.add_segment(
                        ImmutableSegmentLoader.load(seg_dir))
                except Exception:  # noqa: BLE001 — torn local artifact:
                    log.exception("could not reload flushed segment %s",
                                  seg_dir)
        self.mutable: MutableSegmentImpl = self._new_consuming_segment()
        self._deadline = time.monotonic() + \
            stream_config.flush_threshold_time_ms / 1e3
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"hlc-{table}-{group_id}")
        self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    @property
    def _ckpt_path(self) -> str:
        return f"{CONSUMERS}/{self.table}/{self.group_id}"

    def _segment_name(self, seq: int) -> str:
        return (f"{raw_table(self.table)}__{self.instance_id}__"
                f"{self.group_id}__{seq}")

    def _new_consuming_segment(self) -> MutableSegmentImpl:
        # allocation sizing from prior flushes (RealtimeSegmentStatsHistory
        # parity — same feedback loop as the LLC path)
        hint = self.stats_history.estimate(self.table) \
            if self.stats_history is not None else None
        mutable = MutableSegmentImpl(self.schema, self.table_config,
                                     self._segment_name(self._seq),
                                     stats_hint=hint)
        # queryable from the first row (refcounted like any segment)
        self.tdm.add_segment(mutable)
        return mutable

    def stop(self) -> None:
        self._stop.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=10)
        try:
            self.consumer.close()
        except Exception:  # noqa: BLE001
            pass

    # -- consume loop ------------------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                if self.mutable.num_docs >= \
                        self.stream_config.flush_threshold_rows or \
                        (time.monotonic() >= self._deadline and
                         self.mutable.num_docs > 0):
                    self._flush()
                    continue
                try:
                    msgs = self.consumer.next_messages(self.batch_rows)
                except Exception:  # noqa: BLE001 — flaky stream:
                    log.warning("HLC fetch failed for %s/%s; retrying",
                                self.table, self.group_id, exc_info=True)
                    self._stop.wait(_POLL_S)
                    continue
                if not msgs:
                    self._stop.wait(_POLL_S)
                    continue
                for msg in msgs:
                    row = self.stream_config.decoder.decode(msg.value)
                    if row is not None:
                        try:
                            row = self.transformer.transform(row)
                        except Exception:  # noqa: BLE001 — poison record
                            row = None
                    if row is None:
                        continue
                    self.mutable.index_row(row)
        except Exception:  # noqa: BLE001 — keep the server alive
            log.exception("HLC consumer %s/%s died", self.table,
                          self.group_id)

    def _flush(self) -> None:
        """Convert the consuming segment to an immutable one IN PLACE
        (same name → refcounted swap in the data manager), then persist
        the consumer checkpoint — durability before commit."""
        name = self.mutable.segment_name
        # before the swap drops the mutable's buffers; guarded — the
        # O(docs) stat pass is wasted without a history to record into
        stats = self.mutable.collect_stats() \
            if self.stats_history is not None else None
        out_dir = os.path.join(self.work_dir, name)
        # a crash between flush and checkpoint replays this sequence —
        # never build into a directory holding a previous torn attempt
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir, exist_ok=True)
        meta = converter.convert(self.mutable, out_dir, name)
        immutable = ImmutableSegmentLoader.load(out_dir)
        self.tdm.add_segment(immutable)        # same-name swap
        if self.on_segment_flushed is not None:
            try:
                self.on_segment_flushed(self.table, name, out_dir, meta,
                                        self.instance_id)
            except Exception:  # noqa: BLE001 — registration is advisory
                log.exception("segment-flushed callback failed for %s",
                              name)
        self._seq += 1
        self.store.set(self._ckpt_path, {
            "offsets": {str(p): int(o)
                        for p, o in self.consumer.checkpoint().items()},
            "sequence": self._seq,
            "lastSegment": name,
            "updatedAtMs": int(time.time() * 1e3),
        })
        self.segments_flushed += 1
        if self.stats_history is not None:
            self.stats_history.add_segment_stats(self.table, stats)
        log.info("HLC flushed %s (%d docs), checkpoint persisted",
                 name, meta.total_docs)
        self.mutable = self._new_consuming_segment()
        self._deadline = time.monotonic() + \
            self.stream_config.flush_threshold_time_ms / 1e3
