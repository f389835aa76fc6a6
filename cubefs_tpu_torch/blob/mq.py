"""Persistent message queue: the async repair/delete bus.

Role parity: the reference pushes shard-repair and blob-delete events
through Kafka (blobstore/proxy/mq, scheduler/blob_deleter.go:315). A
broker dependency is out of scope for a storage framework's core, so
this is a durable append-log queue (jsonl + consumer offset file) with
the same at-least-once + ack semantics the consumers rely on.

Offsets are ABSOLUTE and never renumbered: compaction drops the acked
prefix by advancing a base watermark (recorded as the log's header
line), so offsets a consumer obtained from poll() before a compaction
stay valid for ack() after it — renumbering would turn in-flight acks
into destructive over-acks of unacked messages.

The port's copy of ``cubefs_tpu/blob/mq.py``: the local queue. The
raft-replicated topic (``ReplicatedQueue``, ``QueueProducer``) waits for
the port's raft.
"""

from __future__ import annotations

import json
import os

from ..utils import lockwitness


class MessageQueue:
    # acked prefix kept before compaction kicks in: bounds memory AND
    # restart-replay cost for high-volume topics (per-request S3 audit)
    COMPACT_THRESHOLD = 4096

    def __init__(self, path: str | None = None, topic: str = "q"):
        self._lock = lockwitness.make_lock("MessageQueue._lock")
        self._mem: list[dict] = []  # messages from absolute index _base
        self._base = 0  # absolute index of _mem[0]
        self._offset = 0  # absolute ack watermark (next to deliver)
        self._log = None
        self._offset_path = None
        if path:
            os.makedirs(path, exist_ok=True)
            log_path = os.path.join(path, f"{topic}.jsonl")
            self._offset_path = os.path.join(path, f"{topic}.offset")
            if os.path.exists(log_path):
                for line in open(log_path):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break
                    if isinstance(rec, dict) and "__base__" in rec:
                        self._base = int(rec["__base__"])
                    else:
                        self._mem.append(rec)
            if os.path.exists(self._offset_path):
                try:
                    self._offset = int(open(self._offset_path).read().strip() or 0)
                except ValueError:
                    self._offset = 0
            self._offset = max(self._offset, self._base)
            self._log = open(log_path, "a")

    def put(self, msg: dict) -> None:
        with self._lock:
            self._mem.append(msg)
            if self._log is not None:
                self._log.write(json.dumps(msg) + "\n")
                self._log.flush()

    def poll(self, max_n: int = 64) -> list[tuple[int, dict]]:
        """Peek up to max_n unacked messages as (absolute offset, msg);
        consumers ack() the highest offset they fully processed
        (at-least-once)."""
        with self._lock:
            start = max(self._offset, self._base)
            end = min(start + max_n, self._base + len(self._mem))
            return [(i, self._mem[i - self._base])
                    for i in range(start, end)]

    def ack(self, offset: int) -> None:
        with self._lock:
            self._offset = max(self._offset, offset + 1)
            if self._offset_path:
                with open(self._offset_path, "w") as f:
                    f.write(str(self._offset))
            if self._offset - self._base >= self.COMPACT_THRESHOLD:
                self._compact_locked()

    def _compact_locked(self) -> None:
        """Drop the acked prefix: rewrite the log as a base-header line
        plus the unacked tail (tmp + fsync + atomic replace). The offset
        file is untouched — offsets are absolute, so a crash anywhere in
        this sequence replays at-least-once and loses nothing. An I/O
        failure (e.g. ENOSPC) aborts the compaction with the queue fully
        usable: in-memory state and the append handle are only swapped
        after the replace succeeds."""
        keep = self._mem[self._offset - self._base:]
        new_base = self._offset
        if self._log is None:
            self._mem = keep
            self._base = new_base
            return
        log_path = self._log.name
        tmp = log_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps({"__base__": new_base}) + "\n")
                for msg in keep:
                    f.write(json.dumps(msg) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, log_path)
            new_log = open(log_path, "a")
        except OSError:
            # abort: the original log file and append handle still stand
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._log.close()
        self._log = new_log
        self._mem = keep
        self._base = new_base

    def backlog(self) -> int:
        with self._lock:
            return self._base + len(self._mem) - max(self._offset, self._base)
