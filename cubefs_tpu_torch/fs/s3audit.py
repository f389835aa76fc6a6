"""S3 access-audit sinks: webhook and durable-queue fan-out.

Role parity: objectnode/audit_webhook.go (async batched HTTP POST of
audit entries to an operator endpoint) and audit_kafka.go (audit events
onto the message bus). The queue sink rides the framework's durable
jsonl MessageQueue — the same Kafka-replacement the blob plane's
repair/delete events use — so downstream consumers get at-least-once
delivery with offsets.

Sinks are fire-and-forget from the request path: the gateway never
blocks on (or fails because of) an audit destination; overflow is
counted and dropped, mirroring the reference's bounded async channel.

The port's copy of ``cubefs_tpu/fs/s3audit.py``.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.request

from ..utils import metrics

audit_events = metrics.DEFAULT.counter(
    "cubefs_s3_audit_events_total", "S3 audit events emitted", ("sink",))
audit_dropped = metrics.DEFAULT.counter(
    "cubefs_s3_audit_dropped_total", "S3 audit events dropped", ("sink",))


class WebhookAuditSink:
    """Async batched POST of audit events to an HTTP endpoint
    (audit_webhook.go): a background worker drains a bounded queue and
    ships JSON-array batches; a slow/dead endpoint drops events (with a
    counter), never backpressures the gateway."""

    def __init__(self, url: str, max_queue: int = 4096,
                 batch_size: int = 64, timeout: float = 5.0):
        self.url = url
        self.batch_size = batch_size
        self.timeout = timeout
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def emit(self, event: dict) -> None:
        try:
            self._q.put_nowait(event)
            audit_events.inc(sink="webhook")
        except queue.Full:
            audit_dropped.inc(sink="webhook")

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            while len(batch) < self.batch_size:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._post(batch)

    def _post(self, batch: list[dict]) -> None:
        try:
            req = urllib.request.Request(
                self.url, data=json.dumps(batch).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except Exception:
            audit_dropped.inc(sink="webhook", value=len(batch))

    def close(self) -> None:
        """Graceful shutdown: flush buffered events (one final batch
        round) before stopping — a clean stop must not silently lose
        audit records."""
        self._stop.set()
        self._thread.join(timeout=2)
        pending = []
        while True:
            try:
                pending.append(self._q.get_nowait())
            except queue.Empty:
                break
        for i in range(0, len(pending), self.batch_size):
            self._post(pending[i:i + self.batch_size])


class QueueAuditSink:
    """Audit events onto a durable MessageQueue topic (audit_kafka.go
    analog): consumers poll/ack with at-least-once semantics."""

    def __init__(self, mq):
        self.mq = mq

    def emit(self, event: dict) -> None:
        try:
            self.mq.put(event)
            audit_events.inc(sink="queue")
        except Exception:
            audit_dropped.inc(sink="queue")

    def close(self) -> None:
        pass
