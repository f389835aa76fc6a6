"""Audit log: one jsonl record per served operation, with rotation.

Role parity: util/auditlog (every-op audit records) and
blobstore/common/rpc/auditlog (HTTP audit middleware). The RPC layer
calls `record()` around each handler when a logger is installed.

The port's copy of ``cubefs_tpu/utils/auditlog.py``: the same records
and the same rotation.
"""

from __future__ import annotations

import json
import os
import threading
import time


class AuditLogger:
    def __init__(self, path: str, max_bytes: int = 64 << 20, keep: int = 4):
        self.path = path
        self.max_bytes = max_bytes
        self.keep = keep
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def record(self, service: str, method: str, code: int, latency_s: float,
               trace_id: str = "", detail: str = "",
               tenant: str = "") -> None:
        rec = {
            "ts": round(time.time(), 3), "svc": service, "op": method,
            "code": code, "lat_ms": round(latency_s * 1000, 2),
        }
        if tenant:
            rec["tenant"] = tenant
        if trace_id:
            rec["trace"] = trace_id
        if detail:
            rec["detail"] = detail[:256]
        line = json.dumps(rec) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()
            if self._f.tell() >= self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            self._f.close()
