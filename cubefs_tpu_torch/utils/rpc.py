"""Minimal HTTP RPC: JSON args and binary payloads (stdlib only).

The port's trimmed copy of the server half of ``cubefs_tpu/utils/rpc.py``
and a bare client, so that the reference's clients (its ``rpc.call`` and
the native C client) and the port's serve each other unchanged.

Wire shape: ``POST /<method>`` with JSON args in the ``X-Rpc-Args``
header and an optional binary body, whose zlib CRC32 may ride in
``X-Rpc-Crc``; the reply mirrors it (JSON meta in ``X-Rpc-Resp``, binary
body). Errors are HTTP 4xx/5xx with ``{"error": message}`` as the meta.
``GET /metrics`` serves the process's registry in Prometheus text. An
``X-Trace`` header is accepted and ignored: the port records no spans.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import metrics


class RpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"rpc {code}: {message}")
        self.code = code
        self.message = message


def expose(obj) -> dict:
    """Collect rpc_* methods from a service object into a route table."""
    return {
        name[len("rpc_"):]: getattr(obj, name)
        for name in dir(obj)
        if name.startswith("rpc_") and callable(getattr(obj, name))
    }


class _Server(ThreadingHTTPServer):
    # socketserver's default backlog of 5 resets connections when dozens
    # of storage-node clients connect at once
    request_queue_size = 128


class RpcServer:
    """Threaded HTTP server over a route table of callables
    ``fn(args: dict, body: bytes) -> (dict, bytes) | dict | bytes | None``.
    Each request runs on a thread of its own."""

    def __init__(self, routes: dict, host: str = "127.0.0.1", port: int = 0):
        self.routes = dict(routes)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.split("?", 1)[0] == "/metrics":
                    self._reply_raw(200, metrics.render_text().encode(),
                                    "text/plain; version=0.0.4")
                else:
                    self._reply_raw(404, b"not found", "text/plain")

            def _reply_raw(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                name = self.path.lstrip("/")
                fn = outer.routes.get(name)
                if fn is None:
                    self._reply(404, {"error": f"no such method {name!r}"}, b"")
                    return
                t0 = time.perf_counter()
                code = 200
                try:
                    args = json.loads(self.headers.get("X-Rpc-Args") or "{}")
                    n = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(n) if n else b""
                    want_crc = self.headers.get("X-Rpc-Crc")
                    if want_crc is not None:
                        try:
                            expect = int(want_crc)
                        except ValueError:
                            raise RpcError(400, "malformed X-Rpc-Crc") from None
                        if zlib.crc32(body) != expect:
                            raise RpcError(400, "request body crc mismatch")
                    meta, payload = _normalize(fn(args, body))
                    self._reply(200, meta, payload)
                except RpcError as e:
                    code = e.code
                    self._reply(e.code, {"error": e.message}, b"")
                except Exception as e:  # the boundary: a 500 with the message
                    code = 500
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"}, b"")
                finally:
                    metrics.rpc_requests.inc(method=name, code=code)
                    metrics.rpc_latency.observe(time.perf_counter() - t0, method=name)

            def _reply(self, code: int, meta: dict, payload: bytes):
                self.send_response(code)
                self.send_header("X-Rpc-Resp", json.dumps(meta))
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = _Server((host, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving and close the socket; call only after ``start``."""
        self._httpd.shutdown()
        self._httpd.server_close()


def _normalize(out) -> tuple[dict, bytes]:
    if out is None:
        return {}, b""
    if isinstance(out, tuple):
        meta, payload = out
        return meta or {}, payload or b""
    if isinstance(out, (bytes, bytearray, memoryview)):
        return {}, bytes(out)
    return out, b""


def call(addr: str, method: str, args: dict | None = None, body: bytes = b"",
         timeout: float = 30.0) -> tuple[dict, bytes]:
    """Invoke ``method`` on the RpcServer at ``host:port`` over a fresh
    connection; returns (meta, payload). A reply other than 200 raises
    RpcError with the server's code and message."""
    headers = {"X-Rpc-Args": json.dumps(args or {})}
    if body:
        headers["X-Rpc-Crc"] = str(zlib.crc32(body))
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("POST", f"/{method}", body=body or b"", headers=headers)
        resp = conn.getresponse()
        payload = resp.read()
        meta_raw = resp.headers.get("X-Rpc-Resp")
    finally:
        conn.close()
    if resp.status != 200:
        try:
            msg = json.loads(meta_raw or "{}").get("error", f"http {resp.status}")
        except ValueError:
            msg = f"http {resp.status}"
        raise RpcError(resp.status, msg)
    return json.loads(meta_raw or "{}"), payload
