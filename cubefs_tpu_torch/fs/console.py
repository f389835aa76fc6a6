"""Console: web dashboard + authenticated management APIs.

Role parity: console/ (GraphQL proxy dashboard over master APIs,
console/service/) and master's GraphQL admin surface
(master/gapi_user.go: createUser/deleteUser/grant/revoke...). Read
panels are open JSON/HTML; management rides POST /api/graphql — a
dependency-free GraphQL subset (one operation, scalar arguments,
selection sets used as output filters) — behind POST /api/login, which
verifies AK/SK against the master's replicated user registry and issues
an HMAC session token.

The port's copy of ``cubefs_tpu/fs/console.py``: its resolvers call the
master through the port's ``sdk.MasterClient``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import html
import json
import re
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils import rpc


class ConsoleAuthError(Exception):
    pass


class GraphqlError(Exception):
    pass


# one operation with scalar args: mutation { grant(ak: "x", volume: "v",
# perm: "rw") { ok } }  /  query { users { userId accessKey } }
_GQL_RE = re.compile(
    r"^\s*(query|mutation)?\s*(?:\w+\s*)?\{\s*(\w+)\s*"
    r"(?:\(([^)]*)\))?\s*(?:\{([^}]*)\})?\s*\}\s*$")
_ARG_RE = re.compile(r"(\w+)\s*:\s*(\"(?:[^\"\\]|\\.)*\"|\$\w+|-?\d+|true|false)")


class Console:
    def __init__(self, master_addr: str | None = None,
                 clustermgr_addr: str | None = None,
                 scheduler_addr: str | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 admin_ids: set[str] | None = None):
        self.master = master_addr
        self.cm = clustermgr_addr
        self.scheduler = scheduler_addr
        # user_ids allowed to run mutations (gapi_user.go's admin gate)
        self.admin_ids = admin_ids if admin_ids is not None else {
            "root", "admin"}
        self._session_key = secrets.token_bytes(32)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                routes = {
                    "/api/state": outer.state,
                    "/api/nodes": outer.nodes,
                    "/api/volumes": outer.volumes,
                    "/api/tasks": outer.tasks,
                }
                fn = routes.get(self.path)
                if fn is not None:
                    try:
                        body = json.dumps(fn()).encode()
                        code = 200
                    except Exception as e:
                        body = json.dumps({"error": str(e)}).encode()
                        code = 502
                    ctype = "application/json"
                else:
                    body = outer.render().encode()
                    code, ctype = 200, "text/html; charset=utf-8"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "malformed JSON body"})
                if self.path == "/api/login":
                    try:
                        token = outer.login(req.get("access_key", ""),
                                            req.get("secret_key", ""))
                    except ConsoleAuthError as e:
                        return self._json(403, {"error": str(e)})
                    except Exception as e:  # master outage != bad creds
                        return self._json(502, {"error": str(e)})
                    return self._json(200, {"token": token})
                if self.path == "/api/graphql":
                    tok = self.headers.get("X-Console-Token", "")
                    try:
                        who = outer.check_token(tok)
                        data = outer.graphql(req.get("query", ""),
                                             req.get("variables") or {},
                                             principal=who)
                    except ConsoleAuthError as e:
                        return self._json(403, {"error": str(e)})
                    except GraphqlError as e:
                        return self._json(200, {"errors": [str(e)]})
                    except Exception as e:
                        return self._json(502, {"error": str(e)})
                    return self._json(200, {"data": data})
                self._json(404, {"error": f"no such endpoint {self.path}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    # ---------------- authenticated management (gapi_user.go role) ----
    SESSION_TTL = 3600.0
    _MAC_LEN = 32  # fixed-width suffix: the raw digest may contain any
    #                byte, so delimiter-splitting it would be ambiguous

    def _mc(self):
        from ..sdk import MasterClient

        return MasterClient(self.master)

    def login(self, ak: str, sk: str) -> str:
        """Verify AK/SK against the master's user registry; return an
        HMAC session token (ak|user_id|exp + MAC) for /api/graphql."""
        if not self.master:
            raise ConsoleAuthError("console has no master configured")
        try:
            info = self._call(self.master, "user_auth_info", {"ak": ak})
        except rpc.RpcError as e:
            if 400 <= e.code < 500:
                raise ConsoleAuthError("unknown access key") from None
            raise  # master outage is a 502, not 'bad credentials'
        if not info or not hmac.compare_digest(info.get("sk") or "", sk):
            raise ConsoleAuthError("bad credentials")
        exp = int(time.time() + self.SESSION_TTL)
        payload = f"{ak}|{info.get('user_id', '')}|{exp}".encode()
        mac = hmac.new(self._session_key, payload, hashlib.sha256).digest()
        return base64.b64encode(payload + mac).decode()

    def check_token(self, token: str) -> tuple[str, str]:
        """Returns (access_key, user_id) of a valid session."""
        try:
            raw = base64.b64decode(token)
            payload, mac = raw[:-self._MAC_LEN], raw[-self._MAC_LEN:]
            ak, user_id, exp = payload.decode().rsplit("|", 2)
        except (ValueError, TypeError):
            raise ConsoleAuthError("malformed token") from None
        want = hmac.new(self._session_key, payload, hashlib.sha256).digest()
        if len(raw) <= self._MAC_LEN or not hmac.compare_digest(mac, want):
            raise ConsoleAuthError("invalid token")
        if int(exp) < time.time():
            raise ConsoleAuthError("session expired")
        return ak, user_id

    def graphql(self, query: str, variables: dict,
                principal: tuple[str, str]) -> dict:
        """Execute one GraphQL-subset operation against the master.
        Queries need any valid session; MUTATIONS need an admin
        principal (user_id in admin_ids — gapi_user.go gates its
        mutations on the admin user the same way)."""
        m = _GQL_RE.match(query or "")
        if m is None:
            raise GraphqlError("unsupported query shape")
        op_kind, field, raw_args, selection = m.groups()
        op_kind = op_kind or "query"
        if op_kind == "mutation" and principal[1] not in self.admin_ids:
            raise ConsoleAuthError(
                f"user {principal[1]!r} may not run mutations")
        args = {}
        for k, v in _ARG_RE.findall(raw_args or ""):
            if v.startswith("$"):
                if v[1:] not in variables:
                    raise GraphqlError(f"undefined variable {v}")
                args[k] = variables[v[1:]]
            elif v.startswith('"'):
                args[k] = json.loads(v)
            elif v in ("true", "false"):
                args[k] = v == "true"
            else:
                args[k] = int(v)
        resolver = self._RESOLVERS.get((op_kind, field))
        if resolver is None:
            raise GraphqlError(f"unknown field {field!r}")
        out = resolver(self, args)
        if selection and isinstance(out, dict):
            keys = selection.split()
            out = {k: v for k, v in out.items() if k in keys}
        return {field: out}

    # resolvers (master/gapi_user.go + console/service vol ops), through
    # the typed MasterClient — no hand-rolled method strings
    def _gq_users(self, args):
        return self._mc().list_users()

    def _gq_volumes(self, args):
        return self.volumes()

    def _gq_nodes(self, args):
        return self.nodes()

    def _gq_cluster(self, args):
        return self._mc().stat()

    def _gq_create_user(self, args):
        return self._mc().create_user(args["userId"])

    def _gq_delete_user(self, args):
        self._mc().delete_user(args["ak"])
        return {"ok": True}

    def _gq_grant(self, args):
        self._mc().grant(args["ak"], args["volume"],
                         args.get("perm", "rw"))
        return {"ok": True}

    def _gq_revoke(self, args):
        self._mc().revoke(args["ak"], args["volume"])
        return {"ok": True}

    def _gq_create_volume(self, args):
        return self._mc().create_volume(args["name"],
                                        mp_count=args.get("mpCount", 3),
                                        dp_count=args.get("dpCount", 4))

    def _gq_set_capacity(self, args):
        self._mc().set_vol_capacity(args["name"], args["capacity"])
        return {"ok": True}

    _RESOLVERS = {
        ("query", "users"): _gq_users,
        ("query", "volumes"): _gq_volumes,
        ("query", "nodes"): _gq_nodes,
        ("query", "clusterStat"): _gq_cluster,
        ("mutation", "createUser"): _gq_create_user,
        ("mutation", "deleteUser"): _gq_delete_user,
        ("mutation", "grant"): _gq_grant,
        ("mutation", "revoke"): _gq_revoke,
        ("mutation", "createVolume"): _gq_create_volume,
        ("mutation", "setVolCapacity"): _gq_set_capacity,
    }

    # ---------------- data panels ----------------
    def _call(self, addr: str, method: str, args: dict | None = None):
        return rpc.call(addr, method, args, timeout=5)[0]

    def state(self) -> dict:
        out: dict = {}
        for name, addr in (("master", self.master), ("clustermgr", self.cm),
                           ("scheduler", self.scheduler)):
            if not addr:
                continue
            try:
                out[name] = {"addr": addr,
                             "stat": self._call(addr, "stat")}
            except Exception as e:
                out[name] = {"addr": addr, "error": str(e)}
        return out

    def nodes(self) -> dict:
        if not self.master:
            return {}
        return self._call(self.master, "node_list")

    def volumes(self) -> dict:
        if not self.master:
            return {}
        stat = self._call(self.master, "stat")
        out = {}
        for name in stat.get("volumes", []):
            try:
                view = self._call(self.master, "client_view",
                                  {"name": name})["volume"]
                out[name] = {
                    "mps": len(view["mps"]),
                    "dps": len(view["dps"]),
                    "quotas": len(view.get("quotas") or {}),
                    "packet_nodes": len(view.get("packet_addrs") or {}),
                }
            except Exception as e:
                out[name] = {"error": str(e)}
        return out

    def tasks(self) -> dict:
        if not self.scheduler:
            return {}
        return self._call(self.scheduler, "task_switch", {"action": "list"})

    # ---------------- HTML ----------------
    @staticmethod
    def _table(title: str, headers: list[str], rows: list[list]) -> str:
        head = "".join(f"<th>{html.escape(h)}</th>" for h in headers)
        body = "".join(
            "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in r)
            + "</tr>"
            for r in rows
        )
        return (f"<h2>{html.escape(title)}</h2>"
                f"<table border=1 cellpadding=4 cellspacing=0>"
                f"<tr>{head}</tr>{body}</table>")

    def render(self) -> str:
        parts = ["<!doctype html><title>cubefs-tpu console</title>"
                 "<h1>cubefs-tpu cluster</h1>"]
        st = self.state()
        for name, info in st.items():
            detail = json.dumps(info.get("stat") or info.get("error"),
                                indent=1)
            parts.append(
                f"<h2>{html.escape(name)} @ {html.escape(info['addr'])}"
                f" <a href='http://{html.escape(info['addr'])}/metrics'>"
                f"metrics</a></h2><pre>{html.escape(detail)}</pre>")
        try:
            nodes = self.nodes()
        except Exception:
            nodes = {}
        for kind in ("datanodes", "metanodes"):
            if nodes.get(kind):
                parts.append(self._table(
                    kind, ["addr", "zone", "live", "decommissioned"],
                    [[a, i["zone"], i["live"], i["decommissioned"]]
                     for a, i in sorted(nodes[kind].items())]))
        try:
            vols = self.volumes()
        except Exception:
            vols = {}
        if vols:
            parts.append(self._table(
                "volumes", ["name", "mps", "dps", "quotas", "packet nodes"],
                [[n, v.get("mps", "?"), v.get("dps", "?"),
                  v.get("quotas", "?"), v.get("packet_nodes", "?")]
                 for n, v in sorted(vols.items())]))
        try:
            tasks = self.tasks()
        except Exception:
            tasks = {}
        if tasks.get("switches"):
            parts.append(self._table(
                "background task switches", ["kind", "enabled"],
                sorted(tasks["switches"].items())))
        parts.append("<p>JSON: <a href='/api/state'>state</a> · "
                     "<a href='/api/nodes'>nodes</a> · "
                     "<a href='/api/volumes'>volumes</a> · "
                     "<a href='/api/tasks'>tasks</a></p>")
        return "".join(parts)

    def start(self) -> "Console":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
