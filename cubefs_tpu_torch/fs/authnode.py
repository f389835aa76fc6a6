"""AuthNode: ticket-based service authentication + user credential store.

Role parity: authnode/ (Kerberos-like ticket service: getTicket at
api_service.go:32, raft-replicated keystore FSM at keystore_fsm.go) and
master's user/AK-SK store (master/user.go). Crypto is stdlib HMAC-SHA256
(key derivation + ticket MACs) rather than a cipher dependency: tickets
are MAC-authenticated claims, and each service verifies with its own
registered key. The keystore replicates through the same apply-door
pattern as the other metadata FSMs (raft-pluggable).

The port's copy of ``cubefs_tpu/fs/authnode.py``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import time

from ..utils import lockwitness, rpc


class AuthError(Exception):
    pass


def _mac(key: bytes, payload: bytes) -> bytes:
    return hmac.new(key, payload, hashlib.sha256).digest()


class KeyStore:
    """client/service id -> secret key, with an apply-door for
    replication parity with the other FSMs."""

    def __init__(self, data_dir: str | None = None):
        self._lock = lockwitness.make_rlock("KeyStore._lock")
        self.keys: dict[str, str] = {}  # id -> b64 key
        self.data_dir = data_dir
        self._wal = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            path = os.path.join(data_dir, "keystore.jsonl")
            if os.path.exists(path):
                for line in open(path):
                    line = line.strip()
                    if line:
                        try:
                            self.apply(json.loads(line))
                        except json.JSONDecodeError:
                            break
            self._wal = open(path, "a")

    def submit(self, record: dict):
        with self._lock:
            out = self.apply(record)
            if self._wal is not None:
                self._wal.write(json.dumps(record) + "\n")
                self._wal.flush()
            return out

    def apply(self, record: dict):
        with self._lock:
            op = record["op"]
            if op == "put_key":
                self.keys[record["id"]] = record["key"]
                return {}
            if op == "del_key":
                self.keys.pop(record["id"], None)
                return {}
            raise AuthError(f"unknown keystore op {op!r}")

    def get(self, id_: str) -> bytes:
        with self._lock:
            k = self.keys.get(id_)
            if k is None:
                raise AuthError(f"no key registered for {id_!r}")
            return base64.b64decode(k)


class AuthNode:
    TICKET_TTL = 3600.0

    def __init__(self, data_dir: str | None = None):
        self.store = KeyStore(data_dir)

    # ---------------- registration ----------------
    def register(self, id_: str, key: bytes | None = None) -> bytes:
        key = key or secrets.token_bytes(32)
        self.store.submit({"op": "put_key", "id": id_,
                           "key": base64.b64encode(key).decode()})
        return key

    # ---------------- tickets ----------------
    def get_ticket(self, client_id: str, service_id: str,
                   client_proof: str) -> dict:
        """Issue a ticket for client->service. The client proves key
        possession with HMAC(client_key, client_id|service_id|minute)."""
        ckey = self.store.get(client_id)
        now = int(time.time())
        ok = any(
            hmac.compare_digest(
                client_proof,
                _mac(ckey, f"{client_id}|{service_id}|{now // 60 - d}".encode()).hex(),
            )
            for d in (0, 1)  # allow one minute of clock skew
        )
        if not ok:
            raise AuthError("client proof rejected")
        skey = self.store.get(service_id)
        session_key = secrets.token_bytes(32)
        claims = {
            "client": client_id, "service": service_id,
            "exp": time.time() + self.TICKET_TTL,
            "session": base64.b64encode(session_key).decode(),
        }
        payload = json.dumps(claims, sort_keys=True).encode()
        # MAC appended as a FIXED 32-byte suffix: raw digest bytes may
        # contain any separator byte, so delimiter-splitting is unsafe
        ticket = base64.b64encode(payload + _mac(skey, payload)).decode()
        return {"ticket": ticket,
                "session_key": base64.b64encode(session_key).decode()}

    @staticmethod
    def verify_ticket(ticket: str, service_key: bytes,
                      service_id: str) -> dict:
        """Service-side check: MAC + expiry + audience."""
        try:
            raw = base64.b64decode(ticket)
            if len(raw) <= 32:
                raise ValueError("too short")
            payload, mac = raw[:-32], raw[-32:]
        except Exception:
            raise AuthError("malformed ticket") from None
        if not hmac.compare_digest(mac, _mac(service_key, payload)):
            raise AuthError("ticket MAC invalid")
        claims = json.loads(payload)
        if claims["service"] != service_id:
            raise AuthError("ticket audience mismatch")
        if claims["exp"] < time.time():
            raise AuthError("ticket expired")
        return claims

    @staticmethod
    def client_proof(client_id: str, service_id: str, client_key: bytes) -> str:
        now = int(time.time())
        return _mac(client_key, f"{client_id}|{service_id}|{now // 60}".encode()).hex()

    # ---------------- RPC surface ----------------
    def rpc_register(self, args, body):
        key = self.register(args["id"])
        return {"key": base64.b64encode(key).decode()}

    def rpc_get_ticket(self, args, body):
        try:
            return self.get_ticket(args["client_id"], args["service_id"],
                                   args["proof"])
        except AuthError as e:
            raise rpc.RpcError(403, str(e)) from None


class UserStore:
    """AK/SK user registry with per-volume grants (master/user.go role)."""

    def __init__(self):
        self._lock = lockwitness.make_rlock("UserStore._lock")
        self.users: dict[str, dict] = {}  # ak -> {sk, user_id, policies}

    def create_user(self, user_id: str) -> dict:
        with self._lock:
            ak = secrets.token_hex(8)
            sk = secrets.token_hex(16)
            self.users[ak] = {"user_id": user_id, "sk": sk, "volumes": {}}
            return {"user_id": user_id, "access_key": ak, "secret_key": sk}

    def grant(self, ak: str, volume: str, perm: str = "rw") -> None:
        with self._lock:
            self.users[ak]["volumes"][volume] = perm

    def secret_for(self, ak: str) -> str | None:
        with self._lock:
            u = self.users.get(ak)
            return u["sk"] if u else None

    def allowed(self, ak: str, volume: str, write: bool) -> bool:
        with self._lock:
            u = self.users.get(ak)
            if u is None:
                return False
            perm = u["volumes"].get(volume, "")
            return "w" in perm if write else bool(perm)

    # ---------------- RPC surface ----------------
    def rpc_create_user(self, args, body):
        return self.create_user(args["user_id"])

    def rpc_grant(self, args, body):
        self.grant(args["ak"], args["volume"], args.get("perm", "rw"))
        return {}

    def rpc_secret_for(self, args, body):
        return {"sk": self.secret_for(args["ak"])}
