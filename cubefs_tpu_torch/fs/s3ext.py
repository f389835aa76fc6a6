"""S3 interop edges: streaming chunked signatures, POST policy uploads,
and a minimal STS surface.

Role parity: objectnode/auth_signature_chunk.go (aws-chunked payload
signing — real AWS SDKs send `STREAMING-AWS4-HMAC-SHA256-PAYLOAD` on
large PUTs), objectnode/post_policy.go (browser form uploads) and
objectnode/sts.go (temporary credentials). Everything is stdlib crypto;
the SigV4 key chain comes from s3auth.signing_key.

The port's copy of ``cubefs_tpu/fs/s3ext.py``.
"""

from __future__ import annotations

import base64
import calendar
import hashlib
import hmac
import json
import secrets
import time

from . import s3auth

STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
EMPTY_SHA = hashlib.sha256(b"").hexdigest()


# ---------------- aws-chunked payload signing -------------------------

def _chunk_string_to_sign(amz_date: str, scope: str, prev_sig: str,
                          data: bytes) -> str:
    return "\n".join([
        "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev_sig,
        EMPTY_SHA, hashlib.sha256(data).hexdigest(),
    ])


def _iter_chunks(body: bytes):
    """THE aws-chunked framing parser (one parser, two consumers): yield
    (data, signature) per chunk including the final empty one; raise
    ValueError on malformed framing."""
    pos = 0
    while True:
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise ValueError("truncated chunk header")
        head = body[pos:nl].decode("ascii", "replace")
        size_s, _, ext = head.partition(";")
        try:
            size = int(size_s, 16)
        except ValueError:
            raise ValueError(f"bad chunk size {size_s!r}") from None
        sig = (ext[len("chunk-signature="):]
               if ext.startswith("chunk-signature=") else "")
        data = body[nl + 2:nl + 2 + size]
        if len(data) != size:
            raise ValueError("truncated chunk data")
        yield data, sig
        pos = nl + 2 + size
        if size == 0:
            return  # final chunk; anything after is optional trailers
        if body[pos:pos + 2] != b"\r\n":
            raise ValueError("missing chunk CRLF")
        pos += 2


def verify_aws_chunked(body: bytes, seed_sig: str, key: bytes,
                       amz_date: str, scope: str) -> tuple[bool, bytes | str]:
    """Decode aws-chunked framing (`<hex-size>;chunk-signature=<sig>\\r\\n
    <data>\\r\\n` … `0;chunk-signature=<sig>\\r\\n\\r\\n`), verifying each
    chunk's signature chains from the previous (seed = the Authorization
    header's signature). Returns (True, decoded_payload) or
    (False, reason) — a single forged/reordered/substituted chunk breaks
    the chain."""
    out = bytearray()
    prev = seed_sig
    try:
        for data, sig in _iter_chunks(body):
            if not sig:
                return False, "missing chunk-signature"
            expect = hmac.new(
                key,
                _chunk_string_to_sign(amz_date, scope, prev, data).encode(),
                hashlib.sha256).hexdigest()
            if not hmac.compare_digest(expect, sig):
                return False, "chunk signature mismatch"
            prev = expect
            out.extend(data)
    except ValueError as e:
        return False, str(e)
    return True, bytes(out)


def strip_aws_chunked(body: bytes) -> bytes:
    """Framing removal WITHOUT verification — for gateways running with
    no authenticator, where there is no key to verify against.
    Best-effort: malformed framing yields the chunks parsed so far."""
    out = bytearray()
    try:
        for data, _sig in _iter_chunks(body):
            out.extend(data)
    except ValueError:
        pass
    return bytes(out)


def build_aws_chunked(payload: bytes, chunk_size: int, seed_sig: str,
                      key: bytes, amz_date: str, scope: str) -> bytes:
    """Client-side encoder (tests/CLI): produce the exact on-the-wire
    body an AWS SDK sends for a streaming-signed PUT."""
    out = bytearray()
    prev = seed_sig
    chunks = [payload[i:i + chunk_size]
              for i in range(0, len(payload), chunk_size)] + [b""]
    for data in chunks:
        sig = hmac.new(
            key, _chunk_string_to_sign(amz_date, scope, prev, data).encode(),
            hashlib.sha256).hexdigest()
        out.extend(f"{len(data):x};chunk-signature={sig}\r\n".encode())
        out.extend(data)
        if data:
            out.extend(b"\r\n")
        prev = sig
    out.extend(b"\r\n")
    return bytes(out)


# ---------------- POST policy uploads ---------------------------------

def parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    """Minimal multipart/form-data parser: field name -> raw value (the
    `file` part keeps its bytes)."""
    b_idx = content_type.find("boundary=")
    if b_idx < 0:
        return {}
    boundary = content_type[b_idx + 9:].split(";")[0].strip().strip('"')
    delim = b"--" + boundary.encode()
    fields: dict[str, bytes] = {}
    # split()[1:] skips the preamble; a part is "\r\n<headers>\r\n\r\n
    # <value>\r\n" — strip EXACTLY the framing CRLFs, never the value's
    # own trailing newline bytes (an unbounded strip would silently
    # truncate uploads ending in \r or \n)
    for part in body.split(delim)[1:]:
        if part.startswith(b"--"):
            break  # closing boundary
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        head, _, value = part.partition(b"\r\n\r\n")
        name = filename = None
        for line in head.split(b"\r\n"):
            lo = line.decode("latin1")
            if lo.lower().startswith("content-disposition:"):
                for item in lo.split(";"):
                    item = item.strip()
                    if item.startswith("name="):
                        name = item[5:].strip('"')
                    elif item.startswith("filename="):
                        filename = item[9:].strip('"')
        if name:
            fields[name] = value
            if filename is not None:
                # reserved dotted key: S3's ${filename} substitution
                # needs the upload part's client-supplied filename
                fields[f".filename.{name}"] = filename.encode()
    return fields


def _parse_iso8601(s: str) -> float | None:
    for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
        try:
            return calendar.timegm(time.strptime(s, fmt))
        except ValueError:
            continue
    return None


def verify_post_policy(fields: dict[str, bytes], secret_for,
                       now: float | None = None,
                       implicit: dict[str, str] | None = None
                       ) -> tuple[bool, str]:
    """Verify a browser POST upload form (post_policy.go): the signature
    is the SigV4 chain applied to the base64 policy document; the policy
    must be unexpired and every condition must hold against the form.
    `implicit` supplies request-derived values that are not form fields
    (S3's `bucket` condition matches the URL's bucket). Returns
    (True, access_key) or (False, reason)."""
    try:
        policy_b64 = fields["policy"].decode()
        cred = fields["x-amz-credential"].decode()
        amz_date = fields["x-amz-date"].decode()
        sig = fields["x-amz-signature"].decode()
        algo = fields.get("x-amz-algorithm", b"").decode()
    except KeyError as e:
        return False, f"missing form field {e}"
    if algo != "AWS4-HMAC-SHA256":
        return False, "unsupported x-amz-algorithm"
    try:
        ak, date, region, service, _term = cred.split("/", 4)
    except ValueError:
        return False, "malformed x-amz-credential"
    sk = secret_for(ak)
    if sk is None:
        return False, f"unknown access key {ak}"
    key = s3auth.signing_key(sk, date, region, service)
    expect = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, sig):
        return False, "policy signature mismatch"
    try:
        policy = json.loads(base64.b64decode(policy_b64))
    except (ValueError, json.JSONDecodeError):
        return False, "malformed policy document"
    exp = _parse_iso8601(policy.get("expiration", ""))
    if exp is None:
        return False, "policy has no valid expiration"
    if (time.time() if now is None else now) > exp:
        return False, "policy expired"
    try:
        for cond in policy.get("conditions", []):
            if isinstance(cond, dict):
                items = [("eq", k, v) for k, v in cond.items()]
            elif isinstance(cond, list) and len(cond) == 3:
                items = [tuple(cond)]
            else:
                return False, f"malformed condition {cond!r}"
            for op, k, v in items:
                if op == "content-length-range":
                    n = len(fields.get("file", b""))
                    if not (int(k) <= n <= int(v)):
                        return False, "content-length-range violated"
                    continue
                name = str(k).lstrip("$").lower()
                if implicit and name in implicit:
                    got = implicit[name]
                else:
                    got = fields.get(name, b"").decode("utf-8", "replace")
                if op == "eq":
                    if got != v:
                        return False, f"condition eq failed for {name}"
                elif op == "starts-with":
                    if not got.startswith(v):
                        return False, f"condition starts-with failed for {name}"
                else:
                    return False, f"unsupported condition op {op!r}"
    except (TypeError, ValueError):
        # a correctly-signed but malformed policy (non-numeric range
        # bounds, non-string values) is a REJECTION, not a crashed
        # handler thread
        return False, "malformed condition value"
    return True, ak


# ---------------- STS (temporary credentials) -------------------------

class Sts:
    """Stateless temporary-credential issuer (sts.go role): the session
    token IS the state — a MAC'd claim of (parent key, temp key, expiry)
    — and the temp secret is derived from the server key, so any gateway
    holding the same Sts key can validate without shared storage."""

    MAX_DURATION = 12 * 3600

    def __init__(self, key: bytes | None = None):
        self.key = key or secrets.token_bytes(32)

    def _temp_sk(self, tak: str, exp: int) -> str:
        return hmac.new(self.key, f"sk|{tak}|{exp}".encode(),
                        hashlib.sha256).hexdigest()[:40]

    def issue(self, parent_ak: str, duration: int = 3600,
              now: float | None = None) -> dict:
        exp = int((time.time() if now is None else now)
                  + max(900, min(duration, self.MAX_DURATION)))
        tak = "ASIA" + secrets.token_hex(8).upper()
        payload = json.dumps({"pak": parent_ak, "tak": tak, "exp": exp},
                             sort_keys=True).encode()
        mac = hmac.new(self.key, payload, hashlib.sha256).digest()
        return {
            "access_key": tak,
            "secret_key": self._temp_sk(tak, exp),
            "session_token": base64.b64encode(payload + mac).decode(),
            "expiration": exp,
        }

    def resolve(self, token: str, now: float | None = None) -> dict | None:
        """Validate a session token; returns {"pak","tak","sk","exp"} or
        None (invalid/expired)."""
        try:
            raw = base64.b64decode(token)
            payload, mac = raw[:-32], raw[-32:]
        except (ValueError, IndexError):
            return None
        if len(raw) <= 32 or not hmac.compare_digest(
                mac, hmac.new(self.key, payload, hashlib.sha256).digest()):
            return None
        try:
            claims = json.loads(payload)
        except json.JSONDecodeError:
            return None
        if claims.get("exp", 0) < (time.time() if now is None else now):
            return None
        return {"pak": claims["pak"], "tak": claims["tak"],
                "sk": self._temp_sk(claims["tak"], claims["exp"]),
                "exp": claims["exp"]}
