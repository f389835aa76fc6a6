"""AWS Signature V4 verification for the S3 gateway.

Role parity: objectnode/auth_signature_v4.go — canonical request,
string-to-sign, and the AWS4-HMAC-SHA256 signing-key chain, verified
against the user store's secret keys. Header-auth flow (the one real
SDKs use); presigned URLs can layer on the same primitives.

The port's copy of ``cubefs_tpu/fs/s3auth.py``.
"""

from __future__ import annotations

import base64
import calendar
import hashlib
import hmac

from ..utils import lockwitness
import time
import urllib.parse

MAX_CLOCK_SKEW = 15 * 60.0  # seconds, AWS's +/-15min request-time window


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_request(method: str, path: str, query: str,
                      headers: dict[str, str], signed_headers: list[str],
                      payload_hash: str) -> str:
    # S3 rule: the canonical URI is the raw request path exactly as sent
    # (single-encoded by the client). Re-encoding via quote(unquote(..))
    # would collapse client escapes like %2F inside a key and diverge
    # from what AWS SDKs sign.
    canon_uri = path or "/"
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    canon_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(pairs)
    )
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers
    )
    return "\n".join([
        method, canon_uri, canon_query, canon_headers,
        ";".join(signed_headers), payload_hash,
    ])


def parse_v4_auth(headers: dict[str, str]) -> dict | None:
    """Split an AWS4-HMAC-SHA256 Authorization header into its parts
    (Credential fields, SignedHeaders, Signature) — shared by header
    verification and the streaming-chunk seed extraction."""
    auth = headers.get("authorization", "")
    if not auth.startswith("AWS4-HMAC-SHA256 "):
        return None
    parts = {}
    for item in auth[len("AWS4-HMAC-SHA256 "):].split(","):
        k, _, v = item.strip().partition("=")
        parts[k] = v
    try:
        ak, date, region, service, _term = parts["Credential"].split("/", 4)
        return {
            "ak": ak, "date": date, "region": region, "service": service,
            "signed_headers": parts["SignedHeaders"].split(";"),
            "signature": parts["Signature"],
        }
    except (KeyError, ValueError):
        return None


def verify_v4(method: str, path: str, query: str, headers: dict[str, str],
              payload: bytes, secret_for,
              now: float | None = None,
              payload_override: str | None = None) -> tuple[bool, str]:
    """Returns (ok, access_key_or_reason). headers keys must be
    lower-cased. secret_for(ak) -> sk | None. payload_override replaces
    the body-hash check with a literal canonical payload hash — used for
    STREAMING-AWS4-HMAC-SHA256-PAYLOAD where the body is authenticated
    by the per-chunk signature chain instead (the CALLER must then run
    that chain check)."""
    parsed = parse_v4_auth(headers)
    if parsed is None:
        return False, "missing/malformed AWS4-HMAC-SHA256 authorization"
    ak, date, region, service = (parsed["ak"], parsed["date"],
                                 parsed["region"], parsed["service"])
    signed_headers = parsed["signed_headers"]
    signature = parsed["signature"]
    sk = secret_for(ak)
    if sk is None:
        return False, f"unknown access key {ak}"
    # host and x-amz-date must be covered by the signature, or an
    # attacker could replay the request against another host/time
    if "host" not in signed_headers or "x-amz-date" not in signed_headers:
        return False, "host and x-amz-date must be signed"
    amz_date = headers.get("x-amz-date", "")
    if not amz_date.startswith(date):
        return False, "x-amz-date does not match credential scope date"
    try:
        req_time = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        return False, "malformed x-amz-date"
    skew = abs((time.time() if now is None else now) - req_time)
    if skew > MAX_CLOCK_SKEW:
        return False, "request time too skewed (replay window exceeded)"
    if payload_override is not None:
        payload_hash = payload_override
    elif "x-amz-content-sha256" in signed_headers:
        payload_hash = headers.get("x-amz-content-sha256", "")
        if (payload_hash != "UNSIGNED-PAYLOAD"
                and hashlib.sha256(payload).hexdigest() != payload_hash):
            return False, "payload hash mismatch"
    else:
        # the header is not covered by the signature, so its value proves
        # nothing: bind the signature to the actual body instead (blocks
        # body substitution via an attacker-supplied UNSIGNED-PAYLOAD)
        payload_hash = hashlib.sha256(payload).hexdigest()
    creq = canonical_request(method, path, query, headers, signed_headers,
                             payload_hash)
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(creq.encode()).hexdigest(),
    ])
    key = signing_key(sk, date, region, service)
    expect = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, signature):
        return False, "signature mismatch"
    return True, ak


def sign_v4(method: str, path: str, query: str, headers: dict[str, str],
            payload: bytes, ak: str, sk: str, amz_date: str,
            region: str = "us-east-1", service: str = "s3",
            payload_override: str | None = None) -> str:
    """Client-side signer (for tests and the CLI): returns the
    Authorization header value. headers must already include host and
    x-amz-date (lower-case keys). payload_override stands in for the
    body hash (streaming-signed PUTs sign the literal
    STREAMING-AWS4-HMAC-SHA256-PAYLOAD marker)."""
    date = amz_date[:8]
    payload_hash = payload_override or hashlib.sha256(payload).hexdigest()
    headers = dict(headers)
    headers.setdefault("x-amz-content-sha256", payload_hash)
    signed_headers = sorted(headers)
    creq = canonical_request(method, path, query, headers, signed_headers,
                             payload_hash)
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(signing_key(sk, date, region, service), sts.encode(),
                   hashlib.sha256).hexdigest()
    return (f"AWS4-HMAC-SHA256 Credential={ak}/{scope}, "
            f"SignedHeaders={';'.join(signed_headers)}, Signature={sig}")


def _canonical_query(pairs: list[tuple[str, str]]) -> str:
    return "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(pairs)
    )


def presign_v4(method: str, path: str, host: str, ak: str, sk: str,
               amz_date: str, expires: int = 3600,
               region: str = "us-east-1", service: str = "s3",
               extra_query: list[tuple[str, str]] | None = None) -> str:
    """Build a presigned-URL query string (SigV4 query auth): the
    signature covers the query itself (minus X-Amz-Signature) and the
    host header; the payload is UNSIGNED-PAYLOAD."""
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    q = [
        ("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
        ("X-Amz-Credential", f"{ak}/{scope}"),
        ("X-Amz-Date", amz_date),
        ("X-Amz-Expires", str(expires)),
        ("X-Amz-SignedHeaders", "host"),
        *(extra_query or []),
    ]
    creq = "\n".join([
        method, path or "/", _canonical_query(q),
        f"host:{host}\n", "host", "UNSIGNED-PAYLOAD",
    ])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(signing_key(sk, date, region, service), sts.encode(),
                   hashlib.sha256).hexdigest()
    return _canonical_query(q) + "&X-Amz-Signature=" + sig


def verify_presigned_v4(method: str, path: str, query: str,
                        host: str, secret_for,
                        now: float | None = None) -> tuple[bool, str]:
    """Verify SigV4 query-string auth. Returns (ok, ak_or_reason)."""
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    params = dict(pairs)
    if params.get("X-Amz-Algorithm") != "AWS4-HMAC-SHA256":
        return False, "unsupported algorithm"
    try:
        cred = params["X-Amz-Credential"]
        amz_date = params["X-Amz-Date"]
        expires = int(params["X-Amz-Expires"])
        signed_headers = params["X-Amz-SignedHeaders"].split(";")
        signature = params["X-Amz-Signature"]
        ak, date, region, service, _term = cred.split("/", 4)
    except (KeyError, ValueError):
        return False, "malformed presigned query"
    sk = secret_for(ak)
    if sk is None:
        return False, f"unknown access key {ak}"
    if "host" not in signed_headers:
        return False, "host must be signed"
    if not amz_date.startswith(date):
        return False, "X-Amz-Date does not match credential scope date"
    try:
        t0 = calendar.timegm(time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        return False, "malformed X-Amz-Date"
    t = time.time() if now is None else now
    if t > t0 + min(expires, 7 * 86400):
        return False, "presigned URL expired"
    if t < t0 - MAX_CLOCK_SKEW:
        return False, "presigned URL not yet valid"
    unsigned = [(k, v) for k, v in pairs if k != "X-Amz-Signature"]
    creq = "\n".join([
        method, path or "/", _canonical_query(unsigned),
        "".join(f"{h}:{host if h == 'host' else ''}\n"
                for h in signed_headers),
        ";".join(signed_headers), "UNSIGNED-PAYLOAD",
    ])
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    expect = hmac.new(signing_key(sk, date, region, service), sts.encode(),
                      hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, signature):
        return False, "signature mismatch"
    return True, ak


# ---------------- Signature V2 (objectnode/auth_signature_v2.go) -------
_V2_SUBRESOURCES = ("acl", "policy", "cors", "tagging", "uploads",
                    "uploadId", "partNumber")


def _v2_string_to_sign(method: str, path: str, query: str,
                       headers: dict[str, str]) -> str:
    amz = sorted(
        (k.lower(), " ".join(v.split()))
        for k, v in headers.items() if k.lower().startswith("x-amz-")
    )
    canon_amz = "".join(f"{k}:{v}\n" for k, v in amz)
    sub = [(k, v) for k, v in
           urllib.parse.parse_qsl(query, keep_blank_values=True)
           if k in _V2_SUBRESOURCES]
    resource = path or "/"
    if sub:
        resource += "?" + "&".join(
            k if not v else f"{k}={v}" for k, v in sorted(sub))
    date = "" if "x-amz-date" in {k for k, _ in amz} else headers.get("date", "")
    return "\n".join([
        method,
        headers.get("content-md5", ""),
        headers.get("content-type", ""),
        date,
    ]) + "\n" + canon_amz + resource


def sign_v2(method: str, path: str, query: str, headers: dict[str, str],
            ak: str, sk: str) -> str:
    sts = _v2_string_to_sign(method, path, query, headers)
    sig = base64.b64encode(
        hmac.new(sk.encode(), sts.encode(), hashlib.sha1).digest()
    ).decode()
    return f"AWS {ak}:{sig}"


def verify_v2(method: str, path: str, query: str, headers: dict[str, str],
              secret_for, now: float | None = None) -> tuple[bool, str]:
    auth = headers.get("authorization", "")
    if not auth.startswith("AWS ") or ":" not in auth:
        return False, "missing AWS v2 authorization"
    ak, _, sig = auth[4:].rpartition(":")
    sk = secret_for(ak)
    if sk is None:
        return False, f"unknown access key {ak}"
    # replay window on Date / x-amz-date
    date_hdr = headers.get("x-amz-date") or headers.get("date", "")
    req_time = None
    for fmt in ("%a, %d %b %Y %H:%M:%S GMT", "%Y%m%dT%H%M%SZ"):
        try:
            req_time = calendar.timegm(time.strptime(date_hdr, fmt))
            break
        except ValueError:
            continue
    if req_time is None:
        return False, "missing/malformed Date"
    if abs((time.time() if now is None else now) - req_time) > MAX_CLOCK_SKEW:
        return False, "request time too skewed (replay window exceeded)"
    sts = _v2_string_to_sign(method, path, query, headers)
    expect = base64.b64encode(
        hmac.new(sk.encode(), sts.encode(), hashlib.sha1).digest()
    ).decode()
    if not hmac.compare_digest(expect, sig):
        return False, "signature mismatch"
    return True, ak


class MasterUserStore:
    """UserStore backend served by the master's replicated user table
    (master/user.go flow: the gateway fetches AK/SK + grants from the
    resource manager, with a short TTL cache so authentication does not
    hit the master on every request)."""

    TTL = 30.0
    MAX_CACHE = 10_000

    def __init__(self, master_client):
        self._c = master_client
        self._cache: dict[str, tuple[float, dict | None]] = {}
        self._lock = lockwitness.make_lock("MasterUserStore._lock")

    def _info(self, ak: str) -> dict | None:
        from ..utils import rpc as _rpc

        now = time.time()
        with self._lock:
            hit = self._cache.get(ak)
            if hit and now - hit[0] < self.TTL:
                return hit[1]
        try:
            info = self._c.call("user_auth_info", {"ak": ak})[0]
        except _rpc.RpcError as e:
            if not (400 <= e.code < 500):
                # transient master failure: serve the stale cached value
                # if any, and do NOT cache the outage as "unknown key"
                return hit[1] if hit else None
            info = None  # definitive: key does not exist
        except Exception:
            return hit[1] if hit else None
        with self._lock:
            if len(self._cache) >= self.MAX_CACHE:
                # evict NEGATIVE (unknown-key) entries first — spray
                # garbage is negative by definition — then oldest, so an
                # attacker can never push out legitimate keys
                victims = sorted(
                    self._cache.items(),
                    key=lambda kv: (kv[1][1] is not None, kv[1][0]))
                for k, _ in victims[: self.MAX_CACHE // 2]:
                    del self._cache[k]
            self._cache[ak] = (now, info)
        return info

    def secret_for(self, ak: str) -> str | None:
        info = self._info(ak)
        return info["sk"] if info else None

    def allowed(self, ak: str, volume: str, write: bool) -> bool:
        info = self._info(ak)
        if info is None:
            return False
        perm = info["volumes"].get(volume, "")
        return "w" in perm if write else bool(perm)


class S3V4Authenticator:
    """Pluggable objectnode authenticator backed by a UserStore.

    `authenticate` establishes WHO the caller is — V4 header auth, V4
    presigned query auth, or V2 header auth; a request with no
    credentials at all is the anonymous principal (None), left for the
    authorization layer (ACL/policy) to judge. `__call__` keeps the
    legacy boolean authn+grant contract."""

    def __init__(self, user_store, bucket_volume: dict[str, str] | None = None,
                 sts=None):
        self.users = user_store
        self.bucket_volume = bucket_volume or {}
        self.sts = sts  # s3ext.Sts issuer for temporary credentials

    def authenticate(self, handler) -> tuple[bool, str | None, str]:
        """Returns (ok, principal, reason). ok=False means credentials
        were presented but are INVALID (reject 403); principal None with
        ok=True means anonymous."""
        from . import s3ext

        n = int(handler.headers.get("Content-Length") or 0)
        # read + stash the body so the verb handler can reuse it
        body = handler.rfile.read(n) if n else b""
        handler._stashed_body = body
        parsed = urllib.parse.urlsplit(handler.path)
        headers = {k.lower(): v for k, v in handler.headers.items()}
        auth_hdr = headers.get("authorization", "")

        # parse the Authorization header ONCE; every V4 leg below (token
        # check, header verification, chunk-seed extraction) reuses it
        v4 = (parse_v4_auth(headers)
              if auth_hdr.startswith("AWS4-HMAC-SHA256 ") else None)

        # temporary credentials: the session token resolves to a derived
        # temp secret; the principal is the PARENT key (grants follow it)
        secret_for = self.users.secret_for
        principal_map = None
        token = headers.get("x-amz-security-token")
        if token is not None and v4 is not None:
            if self.sts is None:
                return False, None, "session tokens not enabled"
            claims = self.sts.resolve(token)
            if claims is None:
                return False, None, "invalid/expired session token"
            if "x-amz-security-token" not in v4["signed_headers"]:
                # an unsigned token header proves nothing: reject
                return False, None, "x-amz-security-token must be signed"
            tak, tsk = claims["tak"], claims["sk"]
            secret_for = lambda ak: tsk if ak == tak else None  # noqa: E731
            principal_map = {tak: claims["pak"]}
            handler._via_token = True  # STS endpoint refuses chaining

        if auth_hdr.startswith("AWS4-HMAC-SHA256 "):
            streaming = (headers.get("x-amz-content-sha256")
                         == s3ext.STREAMING_PAYLOAD)
            ok, who = verify_v4(
                handler.command, parsed.path, parsed.query, headers, body,
                secret_for,
                payload_override=s3ext.STREAMING_PAYLOAD if streaming else None)
            if ok and streaming:
                # header signature only covers the headers; the body is
                # authenticated chunk-by-chunk against the seed signature
                want = headers.get("x-amz-decoded-content-length")
                try:
                    want_n = None if want is None else int(want)
                except ValueError:
                    return False, None, "malformed x-amz-decoded-content-length"
                sk = secret_for(v4["ak"])
                key = signing_key(sk, v4["date"], v4["region"], v4["service"])
                scope = (f"{v4['date']}/{v4['region']}/{v4['service']}"
                         f"/aws4_request")
                cok, out = s3ext.verify_aws_chunked(
                    body, v4["signature"], key,
                    headers.get("x-amz-date", ""), scope)
                if not cok:
                    return False, None, str(out)
                if want_n is not None and want_n != len(out):
                    return False, None, "decoded length mismatch"
                handler._stashed_body = out
            if ok and principal_map is not None:
                who = principal_map.get(who, who)
            return (ok, who if ok else None, "" if ok else who)
        if headers.get("x-amz-content-sha256") == s3ext.STREAMING_PAYLOAD:
            # aws-chunked bodies are only defined for SigV4 header auth
            # (the chunk chain needs a seed signature); admitting a V2 /
            # presigned / anonymous streaming PUT would store the raw
            # framing — chunk headers and signatures — as object bytes
            return False, None, "streaming payload requires SigV4 header auth"
        if auth_hdr.startswith("AWS "):
            ok, who = verify_v2(handler.command, parsed.path, parsed.query,
                                headers, self.users.secret_for)
            return (ok, who if ok else None, "" if ok else who)
        if "X-Amz-Signature" in parsed.query:
            ok, who = verify_presigned_v4(
                handler.command, parsed.path, parsed.query,
                headers.get("host", ""), self.users.secret_for)
            return (ok, who if ok else None, "" if ok else who)
        if auth_hdr:
            # an unrecognized/malformed Authorization scheme must be
            # rejected, never silently downgraded to anonymous
            return False, None, "unsupported authorization scheme"
        return True, None, ""  # anonymous

    def grant_ok(self, principal: str | None, bucket: str,
                 write: bool) -> bool:
        if principal is None:
            return False
        volume = self.bucket_volume.get(bucket, bucket)
        return self.users.allowed(principal, volume, write)

    def __call__(self, handler) -> bool:
        ok, who, _ = self.authenticate(handler)
        if not ok or who is None:
            return False
        parsed = urllib.parse.urlsplit(handler.path)
        bucket = parsed.path.lstrip("/").split("/", 1)[0]
        write = handler.command in ("PUT", "POST", "DELETE")
        return self.grant_ok(who, bucket, write)
