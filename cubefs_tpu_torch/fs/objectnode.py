"""ObjectNode: S3-compatible HTTP gateway over the FS client.

Role parity: objectnode/ — S3 REST semantics (PutObject/GetObject/
DeleteObject/HeadObject/ListObjectsV2/CreateBucket, fs adapter
fs_volume.go:617 PutObject / :1684 ReadFile). Buckets map to volumes;
object keys map to nested paths (directories are created on demand and
pruned on delete, the same key<->path adaptation the reference's volume
adapter performs). Signature validation (V4) is pluggable via an
authenticator callable; the default accepts all (auth service lands with
the authnode component).

The port's copy of ``cubefs_tpu/fs/objectnode.py``.
"""

from __future__ import annotations

import hashlib
import threading
import time
import urllib.parse
import xml.sax.saxutils as xs
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import json

from . import metanode as mn
from . import s3policy
from . import s3version
from ..utils import qos
from .client import FileSystem, FsError


def _http_date(unix: float) -> str:
    import email.utils

    return email.utils.formatdate(unix, usegmt=True)


def _parse_http_date(s: str) -> float | None:
    import email.utils

    try:
        return email.utils.parsedate_to_datetime(s).timestamp()
    except (TypeError, ValueError):
        return None


class ObjectNode:
    def __init__(self, volumes: dict[str, FileSystem], host="127.0.0.1", port=0,
                 authenticator=None, audit_sinks=None, qos_gate=None):
        from . import s3ext

        self.volumes = dict(volumes)
        self.auth = authenticator
        # per-tenant admission (tenant = authenticated principal);
        # None = the process-wide gate, CUBEFS_QOS=0 no-ops it
        self.qos = qos_gate or qos.DEFAULT
        # access-audit fan-out (audit_webhook.go / audit_kafka.go role):
        # every reply emits one event to each sink, fire-and-forget
        self.audit_sinks = list(audit_sinks or [])
        # STS issuer: ONE instance shared with the authenticator, so
        # tokens issued here validate on later requests (sts.go role) —
        # an authenticator constructed with its own (e.g. multi-gateway
        # shared-key) Sts wins
        self.sts = getattr(authenticator, "sts", None) or s3ext.Sts()
        if authenticator is not None and getattr(
                authenticator, "sts", None) is None:
            authenticator.sts = self.sts
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            # ---- helpers ----
            def _split(self):
                parsed = urllib.parse.urlparse(self.path)
                parts = parsed.path.lstrip("/").split("/", 1)
                bucket = parts[0]
                key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
                query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
                return bucket, key, query

            def _fs(self, bucket) -> FileSystem | None:
                return outer.volumes.get(bucket)

            def _key_reserved(self, key: str) -> bool:
                # the multipart staging and version archive areas are
                # internal: direct key ops on them would expose/corrupt
                # other clients' uploads / version history
                return key.split("/", 1)[0] in (".multipart",
                                                s3version.VDIR)

            def _bypass_governance(self) -> bool:
                return (self.headers.get(
                    "x-amz-bypass-governance-retention", "")
                    .lower() == "true")

            def _audit(self, code: int, bytes_out: int) -> None:
                if not outer.audit_sinks:
                    return
                # emitted BEFORE the response write: a client hangup must
                # not suppress the audit trail of a committed mutation
                bucket, key = getattr(self, "_route", None) or \
                    self._split()[:2]
                event = {
                    "ts": round(time.time(), 3),
                    "method": self.command, "bucket": bucket,
                    "key": key, "code": code,
                    "principal": getattr(self, "_principal", None),
                    "tenant": getattr(self, "_tenant", None),
                    "bytes_out": bytes_out,
                    "bytes_in": len(getattr(self, "_stashed_body",
                                            b"") or b""),
                    "remote": self.client_address[0],
                }
                for sink in outer.audit_sinks:
                    sink.emit(event)

            def _reply(self, code, body=b"", ctype="application/xml",
                       headers=None):
                # HEAD never writes the body: audit the bytes actually
                # sent, or egress accounting over-counts every HEAD error
                self._audit(code,
                            0 if self.command == "HEAD" else len(body))
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                # RFC 9110: a HEAD response carries headers only — writing
                # the body would desync keep-alive clients
                if body and self.command != "HEAD":
                    self.wfile.write(body)

            def _error(self, code, s3code, msg):
                body = (
                    f"<?xml version='1.0'?><Error><Code>{s3code}</Code>"
                    f"<Message>{xs.escape(msg)}</Message></Error>"
                ).encode()
                self._reply(code, body)

            def _admit_qos(self) -> bool:
                """QoS admission for the authenticated request (tenant =
                principal). On shed, replies 429 SlowDown with a
                Retry-After hint and returns False. The admission slot
                is released in handle_one_request's finally."""
                tenant = self._principal or "anonymous"
                self._tenant = tenant
                try:
                    self._admission = outer.qos.admit(
                        f"s3.{self.command.lower()}", tenant=tenant,
                        cost=max(1, len(self._stashed_body)), svc="s3")
                except qos.QosRejected as e:
                    body = (
                        f"<?xml version='1.0'?><Error><Code>SlowDown"
                        f"</Code><Message>{xs.escape(e.message)}"
                        f"</Message></Error>").encode()
                    self._reply(429, body, headers={
                        "Retry-After": f"{e.retry_after:.3f}"})
                    return False
                return True

            def handle_one_request(self):
                try:
                    super().handle_one_request()
                finally:
                    adm = getattr(self, "_admission", None)
                    if adm is not None:
                        self._admission = None
                        adm.release()

            def _begin(self):
                """Drain+stash the body, authenticate, and pass QoS
                admission. Returns the (bucket, key, query) triple, or
                None if a 403/429 was already sent. Sets
                self._principal (None = anonymous) and self._tenant."""
                # the handler object lives for a whole keep-alive
                # connection: bucket config must be re-read per REQUEST
                # or an ACL/policy revocation never reaches it — and the
                # audit fields (principal, body, route) must never leak
                # from the previous request into this one's events
                self._conf_cache = None
                self._via_token = False
                self._principal = None
                self._tenant = None
                self._admission = None
                self._stashed_body = b""
                self._route = self._split()[:2]
                if outer.auth is None:
                    from . import s3ext

                    n = int(self.headers.get("Content-Length") or 0)
                    self._stashed_body = self.rfile.read(n) if n else b""
                    if (self.headers.get("x-amz-content-sha256")
                            == s3ext.STREAMING_PAYLOAD):
                        # no keys to verify the chain against: strip the
                        # aws-chunked framing so the payload lands intact
                        self._stashed_body = s3ext.strip_aws_chunked(
                            self._stashed_body)
                    self._principal = None
                    if not self._admit_qos():
                        return None
                    return self._split()
                ok, who, reason = outer.auth.authenticate(self)
                if not ok:
                    # AWS-conformant denial codes: clients switch on
                    # these (see ceph/s3-tests); a flat AccessDenied
                    # hides key-vs-signature failures from SDK retries
                    reason = reason or "bad signature"
                    if "signature mismatch" in reason:
                        code = "SignatureDoesNotMatch"
                    elif "unknown access key" in reason:
                        code = "InvalidAccessKeyId"
                    elif "session token" in reason:
                        code = "ExpiredToken"
                    else:  # incl. presigned expiry (AWS: AccessDenied)
                        code = "AccessDenied"
                    self._error(403, code, reason)
                    return None
                self._principal = who
                if not self._admit_qos():
                    return None
                return self._split()

            def _bucket_conf(self, bucket) -> dict:
                """ACL/policy/CORS config for the bucket — ONE root-inode
                fetch per request, cached on the handler."""
                cache = getattr(self, "_conf_cache", None)
                if cache is not None and cache[0] == bucket:
                    return cache[1]
                conf: dict = {}
                fs = self._fs(bucket)
                if fs is not None:
                    try:
                        xattr = fs.meta.inode_get(fs.resolve("/"))["xattr"]
                        conf = {k: xattr.get(k) for k in
                                (s3policy.XA_ACL, s3policy.XA_POLICY,
                                 s3policy.XA_CORS, s3policy.XA_LIFECYCLE,
                                 s3version.XA_VERSIONING)}
                    except FsError:
                        conf = {}
                self._conf_cache = (bucket, conf)
                return conf

            def _allowed(self, action, bucket, key="") -> bool:
                """Pure authorization decision (policy -> ACL -> user
                grant); no reply side effects."""
                if outer.auth is None:
                    return True
                conf = self._bucket_conf(bucket)
                acl = conf.get(s3policy.XA_ACL)
                policy = None
                raw = conf.get(s3policy.XA_POLICY)
                if raw:
                    try:
                        policy = json.loads(raw)
                    except json.JSONDecodeError:
                        policy = None
                write = action not in s3policy.READ_ACTIONS
                grant = outer.auth.grant_ok(self._principal, bucket, write)
                if action.endswith(("BucketPolicy", "BucketAcl",
                                    "BucketCors", "BucketLifecycle",
                                    "BucketVersioning",
                                    "ObjectLockConfiguration")):
                    # bucket configuration is owner-only: policy/ACL
                    # cannot grant it away
                    return grant
                return s3policy.authorize(
                    action, bucket, key, self._principal, acl, policy,
                    grant)

            def _check(self, action, bucket, key="") -> bool:
                """_allowed + a 403 reply on denial."""
                allowed = self._allowed(action, bucket, key)
                if not allowed:
                    self._error(403, "AccessDenied", f"{action} denied")
                return allowed

            def _cors(self, bucket) -> dict:
                """CORS response headers for the request's Origin."""
                origin = self.headers.get("Origin")
                if not origin or self._fs(bucket) is None:
                    return {}
                raw = self._bucket_conf(bucket).get(s3policy.XA_CORS)
                rules = json.loads(raw) if raw else None
                rule = s3policy.cors_match(rules, origin, self.command)
                return s3policy.cors_headers(rule, origin) if rule else {}

            def do_OPTIONS(self):
                # CORS preflight: allowlisted from QoS admission (no
                # data path; shedding it would break browser clients)
                self._conf_cache = None
                self._principal = None
                self._tenant = None
                self._stashed_body = b""
                bucket, key, _ = self._split()
                self._route = (bucket, key)
                origin = self.headers.get("Origin", "")
                method = self.headers.get("Access-Control-Request-Method", "")
                fs = self._fs(bucket)
                if fs is None:
                    return self._error(404, "NoSuchBucket", bucket)
                raw = self._bucket_conf(bucket).get(s3policy.XA_CORS)
                rules = json.loads(raw) if raw else None
                rule = s3policy.cors_match(rules, origin, method)
                if rule is None:
                    return self._error(403, "AccessDenied",
                                       "CORS rules do not allow this origin")
                self._reply(200, headers=s3policy.cors_headers(rule, origin))

            # ---- verbs ----
            def do_PUT(self):
                # the body is drained BEFORE any reply (leftover bytes
                # desync HTTP/1.1 keep-alive clients): _begin stashes it
                # as part of signature hashing
                begun = self._begin()
                if begun is None:
                    return
                bucket, key, query = begun
                data = getattr(self, "_stashed_body", b"")
                fs = self._fs(bucket)
                if fs is None:
                    return self._error(404, "NoSuchBucket", bucket)
                # bucket subresources: ?acl / ?policy / ?cors
                if not key and "acl" in query:
                    if not self._check("s3:PutBucketAcl", bucket):
                        return
                    canned = self.headers.get("x-amz-acl", "private")
                    if canned not in s3policy.CANNED_ACLS:
                        return self._error(400, "InvalidArgument",
                                           f"unsupported ACL {canned!r}")
                    outer._bucket_cfg_set(fs, s3policy.XA_ACL, canned)
                    return self._reply(200)
                if not key and "policy" in query:
                    if not self._check("s3:PutBucketPolicy", bucket):
                        return
                    try:
                        s3policy.parse_policy(data)
                    except s3policy.S3ConfigError as e:
                        return self._error(400, "MalformedPolicy", str(e))
                    outer._bucket_cfg_set(fs, s3policy.XA_POLICY,
                                          data.decode())
                    return self._reply(200)
                if not key and "cors" in query:
                    if not self._check("s3:PutBucketCors", bucket):
                        return
                    try:
                        rules = s3policy.parse_cors(data)
                    except s3policy.S3ConfigError as e:
                        return self._error(400, "MalformedXML", str(e))
                    outer._bucket_cfg_set(fs, s3policy.XA_CORS,
                                          json.dumps(rules))
                    return self._reply(200)
                if not key and "lifecycle" in query:
                    if not self._check("s3:PutBucketLifecycle", bucket):
                        return
                    try:
                        rules = s3policy.parse_lifecycle(data)
                    except s3policy.S3ConfigError as e:
                        return self._error(400, "MalformedXML", str(e))
                    outer._bucket_cfg_set(fs, s3policy.XA_LIFECYCLE,
                                          json.dumps(rules))
                    return self._reply(200)
                if not key and "versioning" in query:  # PutBucketVersioning
                    if not self._check("s3:PutBucketVersioning", bucket):
                        return
                    try:
                        status = outer._parse_versioning_xml(data)
                        s3version.VersionStore(fs).set_status(status)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    return self._reply(200)
                if not key and "object-lock" in query:  # PutObjectLockConfiguration
                    if not self._check("s3:PutBucketObjectLockConfiguration",
                                       bucket):
                        return
                    try:
                        conf = outer._parse_objlock_xml(data)
                        s3version.VersionStore(fs).set_lock_config(conf)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    return self._reply(200)
                if key and "retention" in query:  # PutObjectRetention
                    if self._key_reserved(key):
                        return self._error(403, "AccessDenied",
                                           "reserved namespace")
                    if not self._check("s3:PutObjectRetention", bucket, key):
                        return
                    vid = query.get("versionId", [None])[0]
                    try:
                        mode, until = outer._parse_retention_xml(data)
                        s3version.VersionStore(fs).set_retention(
                            key, vid, mode, until,
                            self._bypass_governance())
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    return self._reply(200)
                if key and "legal-hold" in query:  # PutObjectLegalHold
                    if self._key_reserved(key):
                        return self._error(403, "AccessDenied",
                                           "reserved namespace")
                    if not self._check("s3:PutObjectLegalHold", bucket, key):
                        return
                    vid = query.get("versionId", [None])[0]
                    try:
                        on = outer._parse_legal_hold_xml(data)
                        s3version.VersionStore(fs).set_legal_hold(
                            key, vid, on)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    return self._reply(200)
                if not key:  # CreateBucket
                    if not self._check("s3:CreateBucket", bucket):
                        return
                    if bucket not in outer.volumes:
                        return self._error(404, "NoSuchBucket",
                                           f"no volume backs {bucket}")
                    return self._reply(200)
                if self._key_reserved(key):
                    return self._error(403, "AccessDenied",
                                       ".multipart is a reserved namespace")
                if "tagging" in query:  # PutObjectTagging
                    if not self._check("s3:PutObjectTagging", bucket, key):
                        return
                    try:
                        tags = s3policy.parse_tagging(data)
                    except s3policy.S3ConfigError as e:
                        return self._error(400, "MalformedXML", str(e))
                    try:
                        fs.setxattr("/" + key, s3policy.XA_TAGS,
                                    json.dumps(tags))
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    return self._reply(200)
                if "acl" in query:  # PutObjectAcl (canned, like buckets)
                    if not self._check("s3:PutObjectAcl", bucket, key):
                        return
                    canned = self.headers.get("x-amz-acl", "private")
                    if canned not in s3policy.CANNED_ACLS:
                        return self._error(400, "InvalidArgument", canned)
                    try:
                        fs.setxattr("/" + key, s3policy.XA_ACL, canned)
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    return self._reply(200)
                if not self._check("s3:PutObject", bucket, key):
                    return
                if "uploadId" in query and "partNumber" in query:  # UploadPart
                    if self.headers.get("x-amz-copy-source"):
                        # refusing beats silently storing the empty body
                        return self._error(501, "NotImplemented",
                                           "UploadPartCopy is not supported")
                    upload_id = query["uploadId"][0]
                    try:
                        part = int(query["partNumber"][0])
                    except ValueError:
                        return self._error(400, "InvalidPart",
                                           "partNumber must be an integer")
                    if not 1 <= part <= 10000:  # S3's own part limit
                        return self._error(400, "InvalidPart",
                                           f"partNumber {part} out of range")
                    try:
                        etag = outer._put_part(fs, upload_id, part, data)
                    except FsError as e:
                        return self._error(404, "NoSuchUpload", str(e))
                    return self._reply(200, headers={"ETag": f'"{etag}"'})
                src = self.headers.get("x-amz-copy-source", "")
                is_copy = bool(src)
                if is_copy:  # CopyObject: data comes from /bucket/key
                    sb, _, sk = src.lstrip("/").partition("/")
                    sk = urllib.parse.unquote(sk)
                    sfs = self._fs(sb)
                    if sfs is None or not sk:
                        return self._error(404, "NoSuchBucket", sb)
                    if self._key_reserved(sk):
                        return self._error(403, "AccessDenied",
                                           ".multipart is a reserved namespace")
                    # the caller must be allowed to READ the source too,
                    # or copy becomes cross-bucket exfiltration
                    if not self._check("s3:GetObject", sb, sk):
                        return
                    try:
                        data = sfs.read_file("/" + sk)
                    except FsError as e:
                        if e.errno == mn.EISDIR:  # folder-marker copy
                            data = b""
                        else:
                            return self._error(404, "NoSuchKey", sk)
                # lock headers validate BEFORE the write: a rejected
                # PUT must not have replaced the object already
                lock_mode = self.headers.get("x-amz-object-lock-mode")
                lock_until = None
                if lock_mode:
                    if lock_mode not in ("GOVERNANCE", "COMPLIANCE"):
                        return self._error(400, "InvalidArgument",
                                           f"bad lock mode {lock_mode!r}")
                    until_s = self.headers.get(
                        "x-amz-object-lock-retain-until-date", "")
                    try:
                        lock_until = s3version.parse_iso8601(until_s)
                    except Exception:
                        return self._error(
                            400, "InvalidArgument",
                            f"bad retain-until date {until_s!r}")
                etag = hashlib.md5(data).hexdigest()
                try:
                    vid = outer._put_object_versioned(
                        fs, key, data, etag, self._bypass_governance())
                except s3version.S3VersionError as e:
                    return self._error(e.http, e.code, str(e))
                except FsError as e:
                    if e.errno in (mn.ENOSPC, mn.EDQUOT):
                        return self._error(507, "QuotaExceeded", str(e))
                    return self._error(500, "InternalError", str(e))
                # Content-Type + x-amz-meta-* persist with the object;
                # CopyObject defaults to COPY of the source's metadata
                # unless the directive says REPLACE (AWS semantics)
                if is_copy and self.headers.get(
                        "x-amz-metadata-directive", "COPY") != "REPLACE":
                    rec = outer._obj_meta(sfs, sk)
                    outer._obj_meta_save(fs, key, rec.get("ct"),
                                         rec.get("meta") or {}, etag=etag)
                else:
                    ct_in, meta_in = outer._req_obj_meta(self.headers)
                    outer._obj_meta_save(fs, key, ct_in, meta_in,
                                         etag=etag)
                # PUT-time object-lock headers apply to the version just
                # written (AWS: x-amz-object-lock-{mode,retain-until-date,
                # legal-hold} on PutObject); validated above
                if lock_mode:
                    try:
                        s3version.VersionStore(fs).set_retention(
                            key, vid, lock_mode, lock_until,
                            self._bypass_governance())
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                if self.headers.get(
                        "x-amz-object-lock-legal-hold", "").upper() == "ON":
                    try:
                        s3version.VersionStore(fs).set_legal_hold(
                            key, vid, True)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                vid_hdr = {"x-amz-version-id": vid} if vid else {}
                if is_copy:
                    body = (f"<?xml version='1.0'?><CopyObjectResult>"
                            f"<ETag>\"{etag}\"</ETag></CopyObjectResult>").encode()
                    return self._reply(200, body, headers=vid_hdr)
                self._reply(200, headers={"ETag": f'"{etag}"',
                                          **vid_hdr,
                                          **self._cors(bucket)})

            def do_POST(self):
                # multipart lifecycle: InitiateMultipartUpload (?uploads)
                # and CompleteMultipartUpload (?uploadId=...), plus the
                # STS action surface (POST /) and browser POST policy
                # uploads (multipart/form-data to the bucket)
                begun = self._begin()
                if begun is None:
                    return
                bucket, key, query = begun
                if not bucket:
                    return self._sts_action()
                fs = self._fs(bucket)
                if fs is None:
                    return self._error(404, "NoSuchBucket", bucket)
                ctype = self.headers.get("Content-Type", "")
                if not key and ctype.startswith("multipart/form-data"):
                    return self._post_policy_upload(bucket, fs, ctype)
                if key and self._key_reserved(key):
                    return self._error(403, "AccessDenied",
                                       ".multipart is a reserved namespace")
                if not key and "delete" in query:  # DeleteObjects (batch)
                    return self._delete_objects(bucket, fs)
                if not self._check("s3:PutObject", bucket, key):
                    return
                if "uploads" in query:
                    if not key:
                        return self._error(400, "InvalidRequest",
                                           "multipart upload needs a key")
                    upload_id = outer._initiate_multipart(fs, key,
                                                          self.headers)
                    body = (
                        f"<?xml version='1.0'?><InitiateMultipartUploadResult>"
                        f"<Bucket>{bucket}</Bucket><Key>{xs.escape(key)}</Key>"
                        f"<UploadId>{upload_id}</UploadId>"
                        f"</InitiateMultipartUploadResult>"
                    ).encode()
                    return self._reply(200, body)
                if "uploadId" in query:
                    try:
                        etag = outer._complete_multipart(
                            fs, key, query["uploadId"][0]
                        )
                    except s3version.S3VersionError as e:
                        # e.g. Locked: completing onto a retained null
                        # version must 403, not drop the connection
                        return self._error(e.http, e.code, str(e))
                    except FsError as e:
                        return self._error(404, "NoSuchUpload", str(e))
                    body = (
                        f"<?xml version='1.0'?><CompleteMultipartUploadResult>"
                        f"<Key>{xs.escape(key)}</Key><ETag>\"{etag}\"</ETag>"
                        f"</CompleteMultipartUploadResult>"
                    ).encode()
                    return self._reply(200, body)
                self._error(400, "InvalidRequest", "unsupported POST")

            def do_GET(self):
                begun = self._begin()
                if begun is None:
                    return
                bucket, key, query = begun
                fs = self._fs(bucket)
                if fs is None:
                    return self._error(404, "NoSuchBucket", bucket)
                if key and self._key_reserved(key):
                    return self._error(403, "AccessDenied",
                                       ".multipart is a reserved namespace")
                if not key and "acl" in query:  # GetBucketAcl
                    if not self._check("s3:GetBucketAcl", bucket):
                        return
                    acl = (self._bucket_conf(bucket).get(s3policy.XA_ACL)
                           or "private")
                    owner = self._principal or "owner"
                    return self._reply(200, s3policy.acl_to_xml(acl, owner))
                if not key and "uploads" in query:  # ListMultipartUploads
                    if not self._check("s3:ListBucketMultipartUploads",
                                       bucket):
                        return
                    prefix = query.get("prefix", [""])[0]
                    ups = []
                    try:
                        staging_root = fs.readdir("/.multipart")
                    except FsError:
                        staging_root = {}
                    for upload_id in sorted(staging_root):
                        try:
                            k = fs.getxattr(f"/.multipart/{upload_id}",
                                            "s3.key") or ""
                        except FsError:
                            continue
                        if k.startswith(prefix):
                            ups.append((k, upload_id))
                    ups.sort()
                    body = (
                        "<?xml version='1.0'?><ListMultipartUploadsResult>"
                        f"<Bucket>{bucket}</Bucket>"
                        f"<Prefix>{xs.escape(prefix)}</Prefix>"
                        "<IsTruncated>false</IsTruncated>"
                        + "".join(
                            f"<Upload><Key>{xs.escape(k)}</Key>"
                            f"<UploadId>{u}</UploadId></Upload>"
                            for k, u in ups)
                        + "</ListMultipartUploadsResult>").encode()
                    return self._reply(200, body)
                if key and "acl" in query:  # GetObjectAcl
                    if not self._check("s3:GetObjectAcl", bucket, key):
                        return
                    try:
                        canned = fs.getxattr("/" + key, s3policy.XA_ACL)
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    owner = self._principal or "owner"
                    return self._reply(
                        200, s3policy.acl_to_xml(canned or "private", owner))
                if key and "uploadId" in query:  # ListParts
                    if not self._check("s3:ListMultipartUploadParts",
                                       bucket, key):
                        return
                    upload_id = query["uploadId"][0]
                    staging = f"/.multipart/{upload_id}"
                    try:
                        if fs.getxattr(staging, "s3.key") != key:
                            return self._error(404, "NoSuchUpload",
                                               upload_id)
                        names = sorted(fs.readdir(staging))
                    except FsError:
                        return self._error(404, "NoSuchUpload", upload_id)
                    parts_xml = []
                    for n in names:
                        try:
                            st = fs.stat(f"{staging}/{n}")
                            etag = fs.getxattr(f"{staging}/{n}",
                                               "s3.etag") or ""
                        except FsError:
                            continue
                        parts_xml.append(
                            f"<Part><PartNumber>{int(n)}</PartNumber>"
                            f"<ETag>\"{etag}\"</ETag>"
                            f"<Size>{st['size']}</Size></Part>")
                    return self._reply(
                        200,
                        (f"<?xml version='1.0'?><ListPartsResult>"
                         f"<Bucket>{bucket}</Bucket>"
                         f"<Key>{xs.escape(key)}</Key>"
                         f"<UploadId>{upload_id}</UploadId>"
                         f"{''.join(parts_xml)}</ListPartsResult>").encode())
                if not key and "policy" in query:  # GetBucketPolicy
                    if not self._check("s3:GetBucketPolicy", bucket):
                        return
                    raw = self._bucket_conf(bucket).get(s3policy.XA_POLICY)
                    if not raw:
                        return self._error(404, "NoSuchBucketPolicy", bucket)
                    return self._reply(200, raw.encode(),
                                       ctype="application/json")
                if not key and "cors" in query:  # GetBucketCors
                    if not self._check("s3:GetBucketCors", bucket):
                        return
                    raw = self._bucket_conf(bucket).get(s3policy.XA_CORS)
                    if not raw:
                        return self._error(404,
                                           "NoSuchCORSConfiguration", bucket)
                    rules = json.loads(raw)
                    body = "".join(
                        "<CORSRule>"
                        + "".join(f"<AllowedOrigin>{xs.escape(o)}"
                                  f"</AllowedOrigin>" for o in r["origins"])
                        + "".join(f"<AllowedMethod>{xs.escape(m)}"
                                  f"</AllowedMethod>"
                                  for m in r["methods"])
                        + "".join(f"<AllowedHeader>{xs.escape(h)}"
                                  f"</AllowedHeader>" for h in r["headers"])
                        + (f"<MaxAgeSeconds>{r['max_age']}</MaxAgeSeconds>"
                           if r["max_age"] else "")
                        + "</CORSRule>"
                        for r in rules
                    )
                    return self._reply(
                        200,
                        (f"<?xml version='1.0'?><CORSConfiguration>{body}"
                         f"</CORSConfiguration>").encode())
                if not key and "lifecycle" in query:  # GetBucketLifecycle
                    if not self._check("s3:GetBucketLifecycle", bucket):
                        return
                    raw = self._bucket_conf(bucket).get(
                        s3policy.XA_LIFECYCLE)
                    if not raw:
                        return self._error(
                            404, "NoSuchLifecycleConfiguration", bucket)
                    return self._reply(
                        200, s3policy.lifecycle_to_xml(json.loads(raw)))
                if not key and "versioning" in query:  # GetBucketVersioning
                    if not self._check("s3:GetBucketVersioning", bucket):
                        return
                    st = s3version.VersionStore(fs).status()
                    inner = f"<Status>{st}</Status>" if st else ""
                    return self._reply(
                        200,
                        (f"<?xml version='1.0'?><VersioningConfiguration>"
                         f"{inner}</VersioningConfiguration>").encode())
                if not key and "object-lock" in query:  # GetObjectLockConfiguration
                    if not self._check("s3:GetBucketObjectLockConfiguration",
                                       bucket):
                        return
                    conf = s3version.VersionStore(fs).lock_config()
                    if conf is None:
                        return self._error(
                            404, "ObjectLockConfigurationNotFoundError",
                            bucket)
                    return self._reply(200, outer._objlock_to_xml(conf))
                if not key and "versions" in query:  # ListObjectVersions
                    if not self._check("s3:ListBucketVersions", bucket):
                        return
                    return outer._list_versions_reply(self, bucket, fs,
                                                      query)
                if key and "retention" in query:  # GetObjectRetention
                    if not self._check("s3:GetObjectRetention", bucket, key):
                        return
                    vid = query.get("versionId", [None])[0]
                    try:
                        ret = s3version.VersionStore(fs).get_retention(
                            key, vid)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    if ret is None:
                        return self._error(
                            404, "NoSuchObjectLockConfiguration", key)
                    return self._reply(
                        200,
                        (f"<?xml version='1.0'?><Retention>"
                         f"<Mode>{ret['mode']}</Mode>"
                         f"<RetainUntilDate>"
                         f"{s3version.iso8601(ret['until'])}"
                         f"</RetainUntilDate></Retention>").encode())
                if key and "legal-hold" in query:  # GetObjectLegalHold
                    if not self._check("s3:GetObjectLegalHold", bucket, key):
                        return
                    vid = query.get("versionId", [None])[0]
                    try:
                        on = s3version.VersionStore(fs).get_legal_hold(
                            key, vid)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    return self._reply(
                        200,
                        (f"<?xml version='1.0'?><LegalHold><Status>"
                         f"{'ON' if on else 'OFF'}</Status>"
                         f"</LegalHold>").encode())
                if key and "tagging" in query:  # GetObjectTagging
                    if not self._check("s3:GetObjectTagging", bucket, key):
                        return
                    try:
                        raw = fs.getxattr("/" + key, s3policy.XA_TAGS)
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    tags = json.loads(raw) if raw else {}
                    return self._reply(200, s3policy.tagging_to_xml(tags))
                if not key:  # ListObjects V1/V2 (+ delimiter, pagination)
                    if not self._check("s3:ListBucket", bucket):
                        return
                    prefix = query.get("prefix", [""])[0]
                    delimiter = query.get("delimiter", [""])[0]
                    try:
                        max_keys = int(query.get("max-keys", ["1000"])[0])
                    except ValueError:
                        return self._error(400, "InvalidArgument",
                                           "max-keys must be an integer")
                    if max_keys < 1:
                        return self._error(400, "InvalidArgument",
                                           "max-keys must be positive")
                    v2 = query.get("list-type", [""])[0] == "2"
                    # V1's `marker` is "start after this key" — the same
                    # contract as our V2 continuation token
                    token = (query.get("continuation-token", [""])[0]
                             if v2 else query.get("marker", [""])[0])
                    keys, prefixes, next_token, truncated = outer._list_v2(
                        fs, prefix, delimiter, max_keys, token
                    )
                    def _entry(k, sz, mt, et):
                        # sync tools key their change detection on
                        # ETag + LastModified in listings
                        tag = f"<ETag>\"{et}\"</ETag>" if et else ""
                        return (f"<Contents><Key>{xs.escape(k)}</Key>"
                                f"<Size>{sz}</Size>"
                                f"<LastModified>"
                                f"{s3version.iso8601(mt)}</LastModified>"
                                f"{tag}</Contents>")

                    items = "".join(_entry(*t) for t in keys)
                    cps = "".join(
                        f"<CommonPrefixes><Prefix>{xs.escape(p)}</Prefix>"
                        f"</CommonPrefixes>"
                        for p in prefixes
                    )
                    if v2:
                        extra = (f"<KeyCount>{len(keys) + len(prefixes)}"
                                 f"</KeyCount>")
                        if next_token:
                            extra += (f"<NextContinuationToken>"
                                      f"{xs.escape(next_token)}"
                                      f"</NextContinuationToken>")
                    else:  # V1: Marker/NextMarker shapes
                        extra = (f"<Marker>{xs.escape(token)}</Marker>")
                        if truncated:
                            extra += (f"<NextMarker>"
                                      f"{xs.escape(next_token)}"
                                      f"</NextMarker>")
                    body = (
                        f"<?xml version='1.0'?><ListBucketResult>"
                        f"<Name>{bucket}</Name><Prefix>{xs.escape(prefix)}</Prefix>"
                        f"<Delimiter>{xs.escape(delimiter)}</Delimiter>"
                        f"<MaxKeys>{max_keys}</MaxKeys>"
                        f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
                        f"{extra}{items}{cps}"
                        f"</ListBucketResult>"
                    ).encode()
                    return self._reply(200, body)
                if not self._check("s3:GetObject", bucket, key):
                    return
                vid_q = query.get("versionId", [""])[0]
                if vid_q:  # GetObject of a specific version
                    try:
                        data, vmeta = s3version.VersionStore(
                            fs).read_version(key, vid_q)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    # conditionals evaluate against the ADDRESSED
                    # version's etag/mtime — revalidating a cached copy
                    # of version V must 304 on V's etag, and an
                    # If-Match pinned to V must not 412 just because
                    # the live object moved on
                    vstate = outer._version_meta_state(fs, vmeta)
                    vct, vhdrs = outer._version_reply_headers(
                        fs, vmeta, state=vstate)
                    cond = outer._conditional(self.headers, *vstate)
                    if cond == 304:
                        return self._reply(304, headers=vhdrs)
                    if cond == 412:
                        return self._error(412, "PreconditionFailed", key)
                    return self._reply(
                        200, data, ctype=vct,
                        headers={**vhdrs, **self._cors(bucket)})
                mrec, mst = outer._obj_meta_state(fs, key)
                cond = outer._conditional(self.headers, mrec, mst)
                if cond == 304:
                    _, mh = outer._meta_reply_headers(mrec, mst)
                    return self._reply(304, headers=mh)
                if cond == 412:
                    return self._error(412, "PreconditionFailed", key)
                rng_hdr = self.headers.get("Range", "")
                span = None
                if rng_hdr.startswith("bytes=") and "," not in rng_hdr:
                    try:
                        lo_s, _, hi_s = rng_hdr[6:].partition("-")
                        span = ((int(lo_s) if lo_s else None),
                                (int(hi_s) if hi_s else None))
                        if span == (None, None):
                            span = None
                    except ValueError:
                        # RFC 9110 / S3: an unparseable Range header is
                        # IGNORED (full 200 body), never an error
                        span = None
                try:
                    if span is not None and mst is not None:
                        size = mst["size"]  # the inode already fetched
                        lo, hi = span
                        if lo is None:  # suffix range: last N bytes
                            lo, hi = max(0, size - hi), size - 1
                        else:
                            hi = size - 1 if hi is None else min(hi, size - 1)
                        if lo > hi or lo >= size:
                            return self._reply(
                                416,
                                b"<?xml version='1.0'?><Error>"
                                b"<Code>InvalidRange</Code></Error>",
                                headers={"Content-Range": f"bytes */{size}"})
                        data = fs.read_file("/" + key, offset=lo,
                                            length=hi - lo + 1)
                        mct, mhdrs = outer._meta_reply_headers(mrec, mst)
                        mhdrs = outer._null_vid_backfill(self, bucket,
                                                         mhdrs)
                        return self._reply(
                            206, data, ctype=mct,
                            headers={"Content-Range":
                                     f"bytes {lo}-{hi}/{size}",
                                     **mhdrs})
                    data = fs.read_file("/" + key)
                except FsError as e:
                    if e.errno == mn.EISDIR:  # folder-marker key GET
                        return self._reply(200, b"",
                                           ctype="application/octet-stream",
                                           headers=self._cors(bucket))
                    if s3version.VersionStore(fs).latest_is_marker(key):
                        # the newest version is a delete marker: 404
                        # that SAYS so, per the S3 API
                        return self._reply(
                            404,
                            b"<?xml version='1.0'?><Error>"
                            b"<Code>NoSuchKey</Code></Error>",
                            headers={"x-amz-delete-marker": "true"})
                    return self._error(404, "NoSuchKey", key)
                mct, mhdrs = outer._meta_reply_headers(mrec, mst)
                mhdrs = outer._null_vid_backfill(self, bucket, mhdrs)
                self._reply(200, data, ctype=mct,
                            headers={**mhdrs, **self._cors(bucket)})

            def _delete_objects(self, bucket, fs):
                """POST /bucket?delete — batch DeleteObjects: per-key
                authorization, per-key outcome in one DeleteResult."""
                import xml.etree.ElementTree as ET

                data = getattr(self, "_stashed_body", b"")
                try:
                    root = ET.fromstring(data)
                except ET.ParseError as e:
                    return self._error(400, "MalformedXML", str(e))
                # AWS SDKs send the namespaced document
                # (xmlns=http://s3.amazonaws.com/doc/2006-03-06/):
                # match by local name
                # "{*}name" matches any namespace including none
                keys = [o.findtext("{*}Key") or ""
                        for o in root.findall("{*}Object")]
                if not keys or len(keys) > 1000:  # S3's batch limit
                    return self._error(400, "MalformedXML",
                                       "1..1000 Object keys required")
                deleted, errors = [], []
                vs = s3version.VersionStore(fs)
                versioned = bool(vs.status())
                for k in keys:
                    if not k:
                        errors.append((k, "UserKeyMustBeSpecified"))
                        continue
                    if self._key_reserved(k):
                        errors.append((k, "AccessDenied"))
                        continue
                    if not self._allowed("s3:DeleteObject", bucket, k):
                        errors.append((k, "AccessDenied"))
                        continue
                    try:
                        if versioned:
                            # versioned bucket: batch delete adds markers
                            vs.delete(k)
                        else:
                            fs.unlink("/" + k)
                        outer._prune_empty_dirs(fs, k)
                        deleted.append(k)
                    except s3version.S3VersionError:
                        errors.append((k, "AccessDenied"))
                    except FsError as e:
                        if e.errno == mn.ENOENT:
                            # S3 treats delete-of-missing as success
                            deleted.append(k)
                        else:
                            errors.append((k, "InternalError"))
                body = ("<?xml version='1.0'?><DeleteResult>"
                        + "".join(f"<Deleted><Key>{xs.escape(k)}</Key>"
                                  f"</Deleted>" for k in deleted)
                        + "".join(f"<Error><Key>{xs.escape(k)}</Key>"
                                  f"<Code>{c}</Code></Error>"
                                  for k, c in errors)
                        + "</DeleteResult>").encode()
                self._reply(200, body)

            def _sts_action(self):
                """POST / with Action=AssumeRole|GetSessionToken: issue
                temporary credentials for the AUTHENTICATED caller
                (sts.go role). Anonymous or policy-denied callers get
                nothing."""
                if outer.auth is not None and self._principal is None:
                    return self._error(403, "AccessDenied",
                                       "STS requires signed credentials")
                if getattr(self, "_via_token", False):
                    # temp creds must not mint fresh tokens, or a leaked
                    # short-lived credential chains itself past expiry
                    return self._error(403, "AccessDenied",
                                       "cannot call STS with temporary "
                                       "credentials")
                form = urllib.parse.parse_qs(
                    self._stashed_body.decode("utf-8", "replace"))
                action = (form.get("Action") or [""])[0]
                if action not in ("AssumeRole", "GetSessionToken"):
                    return self._error(400, "InvalidAction",
                                       action or "missing Action")
                try:
                    duration = int((form.get("DurationSeconds")
                                    or ["3600"])[0])
                except ValueError:
                    return self._error(400, "InvalidRequest",
                                       "malformed DurationSeconds")
                cred = outer.sts.issue(self._principal or "anonymous",
                                       duration)
                import time as _time

                exp_iso = _time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         _time.gmtime(cred["expiration"]))
                body = (
                    f"<?xml version='1.0'?><{action}Response>"
                    f"<{action}Result><Credentials>"
                    f"<AccessKeyId>{cred['access_key']}</AccessKeyId>"
                    f"<SecretAccessKey>{cred['secret_key']}</SecretAccessKey>"
                    f"<SessionToken>{cred['session_token']}</SessionToken>"
                    f"<Expiration>{exp_iso}</Expiration>"
                    f"</Credentials></{action}Result>"
                    f"</{action}Response>"
                ).encode()
                self._reply(200, body)

            def _post_policy_upload(self, bucket, fs, ctype):
                """Browser form upload (post_policy.go): authorization is
                the policy document's signature, not the Authorization
                header — verify it, honor its conditions, store `file`
                under `key`."""
                from . import s3ext

                fields = s3ext.parse_multipart(self._stashed_body, ctype)
                if "key" not in fields or "file" not in fields:
                    return self._error(400, "InvalidRequest",
                                       "form needs key and file fields")
                # S3 substitutes ${filename} with the file part's
                # client-supplied name BEFORE evaluating conditions, so
                # an eq/starts-with on $key sees the final key
                filename = fields.get(".filename.file", b"upload").decode(
                    "utf-8", "replace") or "upload"
                key = fields["key"].decode("utf-8", "replace").replace(
                    "${filename}", filename.rsplit("/", 1)[-1])
                fields = {**fields, "key": key.encode()}
                if self._key_reserved(key):
                    return self._error(403, "AccessDenied",
                                       ".multipart is a reserved namespace")
                if outer.auth is not None:
                    ok, who = s3ext.verify_post_policy(
                        fields, outer.auth.users.secret_for,
                        implicit={"bucket": bucket})
                    if not ok:
                        return self._error(403, "AccessDenied", who)
                    if not outer.auth.grant_ok(who, bucket, write=True):
                        return self._error(403, "AccessDenied",
                                           "no write grant for bucket")
                try:
                    outer._put_object(fs, key, fields["file"])
                except FsError as e:
                    if e.errno in (mn.ENOSPC, mn.EDQUOT):
                        return self._error(507, "QuotaExceeded", str(e))
                    return self._error(500, "InternalError", str(e))
                status = 204
                raw = fields.get("success_action_status")
                if raw in (b"200", b"201", b"204"):
                    status = int(raw)
                etag = hashlib.md5(fields["file"]).hexdigest()
                # the ETag persists like every other write path, so
                # GET/HEAD/conditionals work on POST-uploaded objects
                ct_field = fields.get("Content-Type")
                outer._obj_meta_save(
                    fs, key,
                    ct_field.decode() if ct_field else None, {}, etag=etag)
                body = b""
                if status == 201:
                    body = (
                        f"<?xml version='1.0'?><PostResponse>"
                        f"<Bucket>{bucket}</Bucket><Key>{xs.escape(key)}"
                        f"</Key><ETag>\"{etag}\"</ETag></PostResponse>"
                    ).encode()
                self._reply(status, body,
                            headers={"ETag": f'"{etag}"',
                                     **self._cors(bucket)})

            def do_HEAD(self):
                begun = self._begin()
                if begun is None:
                    return
                bucket, key, query = begun
                if not key:  # HeadBucket
                    if self._fs(bucket) is None:
                        return self._error(404, "NoSuchBucket", bucket)
                    if not self._check("s3:ListBucket", bucket):
                        return
                    return self._reply(200)
                if not self._check("s3:GetObject", bucket, key):
                    return
                fs = self._fs(bucket)
                if fs is None:
                    return self._error(404, "NoSuchBucket", bucket)
                if self._key_reserved(key):
                    return self._error(403, "AccessDenied",
                                       ".multipart is a reserved namespace")
                vid_q = query.get("versionId", [""])[0]
                if vid_q:
                    try:
                        vmeta = s3version.VersionStore(fs).find(key, vid_q)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    if vmeta["dm"]:
                        return self._error(405, "MethodNotAllowed",
                                           "version is a delete marker")
                    st = {"size": vmeta["size"]}
                    # the VERSION's metadata, not the current object's:
                    # HEAD ?versionId must agree with GET ?versionId —
                    # including 304/412, which evaluate against the
                    # addressed version's etag/mtime
                    vstate = outer._version_meta_state(fs, vmeta)
                    mct, mhdrs = outer._version_reply_headers(
                        fs, vmeta, state=vstate)
                    cond = outer._conditional(self.headers, *vstate)
                    if cond == 412:
                        return self._error(412, "PreconditionFailed", key)
                else:
                    mrec, mst = outer._obj_meta_state(fs, key)
                    if mst is None:
                        if s3version.VersionStore(fs).latest_is_marker(key):
                            return self._reply(
                                404,
                                b"<?xml version='1.0'?><Error>"
                                b"<Code>NoSuchKey</Code></Error>",
                                headers={"x-amz-delete-marker": "true"})
                        return self._error(404, "NoSuchKey", key)
                    st = mst  # one inode fetch covers size + headers
                    cond = outer._conditional(self.headers, mrec, mst)
                    if cond == 412:
                        return self._error(412, "PreconditionFailed", key)
                    mct, mhdrs = outer._meta_reply_headers(mrec, mst)
                    mhdrs = outer._null_vid_backfill(self, bucket, mhdrs)
                # HEAD: standard Content-Length describes what GET would
                # return; no body follows (RFC 9110)
                code = 304 if cond == 304 else 200
                self._audit(code, 0)
                self.send_response(code)
                self.send_header("Content-Type", mct)
                self.send_header("Content-Length", str(st["size"]))
                for hk, hv in mhdrs.items():
                    self.send_header(hk, hv)
                self.end_headers()

            def do_DELETE(self):
                begun = self._begin()
                if begun is None:
                    return
                bucket, key, query = begun
                fs = self._fs(bucket)
                if fs is None:
                    return self._error(404, "NoSuchBucket", bucket)
                if not key and "policy" in query:  # DeleteBucketPolicy
                    if not self._check("s3:DeleteBucketPolicy", bucket):
                        return
                    outer._bucket_cfg_set(fs, s3policy.XA_POLICY, None)
                    return self._reply(204)
                if not key and "lifecycle" in query:  # DeleteBucketLifecycle
                    if not self._check("s3:DeleteBucketLifecycle", bucket):
                        return
                    outer._bucket_cfg_set(fs, s3policy.XA_LIFECYCLE, None)
                    return self._reply(204)
                if not key and "cors" in query:  # DeleteBucketCors
                    if not self._check("s3:DeleteBucketCors", bucket):
                        return
                    outer._bucket_cfg_set(fs, s3policy.XA_CORS, None)
                    return self._reply(204)
                if "uploadId" in query:  # AbortMultipartUpload
                    if not self._check("s3:PutObject", bucket, key):
                        return
                    outer._abort_multipart(fs, query["uploadId"][0])
                    return self._reply(204)
                if self._key_reserved(key):
                    return self._error(403, "AccessDenied",
                                       ".multipart is a reserved namespace")
                if key and "tagging" in query:  # DeleteObjectTagging
                    if not self._check("s3:DeleteObjectTagging", bucket, key):
                        return
                    try:
                        fs.setxattr("/" + key, s3policy.XA_TAGS, None)
                    except FsError:
                        return self._error(404, "NoSuchKey", key)
                    return self._reply(204)
                if not self._check("s3:DeleteObject", bucket, key):
                    return
                vs = s3version.VersionStore(fs)
                vid_q = query.get("versionId", [""])[0]
                if vid_q:  # permanent delete of ONE version
                    try:
                        was_marker = vs.delete_version(
                            key, vid_q, self._bypass_governance())
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    except FsError as e:
                        return self._error(500, "InternalError", str(e))
                    outer._prune_empty_dirs(fs, key)
                    hdrs = {"x-amz-version-id": vid_q}
                    if was_marker:
                        hdrs["x-amz-delete-marker"] = "true"
                    return self._reply(204, headers=hdrs)
                if vs.status():  # versioned delete: add a marker
                    try:
                        marker_vid = vs.delete(key)
                    except s3version.S3VersionError as e:
                        return self._error(e.http, e.code, str(e))
                    except FsError as e:
                        return self._error(500, "InternalError", str(e))
                    outer._prune_empty_dirs(fs, key)
                    return self._reply(204, headers={
                        "x-amz-delete-marker": "true",
                        "x-amz-version-id": marker_vid})
                try:
                    fs.unlink("/" + key)
                    outer._prune_empty_dirs(fs, key)
                except FsError:
                    return self._error(404, "NoSuchKey", key)
                self._reply(204)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    # ---- bucket configuration (xattrs on the volume root) ----
    def _bucket_cfg(self, fs: FileSystem, xa_key: str) -> str | None:
        try:
            return fs.getxattr("/", xa_key)
        except FsError:
            return None

    def _bucket_cfg_set(self, fs: FileSystem, xa_key: str,
                        value: str | None) -> None:
        fs.setxattr("/", xa_key, value)

    # ---- multipart (staged under /.multipart/<uploadId>/) ----
    def _initiate_multipart(self, fs: FileSystem, key: str,
                            headers=None) -> str:
        import secrets

        upload_id = secrets.token_hex(12)
        for d in ("/.multipart", f"/.multipart/{upload_id}"):
            try:
                fs.mkdir(d)
            except FsError as e:
                if e.errno != mn.EEXIST:
                    raise
        fs.setxattr(f"/.multipart/{upload_id}", "s3.key", key)
        if headers is not None:
            # metadata named at initiate lands on the final object
            ct, meta = self._req_obj_meta(headers)
            if ct or meta:
                fs.setxattr(f"/.multipart/{upload_id}", s3policy.XA_META,
                            json.dumps({"ct": ct or "", "meta": meta}))
        return upload_id

    def _put_part(self, fs: FileSystem, upload_id: str, part: int,
                  data: bytes) -> str:
        import hashlib as _h

        fs.resolve(f"/.multipart/{upload_id}")  # 404 if unknown upload
        path = f"/.multipart/{upload_id}/{part:05d}"
        fs.write_file(path, data)
        etag = _h.md5(data).hexdigest()
        # persisted so ListParts is O(parts), not O(uploaded bytes)
        fs.setxattr(path, "s3.etag", etag)
        return etag

    def _complete_multipart(self, fs: FileSystem, key: str,
                            upload_id: str) -> str:
        import hashlib as _h

        staging = f"/.multipart/{upload_id}"
        initiated_for = fs.getxattr(staging, "s3.key")
        if initiated_for != key:
            raise FsError(22, f"upload {upload_id} was initiated for "
                              f"{initiated_for!r}, not {key!r}")
        parts = sorted(fs.readdir(staging))
        body = b"".join(fs.read_file(f"{staging}/{p}") for p in parts)
        etag = _h.md5(body).hexdigest()
        meta_raw = fs.getxattr(staging, s3policy.XA_META)
        # versioned buckets version multipart completions too
        self._put_object_versioned(fs, key, body, etag, bypass=False)
        if meta_raw:  # metadata captured at initiate
            rec = json.loads(meta_raw)
            self._obj_meta_save(fs, key, rec.get("ct"),
                                rec.get("meta") or {}, etag=etag)
        else:
            self._obj_meta_save(fs, key, None, {}, etag=etag)
        self._abort_multipart(fs, upload_id)  # clear staging
        return etag

    def _abort_multipart(self, fs: FileSystem, upload_id: str) -> None:
        staging = f"/.multipart/{upload_id}"
        try:
            for p in list(fs.readdir(staging)):
                fs.unlink(f"{staging}/{p}")
            fs.unlink(staging)
        except FsError:
            pass

    # ---- versioning glue (s3version.py owns the semantics) ----
    def _put_object_versioned(self, fs: FileSystem, key: str, data: bytes,
                              etag: str, bypass: bool) -> str | None:
        """PutObject through the version store when the bucket versions;
        returns the new version id (None on unversioned buckets)."""
        vs = s3version.VersionStore(fs)
        if not vs.status():
            self._put_object(fs, key, data)
            return None
        return vs.put(key, lambda: self._put_object(fs, key, data),
                      etag, bypass_governance=bypass)

    @staticmethod
    def _xml_root(data: bytes):
        import xml.etree.ElementTree as ET

        try:
            return ET.fromstring(data)
        except ET.ParseError as e:
            raise s3version.S3VersionError(400, "MalformedXML", str(e))

    def _parse_versioning_xml(self, data: bytes) -> str:
        root = self._xml_root(data)
        status = root.findtext("{*}Status") or ""
        if status not in ("Enabled", "Suspended"):
            raise s3version.S3VersionError(
                400, "MalformedXML", f"bad Status {status!r}")
        return status

    def _parse_objlock_xml(self, data: bytes) -> dict:
        root = self._xml_root(data)
        if (root.findtext("{*}ObjectLockEnabled") or "") != "Enabled":
            raise s3version.S3VersionError(
                400, "MalformedXML", "ObjectLockEnabled must be Enabled")
        conf: dict = {"enabled": True, "default": None}
        ret = root.find("{*}Rule/{*}DefaultRetention")
        if ret is not None:
            mode = ret.findtext("{*}Mode") or ""
            if mode not in ("GOVERNANCE", "COMPLIANCE"):
                raise s3version.S3VersionError(
                    400, "MalformedXML", f"bad retention Mode {mode!r}")
            days = ret.findtext("{*}Days")
            years = ret.findtext("{*}Years")
            if bool(days) == bool(years):  # exactly one, like AWS
                raise s3version.S3VersionError(
                    400, "MalformedXML",
                    "DefaultRetention needs Days XOR Years")
            conf["default"] = {"mode": mode,
                               "days": int(days) if days else 0,
                               "years": int(years) if years else 0}
        return conf

    @staticmethod
    def _objlock_to_xml(conf: dict) -> bytes:
        rule = ""
        d = conf.get("default")
        if d:
            span = (f"<Days>{d['days']}</Days>" if d.get("days")
                    else f"<Years>{d['years']}</Years>")
            rule = (f"<Rule><DefaultRetention><Mode>{d['mode']}</Mode>"
                    f"{span}</DefaultRetention></Rule>")
        return (f"<?xml version='1.0'?><ObjectLockConfiguration>"
                f"<ObjectLockEnabled>Enabled</ObjectLockEnabled>{rule}"
                f"</ObjectLockConfiguration>").encode()

    def _parse_retention_xml(self, data: bytes) -> tuple[str, float]:
        root = self._xml_root(data)
        mode = root.findtext("{*}Mode") or ""
        raw = root.findtext("{*}RetainUntilDate") or ""
        try:
            until = s3version.parse_iso8601(raw)
        except ValueError:
            raise s3version.S3VersionError(
                400, "MalformedXML", f"bad RetainUntilDate {raw!r}")
        return mode, until

    def _parse_legal_hold_xml(self, data: bytes) -> bool:
        status = self._xml_root(data).findtext("{*}Status") or ""
        if status not in ("ON", "OFF"):
            raise s3version.S3VersionError(
                400, "MalformedXML", f"bad LegalHold Status {status!r}")
        return status == "ON"

    def _list_versions_reply(self, handler, bucket: str, fs: FileSystem,
                             query: dict) -> None:
        prefix = query.get("prefix", [""])[0]
        try:
            max_keys = int(query.get("max-keys", ["1000"])[0])
        except ValueError:
            return handler._error(400, "InvalidArgument",
                                  "max-keys must be an integer")
        if max_keys < 1:
            return handler._error(400, "InvalidArgument",
                                  "max-keys must be positive")
        key_marker = query.get("key-marker", [""])[0]
        vid_marker = query.get("version-id-marker", [""])[0]
        vs = s3version.VersionStore(fs)
        page, truncated, nk, nv = vs.list_versions(
            lambda p: self._list_objects(fs, p), prefix, max_keys,
            key_marker, vid_marker)
        parts = []
        for e in page:
            latest = "true" if e["is_latest"] else "false"
            lm = s3version.iso8601(e["vts"] / 1e9)
            if e["dm"]:
                parts.append(
                    f"<DeleteMarker><Key>{xs.escape(e['key'])}</Key>"
                    f"<VersionId>{e['vid']}</VersionId>"
                    f"<IsLatest>{latest}</IsLatest>"
                    f"<LastModified>{lm}</LastModified></DeleteMarker>")
            else:
                parts.append(
                    f"<Version><Key>{xs.escape(e['key'])}</Key>"
                    f"<VersionId>{e['vid']}</VersionId>"
                    f"<IsLatest>{latest}</IsLatest>"
                    f"<LastModified>{lm}</LastModified>"
                    f"<Size>{e['size']}</Size>"
                    f"<ETag>\"{e['etag']}\"</ETag></Version>")
        markers = ""
        if truncated:
            markers = (f"<NextKeyMarker>{xs.escape(nk)}</NextKeyMarker>"
                       f"<NextVersionIdMarker>{nv}"
                       f"</NextVersionIdMarker>")
        body = (
            f"<?xml version='1.0'?><ListVersionsResult>"
            f"<Name>{bucket}</Name><Prefix>{xs.escape(prefix)}</Prefix>"
            f"<MaxKeys>{max_keys}</MaxKeys>"
            f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
            f"{markers}{''.join(parts)}</ListVersionsResult>"
        ).encode()
        handler._reply(200, body)

    # ---- object metadata (fs_volume.go xattr-backed metadata role) ----
    def _obj_meta_save(self, fs: FileSystem, key: str,
                       ctype: str | None, meta: dict,
                       etag: str | None = None) -> None:
        """Persist Content-Type + x-amz-meta-* + ETag beside the object
        (an xattr, like the reference stores OSS metadata in inode
        xattrs). An overwrite PUT always rewrites the record — stale
        metadata from a previous version of the key must not survive."""
        if ctype or meta or etag:
            fs.setxattr("/" + key, s3policy.XA_META,
                        json.dumps({"ct": ctype or "", "meta": meta,
                                    "etag": etag or ""}))
        else:
            try:
                fs.setxattr("/" + key, s3policy.XA_META, None)
            except FsError:
                pass

    def _obj_meta(self, fs: FileSystem, key: str) -> dict:
        try:
            raw = fs.getxattr("/" + key, s3policy.XA_META)
        except FsError:
            return {}
        return json.loads(raw) if raw else {}

    def _req_obj_meta(self, headers) -> tuple[str | None, dict]:
        """(content-type, user metadata) from request headers."""
        meta = {k.lower()[len("x-amz-meta-"):]: v
                for k, v in headers.items()
                if k.lower().startswith("x-amz-meta-")}
        return headers.get("Content-Type"), meta

    def _obj_meta_state(self, fs: FileSystem, key: str) -> tuple[dict, dict | None]:
        """ONE inode fetch supplying everything the reply needs —
        metadata record, size/mtime AND the live version id (its xattr
        rides the same inode) — shared by conditional evaluation and
        reply-header construction. Replaces what used to be two
        resolve+inode_get pairs per GET/HEAD."""
        try:
            inode = fs.stat("/" + key)  # walk with stat=True: ONE RPC
        except FsError:
            return {}, None
        xa = inode.get("xattr") or {}
        raw = xa.get(s3policy.XA_META)
        try:
            rec = json.loads(raw) if raw else {}
        except ValueError:
            rec = {}  # corrupt record degrades to missing metadata
        vid = xa.get(s3version.XA_VID)
        if vid:
            rec = {**rec, "_vid": vid}
        return rec, {"size": inode["size"], "mtime": inode["mtime"]}

    def _null_vid_backfill(self, handler, bucket: str, hdrs: dict) -> dict:
        """AWS: on a versioning-configured bucket, plain GET/HEAD of a
        pre-versioning object reports x-amz-version-id: null — the same
        id ListObjectVersions and GET ?versionId=null use for it."""
        if "x-amz-version-id" not in hdrs and handler._bucket_conf(
                bucket).get(s3version.XA_VERSIONING):
            hdrs = {**hdrs, "x-amz-version-id": "null"}
        return hdrs

    def _meta_reply_headers(self, rec: dict,
                            st: dict | None) -> tuple[str, dict]:
        """(content-type, extra reply headers) for GET/HEAD — user
        metadata, ETag and Last-Modified (clients and SDKs condition on
        both; see _conditional)."""
        ctype = rec.get("ct") or "application/octet-stream"
        hdrs = {f"x-amz-meta-{k}": v
                for k, v in (rec.get("meta") or {}).items()}
        if rec.get("etag"):
            hdrs["ETag"] = f'"{rec["etag"]}"'
        if rec.get("_vid"):
            # versioned buckets return the LIVE version's id on plain
            # GET/HEAD (AWS behavior sync tools rely on)
            hdrs["x-amz-version-id"] = rec["_vid"]
        if st is not None:
            hdrs["Last-Modified"] = _http_date(st["mtime"])
        return ctype, hdrs

    def _obj_meta_headers(self, fs: FileSystem, key: str) -> tuple[str, dict]:
        return self._meta_reply_headers(*self._obj_meta_state(fs, key))

    def _version_meta_state(self, fs: FileSystem,
                            vmeta: dict) -> tuple[dict, dict | None]:
        """(rec, st) for a SPECIFIC version — the same shape
        `_obj_meta_state` returns for the live object, so
        `_conditional` evaluates 304/412 against the ADDRESSED
        version's etag/mtime, not the current generation's."""
        try:
            raw = fs.getxattr(vmeta["path"], s3policy.XA_META)
            rec = json.loads(raw) if raw else {}
        except (FsError, ValueError):
            rec = {}
        if not rec.get("etag") and vmeta.get("etag"):
            rec = {**rec, "etag": vmeta["etag"]}
        st = ({"mtime": vmeta["vts"] / 1e9} if vmeta.get("vts") else None)
        return rec, st

    def _version_reply_headers(self, fs: FileSystem, vmeta: dict,
                               state: tuple | None = None
                               ) -> tuple[str, dict]:
        """(content-type, headers) for a SPECIFIC version: the archived
        object file carries its XA_META xattr (xattrs travel with the
        rename), so versions serve the same Content-Type / user
        metadata / ETag a plain GET of that generation would — incl.
        the 'null' version of a pre-versioning object, whose etag lives
        only in XA_META. Pass `state` when the caller already fetched
        `_version_meta_state` (avoids a second xattr round-trip)."""
        rec, st = (state if state is not None
                   else self._version_meta_state(fs, vmeta))
        ctype, hdrs = self._meta_reply_headers(rec, st)
        hdrs["x-amz-version-id"] = vmeta["vid"]
        return ctype, hdrs

    def _conditional(self, req_headers, rec: dict,
                     st: dict | None) -> int | None:
        """RFC 7232 / S3 conditional requests for GET/HEAD: returns 304,
        412 or None (proceed). Precedence per the RFC: If-Match and
        If-Unmodified-Since fail first (412); If-None-Match overrides
        If-Modified-Since (304)."""
        if st is None:
            return None  # the caller's 404 path owns missing keys
        etag = rec.get("etag") or ""
        # HTTP dates carry whole seconds; comparing the raw fractional
        # mtime against them breaks revalidation with our OWN
        # Last-Modified (always "modified since" by the fraction)
        mtime = int(st["mtime"])

        def match(header_val: str) -> bool:
            vals = [v.strip().strip('"') for v in header_val.split(",")]
            return "*" in vals or (bool(etag) and etag in vals)

        im = req_headers.get("If-Match")
        if im is not None and not match(im):
            return 412
        ius = req_headers.get("If-Unmodified-Since")
        if ius is not None:
            t = _parse_http_date(ius)
            if t is not None and mtime > t:
                return 412
        inm = req_headers.get("If-None-Match")
        if inm is not None:
            return 304 if match(inm) else None
        ims = req_headers.get("If-Modified-Since")
        if ims is not None:
            t = _parse_http_date(ims)
            if t is not None and mtime <= t:
                return 304
        return None

    # ---- key <-> path adaptation ----
    def _put_object(self, fs: FileSystem, key: str, data: bytes) -> None:
        parts = [p for p in key.split("/") if p]
        path = ""
        for d in parts[:-1]:
            path += "/" + d
            try:
                fs.mkdir(path)
            except FsError as e:
                if e.errno != mn.EEXIST:
                    raise
        fs.write_file("/" + key, data)

    def _list_objects(self, fs: FileSystem, prefix: str) -> list[tuple]:
        """Sorted (key, size, mtime, etag) for every object under
        prefix — everything a listing entry needs, from the ONE inode
        fetch the walk already performs."""
        out: list[tuple] = []

        def walk(path: str, keybase: str):
            for name, ino in sorted(fs.readdir(path or "/").items()):
                if not path and name in (".multipart", s3version.VDIR):
                    continue  # internal areas are not object namespace
                inode = fs.meta.inode_get(ino)
                k = f"{keybase}{name}"
                if inode["type"] == mn.DIR:
                    walk(f"{path}/{name}", f"{k}/")
                elif k.startswith(prefix):
                    raw = inode.get("xattr", {}).get(s3policy.XA_META)
                    try:
                        etag = (json.loads(raw).get("etag") or ""
                                ) if raw else ""
                    except ValueError:
                        etag = ""  # one corrupt record must not 500 listings
                    out.append((k, inode["size"], inode["mtime"], etag))

        walk("", "")
        return sorted(out)

    def _list_v2(self, fs: FileSystem, prefix: str, delimiter: str,
                 max_keys: int, token: str):
        """ListObjectsV2 semantics: delimiter groups keys into
        CommonPrefixes (one entry per group, the whole group consumed in
        the same page); the continuation token is the last RAW key the
        page consumed, so pagination resumes after a full group and is
        stable under concurrent writes."""
        all_keys = sorted(self._list_objects(fs, prefix))  # global order
        if token:
            all_keys = [t for t in all_keys if t[0] > token]
        keys: list = []
        prefixes: list = []
        last_raw = ""
        truncated = False
        i = 0
        while i < len(all_keys):
            if len(keys) + len(prefixes) >= max_keys:
                truncated = True
                break
            k, sz, mt, et = all_keys[i]
            if delimiter:
                rest = k[len(prefix):]
                d = rest.find(delimiter)
                if d >= 0:
                    cp = prefix + rest[: d + len(delimiter)]
                    prefixes.append(cp)
                    # consume the WHOLE group now so a truncation after
                    # this entry never re-yields the same CommonPrefix
                    while i < len(all_keys) and all_keys[i][0].startswith(cp):
                        last_raw = all_keys[i][0]
                        i += 1
                    continue
            keys.append((k, sz, mt, et))
            last_raw = k
            i += 1
        next_token = last_raw if truncated else ""
        return keys, prefixes, next_token, truncated

    def _prune_empty_dirs(self, fs: FileSystem, key: str) -> None:
        parts = [p for p in key.split("/") if p][:-1]
        while parts:
            path = "/" + "/".join(parts)
            try:
                if fs.meta.dentry_count(fs.resolve(path)) == 0:
                    fs.unlink(path)
                else:
                    break
            except FsError:
                break
            parts.pop()

    def start(self) -> "ObjectNode":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        for sink in self.audit_sinks:
            try:
                sink.close()  # flush buffered audit events
            except Exception:
                pass
