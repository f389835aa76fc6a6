"""S3 authorization surface: ACLs, bucket policy, CORS, object tagging.

Role parity: objectnode/acl.go (canned ACLs + grants), policy.go
(bucket policy statements with Effect/Principal/Action/Resource and
wildcard matching; explicit Deny wins), cors.go, tagging.go. Bucket
configuration documents persist as xattrs on the backing volume's root
inode (replicated through the metanode plane); object tags as xattrs on
the object's inode.

Evaluation order (the reference's policy-check flow):
    1. bucket policy explicit Deny  -> deny
    2. bucket policy Allow          -> allow
    3. ACL grant covers the action  -> allow
    4. user-store volume grant      -> allow (authenticated users only)
    5.                              -> deny

The port's copy of ``cubefs_tpu/fs/s3policy.py``.
"""

from __future__ import annotations

import fnmatch
import json
import xml.etree.ElementTree as ET
import xml.sax.saxutils as xs

# xattr keys on the volume root / object inode
XA_ACL = "s3.acl"
XA_POLICY = "s3.policy"
XA_CORS = "s3.cors"
XA_TAGS = "s3.tags"
XA_META = "s3.meta"  # {"ct": content-type, "meta": {lower-name: value}}
XA_LIFECYCLE = "s3.lifecycle"

CANNED_ACLS = ("private", "public-read", "public-read-write",
               "authenticated-read")

# HEAD authorizes as s3:GetObject, matching AWS (there is no separate
# HeadObject permission)
READ_ACTIONS = {"s3:GetObject", "s3:ListBucket", "s3:GetObjectTagging",
                "s3:GetBucketVersioning", "s3:ListBucketVersions",
                "s3:GetObjectRetention", "s3:GetObjectLegalHold"}
WRITE_ACTIONS = {"s3:PutObject", "s3:DeleteObject", "s3:PutObjectTagging",
                 "s3:DeleteObjectTagging", "s3:PutObjectRetention",
                 "s3:PutObjectLegalHold"}


class S3ConfigError(Exception):
    pass


# ---------------- ACL ----------------
def acl_allows(acl: str | None, action: str, principal: str | None) -> bool:
    """Canned-ACL evaluation: does this ACL grant `action` to
    `principal` (None = anonymous)?"""
    acl = acl or "private"
    if action in READ_ACTIONS:
        if acl in ("public-read", "public-read-write"):
            return True
        if acl == "authenticated-read" and principal is not None:
            return True
    if action in WRITE_ACTIONS and acl == "public-read-write":
        return True
    return False


def acl_to_xml(acl: str, owner: str) -> bytes:
    grants = [("FULL_CONTROL", owner)]
    if acl in ("public-read", "public-read-write"):
        grants.append(("READ", "AllUsers"))
    if acl == "public-read-write":
        grants.append(("WRITE", "AllUsers"))
    if acl == "authenticated-read":
        grants.append(("READ", "AuthenticatedUsers"))
    body = "".join(
        f"<Grant><Grantee>{xs.escape(who)}</Grantee>"
        f"<Permission>{perm}</Permission></Grant>"
        for perm, who in grants
    )
    return (f"<?xml version='1.0'?><AccessControlPolicy>"
            f"<Owner><ID>{xs.escape(owner)}</ID></Owner>"
            f"<AccessControlList>{body}</AccessControlList>"
            f"</AccessControlPolicy>").encode()


# ---------------- bucket policy ----------------
def parse_policy(doc: bytes) -> dict:
    """Validate a bucket-policy JSON document; returns the parsed dict.
    Statement shape: Effect Allow|Deny, Principal "*"|ak|{"AWS": [...]},
    Action str|[...], Resource str|[...] (arn:aws:s3:::bucket[/key])."""
    try:
        pol = json.loads(doc)
    except ValueError as e:  # JSONDecodeError or non-UTF-8 body
        raise S3ConfigError(f"policy is not valid JSON: {e}") from None
    stmts = pol.get("Statement")
    if not isinstance(stmts, list) or not stmts:
        raise S3ConfigError("policy needs a non-empty Statement list")
    for s in stmts:
        if s.get("Effect") not in ("Allow", "Deny"):
            raise S3ConfigError("statement Effect must be Allow or Deny")
        if "Action" not in s or "Resource" not in s:
            raise S3ConfigError("statement needs Action and Resource")
    return pol


def _as_list(v) -> list:
    if isinstance(v, dict):  # {"AWS": [...]} principal form
        v = v.get("AWS", [])
    return v if isinstance(v, list) else [v]


def _principal_matches(stmt, principal: str | None) -> bool:
    pr = _as_list(stmt.get("Principal", "*"))
    for p in pr:
        if p == "*" or (principal is not None and p == principal):
            return True
    return False


def _glob_any(patterns: list, value: str) -> bool:
    return any(fnmatch.fnmatchcase(value, p) for p in patterns)


def policy_decision(policy: dict | None, action: str, bucket: str,
                    key: str, principal: str | None) -> str | None:
    """Returns "Allow", "Deny", or None (policy silent)."""
    if not policy:
        return None
    resource = f"arn:aws:s3:::{bucket}" + (f"/{key}" if key else "")
    decision = None
    for stmt in policy.get("Statement", []):
        if not _principal_matches(stmt, principal):
            continue
        if not _glob_any(_as_list(stmt["Action"]), action):
            continue
        if not _glob_any(_as_list(stmt["Resource"]), resource):
            continue
        if stmt["Effect"] == "Deny":
            return "Deny"  # explicit deny wins immediately
        decision = "Allow"
    return decision


def authorize(action: str, bucket: str, key: str, principal: str | None,
              acl: str | None, policy: dict | None,
              user_grant_ok: bool) -> bool:
    """The combined authorization decision (see module docstring)."""
    decision = policy_decision(policy, action, bucket, key, principal)
    if decision == "Deny":
        return False
    if decision == "Allow":
        return True
    if acl_allows(acl, action, principal):
        return True
    return principal is not None and user_grant_ok


# ---------------- CORS ----------------
def parse_cors(doc: bytes) -> list[dict]:
    """<CORSConfiguration><CORSRule><AllowedOrigin/><AllowedMethod/>
    <AllowedHeader/><MaxAgeSeconds/></CORSRule>...</CORSConfiguration>"""
    try:
        root = ET.fromstring(doc)
    except ET.ParseError as e:
        raise S3ConfigError(f"bad CORS XML: {e}") from None
    valid_methods = {"GET", "PUT", "POST", "DELETE", "HEAD"}
    rules = []
    for r in root.findall("CORSRule"):
        rule = {
            "origins": [e.text or "" for e in r.findall("AllowedOrigin")],
            "methods": [e.text or "" for e in r.findall("AllowedMethod")],
            "headers": [e.text or "" for e in r.findall("AllowedHeader")],
            "max_age": int(r.findtext("MaxAgeSeconds", "0") or 0),
        }
        if not rule["origins"] or not rule["methods"]:
            raise S3ConfigError("CORSRule needs AllowedOrigin and "
                                "AllowedMethod")
        for m in rule["methods"]:
            if m not in valid_methods:
                raise S3ConfigError(f"unsupported AllowedMethod {m!r}")
        for v in rule["origins"] + rule["headers"]:
            # these values flow into response headers: no control chars
            if any(ord(ch) < 0x20 or ch == "\x7f" for ch in v):
                raise S3ConfigError("control characters in CORS rule")
        rules.append(rule)
    if not rules:
        raise S3ConfigError("CORSConfiguration needs at least one CORSRule")
    return rules


def cors_match(rules: list[dict] | None, origin: str,
               method: str) -> dict | None:
    """First rule matching origin+method, or None."""
    for rule in rules or []:
        if method not in rule["methods"]:
            continue
        if any(fnmatch.fnmatchcase(origin, o) for o in rule["origins"]):
            return rule
    return None


def cors_headers(rule: dict, origin: str) -> dict:
    out = {
        "Access-Control-Allow-Origin": origin,
        "Access-Control-Allow-Methods": ", ".join(rule["methods"]),
    }
    if rule["headers"]:
        out["Access-Control-Allow-Headers"] = ", ".join(rule["headers"])
    if rule["max_age"]:
        out["Access-Control-Max-Age"] = str(rule["max_age"])
    return out


# ---------------- object tagging ----------------
def parse_tagging(doc: bytes) -> dict[str, str]:
    try:
        root = ET.fromstring(doc)
    except ET.ParseError as e:
        raise S3ConfigError(f"bad Tagging XML: {e}") from None
    tags: dict[str, str] = {}
    ts = root.find("TagSet")
    for t in (ts.findall("Tag") if ts is not None else []):
        k = t.findtext("Key")
        if not k:
            raise S3ConfigError("Tag needs a Key")
        tags[k] = t.findtext("Value") or ""
    if len(tags) > 10:  # S3's object-tag limit
        raise S3ConfigError("at most 10 tags per object")
    return tags


def tagging_to_xml(tags: dict[str, str]) -> bytes:
    body = "".join(
        f"<Tag><Key>{xs.escape(k)}</Key><Value>{xs.escape(v)}</Value></Tag>"
        for k, v in sorted(tags.items())
    )
    return (f"<?xml version='1.0'?><Tagging><TagSet>{body}</TagSet>"
            f"</Tagging>").encode()


# ---------------- lifecycle configuration ----------------
def parse_lifecycle(doc: bytes) -> list[dict]:
    """<LifecycleConfiguration><Rule><ID/><Filter><Prefix/></Filter>
    <Status/><Expiration><Days/></Expiration>
    <Transition><Days/></Transition></Rule>... (namespaced or not)."""
    try:
        root = ET.fromstring(doc)
    except ET.ParseError as e:
        raise S3ConfigError(f"bad lifecycle XML: {e}") from None
    def _days(parent, what: str, rule_id: str) -> int:
        """Days is REQUIRED and >= 1 (AWS rule): a missing or zero value
        must never silently become expire-everything-now."""
        raw = parent.findtext("{*}Days")
        try:
            days = int(raw)
        except (TypeError, ValueError):
            raise S3ConfigError(
                f"rule {rule_id!r}: {what} needs an integer Days") from None
        if days < 1:
            raise S3ConfigError(f"rule {rule_id!r}: Days must be >= 1")
        return days

    rules = []
    # "{*}name" matches the element in ANY namespace including none, so
    # one expression covers AWS-SDK documents and bare XML alike
    for r in root.findall("{*}Rule"):
        rule = {
            "id": r.findtext("{*}ID") or f"rule-{len(rules) + 1}",
            "status": r.findtext("{*}Status") or "Enabled",
            "prefix": "",
            "expire_days": None,
            "transition_days": None,
        }
        flt = r.find("{*}Filter")
        if flt is not None:
            rule["prefix"] = flt.findtext("{*}Prefix") or ""
        else:
            # legacy (pre-Filter) format puts Prefix directly on the
            # Rule; ignoring it would silently widen the rule to the
            # WHOLE bucket — the exact expire-everything hazard the
            # Days validation exists to prevent
            rule["prefix"] = r.findtext("{*}Prefix") or ""
        exp = r.find("{*}Expiration")
        if exp is not None:
            rule["expire_days"] = _days(exp, "Expiration", rule["id"])
        tr = r.find("{*}Transition")
        if tr is not None:
            rule["transition_days"] = _days(tr, "Transition", rule["id"])
        if rule["expire_days"] is None and rule["transition_days"] is None:
            raise S3ConfigError(
                f"rule {rule['id']!r} needs Expiration or Transition")
        if rule["status"] not in ("Enabled", "Disabled"):
            raise S3ConfigError(f"bad Status {rule['status']!r}")
        rules.append(rule)
    if not rules:
        raise S3ConfigError("LifecycleConfiguration needs at least one Rule")
    return rules


def lifecycle_to_xml(rules: list[dict]) -> bytes:
    out = []
    for r in rules:
        parts = [f"<ID>{xs.escape(r['id'])}</ID>",
                 f"<Filter><Prefix>{xs.escape(r['prefix'])}</Prefix></Filter>",
                 f"<Status>{r['status']}</Status>"]
        if r.get("expire_days") is not None:
            parts.append(f"<Expiration><Days>{r['expire_days']}</Days>"
                         f"</Expiration>")
        if r.get("transition_days") is not None:
            parts.append(f"<Transition><Days>{r['transition_days']}</Days>"
                         f"<StorageClass>EC_COLD</StorageClass>"
                         f"</Transition>")
        out.append("<Rule>" + "".join(parts) + "</Rule>")
    return (f"<?xml version='1.0'?><LifecycleConfiguration>"
            f"{''.join(out)}</LifecycleConfiguration>").encode()
