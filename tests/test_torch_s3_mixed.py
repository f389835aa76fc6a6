"""The port's S3 gateway beside the reference's on the CPU.

- mixed stacks over real sockets (``test_torch_fs.WireFs``): one
  package's master, metanodes and datanodes, a ``FileSystem`` and an
  ``ObjectNode`` of each package on one volume. An object PUT through one
  gateway (single, multipart, versioned) GETs byte-identical through the
  other with the same ETag and metadata headers, and by the writer's
  version id; a bucket policy, CORS, tagging, lifecycle and object-lock
  config set through one is enforced by the other, and the other
  package's ``LcNode`` adopts the lifecycle rule. Every request to one
  gateway is signed by the other package's ``sign_v4``;
- equal signatures: for seeded inputs the port's ``sign_v4``,
  ``presign_v4``, ``sign_v2`` and ``s3ext.build_aws_chunked`` equal the
  reference's, and each package's verifier accepts the other's;
- a twin migration through each package's in-process gateway stack (the
  port's ``BlobClient`` on ``device="cpu"``, kernel A's plain version):
  the objects PUT through the gateway, the ``Transition`` rule PUT through
  it and adopted by ``LcNode.load_rules_from_bucket``, one scan, then
  equal locations and shards, and cold GETs through the gateway equal to
  the hot bytes, healthy and with a blobnode's disks broken;
- the limit the port shares with the reference: a gateway over a
  ``FileSystem`` with no blob client (the ``objectnode`` role's) answers a
  tiered object with its size in zero bytes, in both packages.

Tolerance: exact bytes.
"""

import hashlib
import json
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from cubefs_tpu_torch.codec import codemode as cm
from cubefs_tpu_torch.fs import authnode, lcnode, objectnode, s3auth, s3ext
from cubefs_tpu_torch.ops import _build
from test_torch_fs import WireFs, _close, _port_qos_still, both, ref, wait_for  # noqa: F401

OWNER = {"access_key": "AKIDOWNER00000000001", "secret_key": "owner-secret-key"}
STRANGER = {"access_key": "AKIDSTRANGER0000001", "secret_key": "stranger-secret-key"}


def _s3(name, authnode, lcnode, objectnode, s3auth, s3ext):
    return types.SimpleNamespace(name=name, UserStore=authnode.UserStore,
                                 ObjectNode=objectnode.ObjectNode, LcNode=lcnode.LcNode,
                                 s3auth=s3auth, s3ext=s3ext)


PORT_S3 = _s3("port", authnode, lcnode, objectnode, s3auth, s3ext)


@pytest.fixture(scope="module")
def s3ref():
    from cubefs_tpu.fs import authnode, lcnode, objectnode, s3auth, s3ext

    return _s3("ref", authnode, lcnode, objectnode, s3auth, s3ext)


def gateway(s3pkg, fs, vol: str, bucket: str = "bkt"):
    """An ``ObjectNode`` serving ``fs`` as ``bucket`` to the owner (``rw``
    on ``vol``) and a stranger with no grant, as the role builds it."""
    store = s3pkg.UserStore()
    for cred, grants in ((OWNER, {vol: "rw"}), (STRANGER, {})):
        store.users[cred["access_key"]] = {"user_id": cred["access_key"],
                                           "sk": cred["secret_key"], "volumes": grants}
    auth = s3pkg.s3auth.S3V4Authenticator(store, {bucket: vol})
    return s3pkg.ObjectNode({bucket: fs}, authenticator=auth).start()


def call(method, url, body=b"", headers=None, cred=OWNER, signer=s3auth):
    """One request: SigV4-signed by ``signer``'s ``sign_v4`` as ``cred``,
    or anonymous with ``cred=None``. Returns (status, body, headers)."""
    headers = {k.lower(): v for k, v in (headers or {}).items()}
    if cred is not None:
        u = urllib.parse.urlsplit(url)
        amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        headers.update({"host": u.netloc, "x-amz-date": amz,
                        "x-amz-content-sha256": hashlib.sha256(body).hexdigest()})
        headers["authorization"] = signer.sign_v4(method, u.path, u.query, headers, body,
                                                  cred["access_key"], cred["secret_key"], amz)
    req = urllib.request.Request(url, data=body or None, method=method)
    for k, v in headers.items():
        if k != "host":
            req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def payloads(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


def put_multipart(url, parts, signer, headers=None) -> str:
    st, body, _ = call("POST", f"{url}?uploads", headers=headers, signer=signer)
    assert st == 200, body
    upload = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    xml = []
    for i, p in enumerate(parts, start=1):
        st, _, h = call("PUT", f"{url}?partNumber={i}&uploadId={upload}", p, signer=signer)
        assert st == 200
        xml.append(f"<Part><PartNumber>{i}</PartNumber><ETag>{h['ETag']}</ETag></Part>")
    doc = f"<CompleteMultipartUpload>{''.join(xml)}</CompleteMultipartUpload>".encode()
    st, body, _ = call("POST", f"{url}?uploadId={upload}", doc, signer=signer)
    assert st == 200 and b"CompleteMultipartUploadResult" in body
    return body.split(b"<ETag>")[1].split(b"</ETag>")[0].decode()


OBJECT_HEADERS = ("ETag", "Content-Length", "Content-Type", "Last-Modified",
                  "x-amz-meta-color", "x-amz-version-id")


def described(h: dict) -> dict:
    return {k: h.get(k) for k in OBJECT_HEADERS}


class Mixed:
    """Both packages' clients and gateways over one package's cluster."""

    def __init__(self, cluster_pkg, fs_pkgs, s3_pkgs, root):
        self.c = WireFs(fs_pkgs[cluster_pkg], root)
        self.fs = {n: fs_pkgs[n].FileSystem(self.c.view, fs_pkgs[n].rpc.NodePool())
                   for n in ("port", "ref")}
        wait_for(lambda: self.fs[cluster_pkg].readdir("/") is not None, what="a meta leader")
        self.gw = {n: gateway(s3_pkgs[n], self.fs[n], "mix") for n in self.fs}
        self.url = {n: f"http://{g.addr}/bkt" for n, g in self.gw.items()}
        self.s3 = s3_pkgs

    def signer(self, gw: str):
        """A request to one package's gateway is signed by the other's."""
        return self.s3["ref" if gw == "port" else "port"].s3auth

    def stop(self):
        for g in self.gw.values():
            g.stop()
        for fs in self.fs.values():
            _close(fs)
        self.c.stop()


@pytest.fixture
def mixed(request, ref, s3ref, tmp_path):
    m = Mixed(request.param, both(ref), {"port": PORT_S3, "ref": s3ref}, tmp_path)
    yield m
    m.stop()


PAIRS = (("port", "ref"), ("ref", "port"))


@pytest.mark.parametrize("mixed", ["ref", "port"], indirect=True)
def test_objects_written_through_one_gateway_read_through_the_other(mixed):
    """Single and multipart PUTs, then versioned PUTs, through each
    gateway: the other GETs and HEADs the same bytes, ETag and metadata,
    answers the writer's version ids with their bytes, and lists the same
    versions."""
    m = mixed
    meta = {"x-amz-meta-color": "teal", "content-type": "application/x-test"}
    single = dict(zip(("port", "ref"), payloads(3, [300_001, 70_003])))
    parts = dict(zip(("port", "ref"), (payloads(4, [100_000, 100_000, 1234]),
                                       payloads(5, [65_536, 7]))))
    for w, r in PAIRS:
        st, _, h = call("PUT", f"{m.url[w]}/{w}/single.bin", single[w], meta, signer=m.signer(w))
        assert st == 200 and h["ETag"] == f'"{hashlib.md5(single[w]).hexdigest()}"'
        etag = put_multipart(f"{m.url[w]}/{w}/multi.bin", parts[w], m.signer(w), meta)
        assert etag == f'"{hashlib.md5(b"".join(parts[w])).hexdigest()}"'
    for w, r in PAIRS:
        for key, want in ((f"{w}/single.bin", single[w]), (f"{w}/multi.bin", b"".join(parts[w]))):
            st, got, h = call("GET", f"{m.url[r]}/{key}", signer=m.signer(r))
            assert st == 200 and got == want
            heads = [call("HEAD", f"{m.url[g]}/{key}", signer=m.signer(g))[2] for g in (w, r)]
            assert described(heads[0]) == described(heads[1]) == described(h)
            assert h["x-amz-meta-color"] == "teal" and h["Content-Type"] == "application/x-test"

    on = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    assert call("PUT", f"{m.url['port']}?versioning", on, signer=m.signer("port"))[0] == 200
    for g in ("port", "ref"):
        st, body, _ = call("GET", f"{m.url[g]}?versioning", signer=m.signer(g))
        assert st == 200 and b"<Status>Enabled</Status>" in body
    vids = {}
    for w, r in PAIRS:
        for i, data in enumerate(payloads(6 + len(w), [50_000, 20_001])):
            st, _, h = call("PUT", f"{m.url[w]}/v/{w}.bin", data, signer=m.signer(w))
            assert st == 200
            vids[(w, i)] = (h["x-amz-version-id"], data)
    for w, r in PAIRS:
        for i in range(2):
            vid, data = vids[(w, i)]
            st, got, h = call("GET", f"{m.url[r]}/v/{w}.bin?versionId={vid}", signer=m.signer(r))
            assert st == 200 and got == data and h["x-amz-version-id"] == vid
        st, got, h = call("GET", f"{m.url[r]}/v/{w}.bin", signer=m.signer(r))
        assert got == vids[(w, 1)][1] and h["x-amz-version-id"] == vids[(w, 1)][0]
    listings = [call("GET", f"{m.url[g]}?versions&prefix=v/", signer=m.signer(g))
                for g in ("port", "ref")]
    assert listings[0][0] == 200 and listings[0][1] == listings[1][1]
    assert all(vid.encode() in listings[0][1] for vid, _ in vids.values())


LIFECYCLE = (b"<LifecycleConfiguration><Rule><ID>to-cold</ID><Filter><Prefix>cold/</Prefix>"
             b"</Filter><Status>Enabled</Status><Transition><Days>1</Days>"
             b"<StorageClass>EC_COLD</StorageClass></Transition></Rule></LifecycleConfiguration>")


@pytest.mark.parametrize("mixed,setter", [("port", "ref"), ("ref", "port")],
                         indirect=["mixed"])
def test_bucket_configs_set_through_one_gateway_hold_in_the_other(mixed, setter):
    """A bucket policy, CORS, object tags, a lifecycle ``Transition`` rule
    and object lock, each set through ``setter``'s gateway, are enforced
    (and read back) by the other's; the other package's ``LcNode`` adopts
    the rule from the volume root."""
    m = mixed
    other = "port" if setter == "ref" else "ref"
    s, o = m.url[setter], m.url[other]
    sign_s, sign_o = m.signer(setter), m.signer(other)
    for key, data in (("pub/page.html", b"<html>"), ("secret/doc.txt", b"hush")):
        assert call("PUT", f"{s}/{key}", data, signer=sign_s)[0] == 200
    assert call("GET", f"{o}/pub/page.html", cred=None)[0] == 403  # no policy yet
    policy = json.dumps({"Statement": [
        {"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
         "Resource": "arn:aws:s3:::bkt/pub/*"},
        {"Effect": "Deny", "Principal": "*", "Action": "s3:GetObject",
         "Resource": "arn:aws:s3:::bkt/secret/*"}]}).encode()
    assert call("PUT", f"{s}?policy", policy, signer=sign_s)[0] == 200
    assert call("GET", f"{o}/pub/page.html", cred=None)[:2] == (200, b"<html>")
    assert call("GET", f"{o}/secret/doc.txt", signer=sign_o)[0] == 403  # Deny beats the grant
    assert call("PUT", f"{o}/pub/x", b"x", cred=STRANGER, signer=sign_o)[0] == 403
    assert call("PUT", f"{o}/pub/x", b"x", cred=None)[0] == 403

    cors = (b"<CORSConfiguration><CORSRule><AllowedOrigin>https://app.example</AllowedOrigin>"
            b"<AllowedMethod>GET</AllowedMethod><MaxAgeSeconds>600</MaxAgeSeconds>"
            b"</CORSRule></CORSConfiguration>")
    assert call("PUT", f"{s}?cors", cors, signer=sign_s)[0] == 200
    pre = {"Origin": "https://app.example", "Access-Control-Request-Method": "GET"}
    st, _, h = call("OPTIONS", f"{o}/pub/page.html", headers=pre, cred=None)
    assert st == 200 and h["Access-Control-Allow-Origin"] == "https://app.example"
    assert h["Access-Control-Max-Age"] == "600"
    assert call("OPTIONS", f"{o}/pub/page.html", cred=None,
                headers=dict(pre, Origin="https://evil.example"))[0] == 403

    tags = (b"<Tagging><TagSet><Tag><Key>team</Key><Value>storage</Value></Tag>"
            b"</TagSet></Tagging>")
    assert call("PUT", f"{s}/pub/page.html?tagging", tags, signer=sign_s)[0] == 200
    got = [call("GET", f"{u}/pub/page.html?tagging", signer=g)
           for u, g in ((s, sign_s), (o, sign_o))]
    assert got[0][0] == got[1][0] == 200 and got[0][1] == got[1][1]
    assert b"<Key>team</Key>" in got[1][1]

    assert call("PUT", f"{s}?lifecycle", LIFECYCLE, signer=sign_s)[0] == 200
    got = [call("GET", f"{u}?lifecycle", signer=g) for u, g in ((s, sign_s), (o, sign_o))]
    assert got[0][:2] == got[1][:2] and b"<Transition><Days>1</Days>" in got[1][1]
    lc = m.s3[other].LcNode(m.fs[other])
    assert lc.load_rules_from_bucket() == 1
    (rule,) = lc.rules
    assert (rule.rule_id, rule.prefix, rule.transition_after_s, rule.expire_after_s,
            rule.enabled) == ("to-cold", "/cold/", 86400.0, None, True)

    on = b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>"
    lock = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled><Rule>"
            b"<DefaultRetention><Mode>GOVERNANCE</Mode><Days>1</Days></DefaultRetention>"
            b"</Rule></ObjectLockConfiguration>")
    assert call("PUT", f"{s}?versioning", on, signer=sign_s)[0] == 200
    assert call("PUT", f"{s}?object-lock", lock, signer=sign_s)[0] == 200
    st, _, h = call("PUT", f"{o}/locked.bin", b"precious", signer=sign_o)
    assert st == 200
    vid = h["x-amz-version-id"]
    for u, g in ((o, sign_o), (s, sign_s)):
        st, body, _ = call("GET", f"{u}/locked.bin?retention", signer=g)
        assert st == 200 and b"GOVERNANCE" in body
        st, body, _ = call("DELETE", f"{u}/locked.bin?versionId={vid}", signer=g)
        assert st == 403 and b"AccessDenied" in body
    assert call("GET", f"{s}/locked.bin?versionId={vid}", signer=sign_s)[:2] == (200, b"precious")


# ---------------- equal signatures ----------------

def _signing_inputs(seed):
    rng = np.random.default_rng(seed)
    word = lambda n: "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz0123456789"), n))  # noqa: E731
    amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time() - int(rng.integers(0, 600))))
    body = rng.integers(0, 256, int(rng.integers(0, 200_000)), dtype=np.uint8).tobytes()
    return types.SimpleNamespace(
        ak="AK" + word(18).upper(), sk=word(40), amz=amz, body=body,
        path=f"/bkt/{word(6)}/{word(9)}.bin", query=f"tagging&x-id={word(5)}",
        headers={"host": "127.0.0.1:9000", "x-amz-date": amz, "content-type": "application/x-y",
                 f"x-amz-meta-{word(4)}": word(12)},
        date=time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime()),
        chunk=int(rng.integers(1000, 70_000)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_signatures_equal_the_reference_and_verify_across(seed, s3ref):
    """``sign_v4``, ``presign_v4``, ``sign_v2`` and ``build_aws_chunked``
    give the reference's bytes for seeded inputs, and each package's
    verifier accepts the other package's signature (and refuses it with
    one byte of the body changed)."""
    x = _signing_inputs(seed)
    secret = {x.ak: x.sk}.get
    pkgs = {"port": PORT_S3, "ref": s3ref}
    sig = {n: p.s3auth.sign_v4("PUT", x.path, x.query, x.headers, x.body, x.ak, x.sk, x.amz)
           for n, p in pkgs.items()}
    pre = {n: p.s3auth.presign_v4("GET", x.path, "127.0.0.1:9000", x.ak, x.sk, x.amz,
                                  expires=900, extra_query=[("versionId", "v1")])
           for n, p in pkgs.items()}
    v2_headers = {"date": x.date, "content-type": "application/x-y", "x-amz-meta-k": "v"}
    v2 = {n: p.s3auth.sign_v2("PUT", x.path, "tagging", v2_headers, x.ak, x.sk)
          for n, p in pkgs.items()}
    scope = f"{x.amz[:8]}/us-east-1/s3/aws4_request"
    key = PORT_S3.s3auth.signing_key(x.sk, x.amz[:8], "us-east-1", "s3")
    assert key == s3ref.s3auth.signing_key(x.sk, x.amz[:8], "us-east-1", "s3")
    seed_sig = sig["port"].rsplit("=", 1)[1]
    chunked = {n: p.s3ext.build_aws_chunked(x.body, x.chunk, seed_sig, key, x.amz, scope)
               for n, p in pkgs.items()}
    assert sig["port"] == sig["ref"] and pre["port"] == pre["ref"]
    assert v2["port"] == v2["ref"] and chunked["port"] == chunked["ref"]

    signed = dict(x.headers, authorization=sig["port"],
                  **{"x-amz-content-sha256": hashlib.sha256(x.body).hexdigest()})
    for n, p in pkgs.items():
        a = p.s3auth
        assert a.verify_v4("PUT", x.path, x.query, signed, x.body, secret) == (True, x.ak)
        assert a.verify_v4("PUT", x.path, x.query, signed, x.body + b"!", secret)[0] is False
        assert a.verify_presigned_v4("GET", x.path, pre[n], "127.0.0.1:9000", secret) == \
            (True, x.ak)
        assert a.verify_v2("PUT", x.path, "tagging", dict(v2_headers, authorization=v2[n]),
                           secret) == (True, x.ak)
        assert p.s3ext.verify_aws_chunked(chunked[n], seed_sig, key, x.amz, scope) == \
            (True, x.body)
        bent = bytearray(chunked[n])
        bent[-40] ^= 1
        assert p.s3ext.verify_aws_chunked(bytes(bent), seed_sig, key, x.amz, scope)[0] is False


# ---------------- the cold tier through each gateway ----------------

def tier_pkg(name, device="cpu"):
    """One package's modules for a ``TierStack``: the port's blob plane on
    ``device`` (``"cpu"``: kernel A's plain version; None: the card) with
    engine ``cuda``, the reference's on its host leg ``cpp``."""
    if name == "port":
        from cubefs_tpu_torch.blob import access, blobnode, clustermgr, sdk
        from cubefs_tpu_torch.fs import client, datanode, master, metanode
        from cubefs_tpu_torch.utils import rpc

        cfg, bn_cfg = dict(engine="cuda", device=device), dict(device=device)
    else:
        from cubefs_tpu.blob import access, blobnode, clustermgr, sdk
        from cubefs_tpu.fs import client, datanode, master, metanode
        from cubefs_tpu.utils import rpc

        cfg, bn_cfg = dict(engine="cpp"), {}
    return types.SimpleNamespace(
        access=access, BlobNode=blobnode.BlobNode, ClusterMgr=clustermgr.ClusterMgr,
        BlobClient=sdk.BlobClient, FileSystem=client.FileSystem, DataNode=datanode.DataNode,
        Master=master.Master, MetaNode=metanode.MetaNode, rpc=rpc, access_cfg=cfg,
        blobnode_cfg=bn_cfg)


class TierStack:
    """One package's in-process gateway stack with its cold tier: a master,
    2 metanodes and 3 datanodes, a blob plane of 3 blobnodes x 4 disks
    (64 KiB blobs), a ``FileSystem`` built with ``CUBEFS_TIERING=1`` and a
    ``BlobClient``, and the ``ObjectNode`` over it."""

    def __init__(self, pkg, s3pkg, root, monkeypatch):
        self.pkg, self.s3pkg = pkg, s3pkg
        pool = self.pool = pkg.rpc.NodePool()
        m = pkg.Master(pool)
        pool.bind("master", m)
        self.nodes = []
        for i in range(2):
            node = pkg.MetaNode(i, addr=f"meta{i}", node_pool=pool)
            pool.bind(f"meta{i}", node)
            m.register_metanode(f"meta{i}")
            self.nodes.append(node)
        for i in range(3):
            node = pkg.DataNode(i, str(root / f"d{i}"), f"data{i}", pool)
            pool.bind(f"data{i}", node)
            m.register_datanode(f"data{i}")
            self.nodes.append(node)
        self.view = m.create_volume("s3tier", mp_count=1, dp_count=2)
        cm = pkg.ClusterMgr(allow_colocated_units=True)
        self.blobnodes = {}
        for i in range(3):
            bn = pkg.BlobNode(i, [str(root / f"bn{i}d{d}") for d in range(4)],
                              pkg.rpc.Client(cm), addr=f"bn{i}", **pkg.blobnode_cfg)
            bn.register()
            bn.send_heartbeat()
            pool.bind(f"bn{i}", bn)
            self.blobnodes[f"bn{i}"] = bn
        self.blob = pkg.BlobClient(pkg.rpc.Client(cm), pool,
                                   pkg.access.AccessConfig(blob_size=64 << 10, **pkg.access_cfg))
        monkeypatch.setenv("CUBEFS_TIERING", "1")
        self.fs = pkg.FileSystem(self.view, pool, blob_client=self.blob)
        monkeypatch.delenv("CUBEFS_TIERING")
        assert self.fs.tiering is not None
        self.s3 = gateway(s3pkg, self.fs, "s3tier")
        self.url = f"http://{self.s3.addr}/bkt"

    def shards(self, loc) -> dict:
        """Every shard of every blob of a location, read off the blobnodes."""
        h, out = self.blob._h, {}
        for sl in loc["slices"]:
            vol = h.cm.call("get_volume", {"vid": sl["vid"]})[0]["volume"]
            for bid in range(sl["min_bid"], sl["min_bid"] + sl["count"]):
                for idx, u in enumerate(vol["units"]):
                    bn = self.blobnodes[u["node_addr"]]
                    out[(sl["vid"], bid, idx)] = bytes(
                        bn.get_shard(u["disk_id"], u["chunk_id"], bid)[0])
        return out

    def stop(self):
        self.s3.stop()
        for n in self.nodes:
            n.stop()


def tier_through_gateway(st: TierStack, objects: dict) -> dict:
    """PUT ``objects`` and the ``Transition`` rule through the gateway, age
    the ``cold/`` objects two days, adopt the rule from the bucket and
    scan once; then cold GETs, healthy and with every disk of the
    blobnode holding the most units broken, and what a gateway over a
    ``FileSystem`` with no blob client (the role's) answers. Kernel A's
    launches (the port's count: only the card's launches add to it) are
    recorded for the scan and for the degraded GETs."""
    for key, data in objects.items():
        assert call("PUT", f"{st.url}/{key}", data)[0] == 200
    assert call("PUT", f"{st.url}?lifecycle", LIFECYCLE)[0] == 200
    cold = sorted(k for k in objects if k.startswith("cold/"))
    for key in cold:
        st.fs.meta.set_attr(st.fs.resolve(f"/{key}"), mtime=time.time() - 2 * 86400)
    lc = st.s3pkg.LcNode(st.fs, engine=st.fs.tiering)
    out = {"rules": lc.load_rules_from_bucket()}
    a0 = _build.LAUNCHES["gf_apply"]
    rep = lc.scan_once()
    out.update(transitioned=rep.transitioned, errors=rep.errors,
               migrate_launches=_build.LAUNCHES["gf_apply"] - a0)
    inodes = {k: st.fs.meta.inode_get(st.fs.resolve(f"/{k}")) for k in objects}
    out["extents_left"] = {k: bool(i["extents"]) for k, i in inodes.items()}
    locs = {k: json.loads(inodes[k]["xattr"]["cold.location"]) for k in cold}
    out["locations"] = locs
    out["shards"] = {k: st.shards(loc) for k, loc in locs.items()}

    def gets(url):
        return {k: call("GET", f"{url}/{k}")[:2] for k in objects} | {
            f"{k}@range": call("GET", f"{url}/{k}", headers={"range": "bytes=70000-140001"})[:2]
            for k in cold}
    out["healthy"] = gets(st.url)
    units = {}
    for loc in locs.values():
        for sl in loc["slices"]:
            vol = st.blob._h.cm.call("get_volume", {"vid": sl["vid"]})[0]["volume"]
            for u in vol["units"]:
                units.setdefault(u["node_addr"], set()).add(u["disk_id"])
    down = max(sorted(units), key=lambda a: len(units[a]))
    for disk in units[down]:
        st.blobnodes[down].break_disk(disk)
    out["down"] = down
    out["lost_data_units"] = sum(  # blobs that lost a data unit: each decodes
        sl["count"] for loc in locs.values() for sl in loc["slices"]
        if any(u["node_addr"] == down and i < cm.tactic(cm.CodeMode(loc["codemode"])).n
               for i, u in enumerate(st.blob._h.cm.call(
                   "get_volume", {"vid": sl["vid"]})[0]["volume"]["units"])))
    a0 = _build.LAUNCHES["gf_apply"]
    out["degraded"] = gets(st.url)
    out["degraded_launches"] = _build.LAUNCHES["gf_apply"] - a0
    plain = st.pkg.FileSystem(st.view, st.pool)  # the objectnode role's client
    assert plain.tiering is None
    role = gateway(st.s3pkg, plain, "s3tier")
    try:
        out["role"] = {k: call("GET", f"http://{role.addr}/bkt/{k}")[:2] for k in cold}
    finally:
        role.stop()
    return out


def test_twin_migration_through_the_gateway_and_the_shared_limit(s3ref, tmp_path, monkeypatch):
    """The same objects and rule through each package's gateway stack:
    equal locations and shards on every unit of every stripe, cold GETs
    (whole and ranged) equal to the hot bytes healthy and with a
    blobnode's disks broken; and both packages' role-built gateways
    answer a tiered object with 200 and its size in zero bytes."""
    from cubefs_tpu.codec import engine as ref_engine

    monkeypatch.setattr(ref_engine, "_policy", [[1 << 62, "cpp"]])
    sizes = {"cold/a.bin": 300_001, "cold/deep/b.bin": 200_000, "hot/c.bin": 99_999}
    objects = dict(zip(sizes, payloads(9, list(sizes.values()))))
    out = {}
    for name, s3pkg in (("port", PORT_S3), ("ref", s3ref)):
        st = TierStack(tier_pkg(name), s3pkg, tmp_path / name, monkeypatch)
        try:
            out[name] = tier_through_gateway(st, objects)
        finally:
            st.stop()
    port, ref_out = out["port"], out["ref"]
    assert port == ref_out
    assert port["rules"] == 1 and port["transitioned"] == 2 and not port["errors"]
    assert port["lost_data_units"] > 0  # the degraded GETs decode
    assert port["extents_left"] == {"cold/a.bin": False, "cold/deep/b.bin": False,
                                    "hot/c.bin": True}
    want = {k: (200, v) for k, v in objects.items()} | {
        f"{k}@range": (206, objects[k][70_000:140_002]) for k in sizes if k.startswith("cold/")}
    assert port["healthy"] == want and port["degraded"] == want
    assert port["role"] == {k: (200, bytes(sizes[k])) for k in sizes if k.startswith("cold/")}
