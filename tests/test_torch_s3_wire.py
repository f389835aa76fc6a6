"""The S3 gateway's sockets (``cubefs_tpu_torch/fs/objectnode.py``) held
against the reference's on the CPU.

- Nagle's algorithm: a reply is two writes (headers, then body). The
  reference's gateway leaves Nagle on, so a body under one segment waits
  for the client's delayed ACK of the headers; the port's sets
  ``TCP_NODELAY`` and answers in a few milliseconds.
- The accept backlog: the reference's gateway listens with socketserver's
  backlog of 5, so in a burst of new connections the kernel drops the SYNs
  past the queue and each waits out a 1 s retransmit; the port's listens
  with 128. Held without timing: connections are opened while neither
  server accepts yet, and those whose handshake completed are counted.

Both gateways serve no bucket there: every request answers 404
``NoSuchBucket`` with an XML body.

- A listing across metadata leader changes: ``ListObjectsV2``'s walk makes
  one ``inode_get`` a key; right after a partition's leader changes (its
  leader cut off by ``faultinject`` until another is elected, then healed)
  the walk still ends in well under a second a page, in either package:
  no read waits out a deadline on the old leader.
- Each read goes to a partition's replicas in the view's order and
  follows the 421 redirect of every follower before the leader: with a
  follower first, every ``inode_get`` costs two round trips, in both
  packages (the client keeps no leader). ``ListObjectsV2``'s walk makes
  one a key, so a cluster whose root partition's leader is not first in
  that order lists at about half the speed.
"""

import http.client
import select
import socket
import statistics
import time

import threading

import pytest

from cubefs_tpu_torch.fs import objectnode as port_objectnode
from test_torch_fs import PORT, WireFs, _close, both, first_mkdir, ref, wait_for  # noqa: F401


@pytest.fixture(scope="module")
def gateways():
    from cubefs_tpu.fs import objectnode as ref_objectnode

    return {"port": port_objectnode.ObjectNode, "ref": ref_objectnode.ObjectNode}


def small_reply_ms(addr: str, n: int = 25) -> list[float]:
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    ms = []
    try:
        for _ in range(n):
            t = time.perf_counter()
            conn.request("GET", "/nobucket/key")
            resp = conn.getresponse()
            body = resp.read()
            ms.append((time.perf_counter() - t) * 1e3)
            assert resp.status == 404 and b"NoSuchBucket" in body
    finally:
        conn.close()
    return ms


def test_a_small_reply_does_not_wait_for_the_delayed_ack(gateways):
    medians = {}
    for name, cls in gateways.items():
        node = cls({}).start()
        try:
            medians[name] = statistics.median(small_reply_ms(node.addr)[5:])
            handler = node._httpd.RequestHandlerClass
            assert handler.disable_nagle_algorithm is (name == "port")
        finally:
            node.stop()
    assert medians["port"] * 3 < medians["ref"], medians


def established_within(addr: str, n: int, wait_s: float) -> tuple[int, list[socket.socket]]:
    """``n`` non-blocking connects; how many handshakes completed within
    ``wait_s`` (the socket turns writable)."""
    host, port = addr.rsplit(":", 1)
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.setblocking(False)
        assert s.connect_ex((host, int(port))) in (0, 115)  # EINPROGRESS
        socks.append(s)
    poll = select.poll()  # select() refuses descriptors past 1023
    by_fd = {s.fileno(): s for s in socks}
    for fd in by_fd:
        poll.register(fd, select.POLLOUT)
    done, deadline = set(), time.monotonic() + wait_s
    while len(done) < n and time.monotonic() < deadline:
        for fd, _ in poll.poll(max(0.0, deadline - time.monotonic()) * 1e3):
            poll.unregister(fd)
            if by_fd[fd].getsockopt(socket.SOL_SOCKET, socket.SO_ERROR) == 0:
                done.add(fd)
    return len(done), socks


def test_a_burst_of_new_connections_completes_every_handshake(gateways):
    n = 32
    got = {}
    for name, cls in gateways.items():
        node = cls({})  # listening, not yet accepting
        socks, started = [], False
        try:
            got[name], socks = established_within(node.addr, n, 0.5)
            assert node._httpd.request_queue_size == (128 if name == "port" else 5)
            if name == "port":
                assert got["port"] == n
                node.start()
                started = True
                for s in socks:  # every one is served
                    s.setblocking(True)
                    s.settimeout(30)
                    s.sendall(b"GET /nobucket/key HTTP/1.1\r\nHost: x\r\n\r\n")
                    assert s.recv(12) == b"HTTP/1.1 404"
        finally:
            for s in socks:
                s.close()
            if started:
                node.stop()
            else:  # stop() waits for a serve loop that never ran
                node._httpd.server_close()
    assert got["ref"] <= 8, got  # the queue of 5 (and the one the kernel adds)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_listing_right_after_a_leader_change_waits_out_no_deadline(pkg, ref, gateways,
                                                                     tmp_path):
    p = both(ref)[pkg]
    c = WireFs(p, tmp_path, n_meta=3, n_data=3)
    fs = p.FileSystem(c.view, p.rpc.NodePool())
    gw = gateways[pkg]({"bkt": fs})  # its walk, called here: no HTTP
    try:
        first_mkdir(fs, "/small")

        def put(i):
            for j in range(i, 240, 6):
                fs.write_file(f"/small/o{j:04d}", b"x" * 4096)
        threads = [threading.Thread(target=put, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        root_pid = c.view["mps"][0]["pid"]

        def leader():
            return next((m.addr for m in c.metas
                         if m.rafts[root_pid].status()["role"] == "leader"), None)
        for rnd in range(3):
            old = wait_for(leader, what="the root partition's leader")
            with p.faultinject.installed(p.faultinject.FaultPlan(seed=rnd).isolate(old)):
                wait_for(lambda: any(m.addr != old and m.rafts[root_pid].status()["role"]
                                     == "leader" for m in c.metas), what="a new leader")
            t = time.perf_counter()
            keys = [k for k, *_ in gw._list_objects(fs, "small/")]
            assert time.perf_counter() - t < 5.0
            assert keys == [f"small/o{j:04d}" for j in range(240)]
    finally:
        _close(fs)
        c.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_every_read_pays_a_redirect_at_each_follower_listed_first(pkg, ref, tmp_path):
    p = both(ref)[pkg]
    c = WireFs(p, tmp_path)
    fs = p.FileSystem(c.view, p.rpc.NodePool())
    try:
        first_mkdir(fs, "/d")
        ino = fs.resolve("/d")
        root_pid = c.view["mps"][0]["pid"]
        by_addr = {m.addr: m for m in c.metas}
        leader = next(m for m in c.metas if m.rafts[root_pid].status()["role"] == "leader")
        served = {}
        for first in (leader, *[m for m in c.metas if m is not leader]):
            order = [first.addr] + [a for a in c.view["mps"][0]["addrs"] if a != first.addr]
            view = dict(c.view, mps=[dict(c.view["mps"][0], addr=order[0], addrs=order),
                                     *c.view["mps"][1:]])
            client = p.FileSystem(view, p.rpc.NodePool())
            try:
                before = {a: m._native_lib.ms_op_count(m._native_h) for a, m in by_addr.items()}
                for _ in range(50):
                    assert client.meta.inode_get(ino)["type"] == "dir"
                served[first is leader] = {
                    a: m._native_lib.ms_op_count(m._native_h) - before[a]
                    for a, m in by_addr.items()}
            finally:
                _close(client)
        assert served[True] == {a: 50 if a == leader.addr else 0 for a in by_addr}
        assert served[False] == {a: 50 for a in by_addr}  # a 421 there, then the leader
    finally:
        _close(fs)
        c.stop()
