"""The port's console (``cubefs_tpu_torch/fs/console.py``) and the
launcher's ``fsgateway`` and ``console`` roles held against the
reference's on the CPU:

- ``tests/test_tools.py``'s ``test_console_dashboard`` and
  ``test_deploy_cluster_launcher`` run on the port (``port_copy``): the
  launcher starts a master, a metanode, two datanodes, the fsgateway and
  the console, each a ``python -m cubefs_tpu_torch.cmd`` process; the
  port's C library reads a file through the gateway, and the console's
  ``/api/nodes`` counts the datanodes;
- a console of each package over the same master (on real HTTP): the same
  ``/api/nodes``, ``/api/state``, ``/api/volumes`` and dashboard page, the
  same GraphQL answers (queries, an admin's mutations, a non-admin's
  refusal, malformed and unknown fields) and the same login refusals.

Tolerance: exact.
"""

import json
import types
import urllib.error
import urllib.request

import pytest

from cubefs_tpu_torch.fs.console import Console
from cubefs_tpu_torch.runtime import nativeclient
from cubefs_tpu_torch.sdk import ConsoleClient
from test_torch_fs import run_in
from test_torch_raft import port_copy

TOOLS = port_copy("test_tools", rt=types.SimpleNamespace(load=nativeclient.load,
                                                         build=nativeclient.build))
SCENARIOS = ["test_console_dashboard", "test_deploy_cluster_launcher"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_reference_tools_scenario_on_the_port(name, request):
    run_in(TOOLS, name, request)


@pytest.fixture
def master_over_http(tmp_path):
    """A port master with 2 metanodes and 3 datanodes, served over HTTP,
    a root admin and a plain user."""
    from cubefs_tpu_torch.fs.datanode import DataNode
    from cubefs_tpu_torch.fs.master import Master
    from cubefs_tpu_torch.fs.metanode import MetaNode
    from cubefs_tpu_torch.utils import rpc

    pool = rpc.NodePool()
    master = Master(pool)
    pool.bind("master", master)
    nodes = []
    for i in range(2):
        n = MetaNode(i, addr=f"cm{i}", node_pool=pool)
        pool.bind(f"cm{i}", n)
        master.register_metanode(f"cm{i}")
        nodes.append(n)
    for i in range(3):
        d = DataNode(i, str(tmp_path / f"cd{i}"), f"cd{i}", pool)
        pool.bind(f"cd{i}", d)
        master.register_datanode(f"cd{i}")
        nodes.append(d)
    master.create_volume("convol", mp_count=1, dp_count=2)
    srv = rpc.RpcServer(rpc.expose(master), service="master").start()
    users = {"root": master.create_user("root"), "bob": master.create_user("bob")}
    yield srv.addr, users
    srv.stop()
    for n in nodes:
        n.stop()


def _get(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
        return r.status, r.read()


def _post(addr, path, obj, token=None):
    req = urllib.request.Request(f"http://{addr}{path}", data=json.dumps(obj).encode(),
                                 method="POST", headers={"Content-Type": "application/json",
                                                         **({"X-Console-Token": token}
                                                            if token else {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _reads(addr, users):
    """Everything one console answers without changing the cluster."""
    out = [(path, _get(addr, path)) for path in ("/", "/api/nodes", "/api/state",
                                                 "/api/volumes", "/api/tasks")]
    root, bob = users["root"], users["bob"]
    out.append(("login-unknown", _post(addr, "/api/login",
                                       {"access_key": "nope", "secret_key": "x"})))
    out.append(("login-bad", _post(addr, "/api/login",
                                   {"access_key": root["access_key"], "secret_key": "wrong"})))
    out.append(("no-token", _post(addr, "/api/graphql", {"query": "query { users }"})))
    out.append(("bad-token", _post(addr, "/api/graphql", {"query": "query { users }"}, "x")))
    out.append(("no-endpoint", _post(addr, "/api/nope", {})))
    admin, plain = ConsoleClient(addr), ConsoleClient(addr)
    admin.login(root["access_key"], root["secret_key"])
    plain.login(bob["access_key"], bob["secret_key"])
    for q in ("query { users }", "query { nodes }", "query { volumes }", "query { clusterStat }",
              "query { nodes { datanodes } }", "query { bogusField }", "not graphql",
              "mutation { grant(ak: $a, volume: \"convol\") { ok } }"):
        out.append((q, _post(addr, "/api/graphql", {"query": q}, admin._token)))
    out.append(("plain-mutation", _post(addr, "/api/graphql", {
        "query": "mutation { createUser(userId: \"x\") }"}, plain._token)))
    out.append(("plain-query", _post(addr, "/api/graphql", {"query": "query { users }"},
                                     plain._token)))
    return out


def _writes(addr, users, tag):
    """An admin's mutations through one console, its objects named by
    ``tag``; the answers with the tag taken out."""
    admin = ConsoleClient(addr)
    admin.login(users["root"]["access_key"], users["root"]["secret_key"])
    vol = admin.create_volume(f"{tag}vol", mp_count=1, dp_count=1)
    cred = admin.create_user(f"{tag}-carol")
    admin.grant(cred["access_key"], f"{tag}vol", "r")
    carol = admin.users()[cred["access_key"]]
    deleted = admin.graphql("mutation { deleteUser(ak: $a) { ok } }", {"a": cred["access_key"]})
    return (sorted(vol), vol["name"] == f"{tag}vol", len(vol["dps"]), sorted(cred),
            cred["user_id"] == f"{tag}-carol", carol["volumes"] == {f"{tag}vol": "r"},
            sorted(carol), deleted, cred["access_key"] in admin.users())


def test_each_console_over_the_same_master(master_over_http):
    from cubefs_tpu.fs.console import Console as RefConsole

    master, users = master_over_http
    port, ref = Console(master_addr=master).start(), RefConsole(master_addr=master).start()
    try:
        before = _reads(port.addr, users)
        assert _reads(ref.addr, users) == before
        assert _writes(port.addr, users, "p") == _writes(ref.addr, users, "r")
        after = _reads(port.addr, users)
        assert _reads(ref.addr, users) == after != before
        nodes = dict(before)["/api/nodes"]
        assert nodes[0] == 200 and len(json.loads(nodes[1])["datanodes"]) == 3
        assert dict(after)["query { bogusField }"] == (200, {"errors": ["unknown field 'bogusField'"]})
        assert dict(after)["plain-mutation"][0] == 403
    finally:
        port.stop()
        ref.stop()
