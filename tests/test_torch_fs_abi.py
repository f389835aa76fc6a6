"""The port's native POSIX C ABI (``cubefs_tpu_torch/fs/fsgateway.py``
behind ``csrc/host/native_client.cc``) held against the reference's on
the CPU:

- every scenario of ``tests/test_fs_abi.py`` runs on the port
  (``port_copy``): ctypes round trips, ``open`` semantics, a refused
  mount, and ``tests/c/fs_abi_test.c`` compiled with gcc and linked
  against the port's library, printing ``fs_abi_test OK``;
- each package's library against each package's gateway: one battery of
  calls gives the same return codes, bytes, sizes, modes, types,
  listings and ``cfs_last_errno`` (ENOENT, EEXIST, ENOTDIR, EISDIR,
  ENOTEMPTY among them) on all four pairs.

Tolerance: exact.
"""

import ctypes
import importlib
import types

import pytest

from cubefs_tpu_torch.runtime import nativeclient
from test_torch_fs import run_in
from test_torch_raft import port_copy, scenarios

RT = types.SimpleNamespace(load=nativeclient.load, build=nativeclient.build)
FS_ABI = port_copy("test_fs_abi", rt=RT)


@pytest.mark.parametrize("name", scenarios(FS_ABI))
def test_reference_fs_abi_scenario_on_the_port(name, request):
    run_in(FS_ABI, name, request)


def test_every_scenario_runs():
    assert len(scenarios(FS_ABI)) == 5


# ---------------- each library against each package's gateway ----------------

def _gateway(pkg: str, root):
    """An ``FsGateway`` of package ``pkg`` over an in-process volume (a
    master, 2 metanodes, 3 datanodes, 2 meta and 2 data partitions),
    served over HTTP; returns (addr, stop)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    rpc = mod("utils.rpc")
    pool = rpc.NodePool()
    master = mod("fs.master").Master(pool)
    pool.bind("master", master)
    nodes = []
    for i in range(2):
        node = mod("fs.metanode").MetaNode(i, addr=f"meta{i}", node_pool=pool)
        pool.bind(f"meta{i}", node)
        master.register_metanode(f"meta{i}")
        nodes.append(node)
    for i in range(3):
        node = mod("fs.datanode").DataNode(i, str(root / f"{pkg}-d{i}"), f"data{i}", pool)
        pool.bind(f"data{i}", node)
        master.register_datanode(f"data{i}")
        nodes.append(node)
    view = master.create_volume("abivol", mp_count=2, dp_count=2)
    fs = mod("fs.client").FileSystem(view, pool)
    srv = rpc.RpcServer(rpc.expose(mod("fs.fsgateway").FsGateway(fs)), service="fsgw").start()

    def stop():
        srv.stop()
        for n in nodes:
            n.stop()

    return srv.addr, stop


@pytest.fixture
def gateways(tmp_path):
    made = {pkg: _gateway(pkg_mod, tmp_path) for pkg, pkg_mod in
            (("port", "cubefs_tpu_torch"), ("ref", "cubefs_tpu"))}
    yield {k: addr for k, (addr, _) in made.items()}
    for _, stop in made.values():
        stop()


@pytest.fixture(scope="module")
def libs():
    from cubefs_tpu.runtime import build as ref_build

    return {"port": nativeclient.load(), "ref": ref_build.load()}


O_WRONLY, O_CREAT, O_EXCL, O_TRUNC, O_APPEND = 0o1, 0o100, 0o200, 0o1000, 0o2000


def _battery(lib, addr: str, top: str) -> list:
    """One sequence of calls under ``top``; each entry is the call, its
    result and ``cfs_last_errno`` (and what it read)."""
    host, port = addr.rsplit(":", 1)
    h = lib.cfs_mount(host.encode(), int(port))
    assert h, lib.cfs_last_error()
    out = []

    def rec(what, rc, *extra):
        out.append((what, rc, lib.cfs_last_errno(), *extra))

    def stat(path):
        size, mode, typ, mtime = (ctypes.c_uint64(), ctypes.c_uint32(), ctypes.c_uint32(),
                                  ctypes.c_uint64())
        rc = lib.cfs_stat_path(h, path, ctypes.byref(size), ctypes.byref(mode),
                               ctypes.byref(typ), ctypes.byref(mtime))
        rec(("stat", path[len(t):]), rc, size.value, mode.value, typ.value, mtime.value > 0)

    def listing(path):
        buf = ctypes.create_string_buffer(4096)
        n = lib.cfs_readdir(h, path, buf, 4096)
        rec(("readdir", path[len(t):]), n, sorted(buf.value.split(b"\n")) if n > 0 else [])

    t = top.encode()
    try:
        rec("mkdirs", lib.cfs_mkdirs(h, t + b"/a/b"))
        rec("mkdirs-again", lib.cfs_mkdirs(h, t + b"/a/b"))
        fd = lib.cfs_open(h, t + b"/a/b/f", O_WRONLY | O_CREAT, 0o640)
        rec("create", fd >= 0)
        rec("write", lib.cfs_write(h, fd, b"0123456789" * 100, 1000))
        rec("pwrite", lib.cfs_pwrite(h, fd, b"XYZ", 3, 2000))
        rec("close", lib.cfs_close(h, fd))
        rec("close-again", lib.cfs_close(h, fd))
        stat(t + b"/a/b/f")
        stat(t + b"/a/b")
        fd = lib.cfs_open(h, t + b"/a/b/f", 0, 0)
        buf = ctypes.create_string_buffer(4096)
        n = lib.cfs_pread(h, fd, buf, 4096, 0)
        rec("pread", n, buf.raw[:max(n, 0)])
        rec("lseek-end", lib.cfs_lseek(h, fd, 0, 2))
        n = lib.cfs_read(h, fd, buf, 10)
        rec("read-at-eof", n)
        lib.cfs_close(h, fd)
        fd = lib.cfs_open(h, t + b"/a/b/f", O_WRONLY | O_APPEND, 0)
        rec("append", lib.cfs_write(h, fd, b"tail", 4))
        lib.cfs_close(h, fd)
        stat(t + b"/a/b/f")
        # the errnos
        rec("open-enoent", lib.cfs_open(h, t + b"/a/b/absent", 0, 0))
        rec("stat-enoent", lib.cfs_stat_path(h, t + b"/nope", None, None, None, None))
        rec("open-excl-eexist", lib.cfs_open(h, t + b"/a/b/f", O_WRONLY | O_CREAT | O_EXCL, 0o644))
        rec("stat-through-file", lib.cfs_stat_path(h, t + b"/a/b/f/x", None, None, None, None))
        rec("mkdirs-through-file", lib.cfs_mkdirs(h, t + b"/a/b/f/sub"))
        fd = lib.cfs_open(h, t + b"/a/b", 0, 0)
        rec("open-dir", fd >= 0)
        rec("read-dir-eisdir", lib.cfs_read(h, fd, buf, 4))
        lib.cfs_close(h, fd)
        rec("rmdir-enotempty", lib.cfs_rmdir(h, t + b"/a/b"))
        rec("rename-onto-nonempty-dir", lib.cfs_rename(h, t + b"/a/b/f", t + b"/a"))
        listing(t + b"/a/b")
        listing(t + b"/a/b/f")
        # rename, truncate, O_TRUNC, unlink
        fd = lib.cfs_open(h, t + b"/a/g", O_WRONLY | O_CREAT | O_EXCL, 0o600)
        rec("create-excl", fd >= 0)
        lib.cfs_close(h, fd)
        rec("rename", lib.cfs_rename(h, t + b"/a/b/f", t + b"/a/moved"))
        rec("rename-clobber", lib.cfs_rename(h, t + b"/a/moved", t + b"/a/g"))
        listing(t + b"/a")
        rec("truncate", lib.cfs_truncate(h, t + b"/a/g", 5))
        stat(t + b"/a/g")
        fd = lib.cfs_open(h, t + b"/a/g", O_WRONLY | O_TRUNC, 0)
        lib.cfs_close(h, fd)
        stat(t + b"/a/g")
        rec("unlink", lib.cfs_unlink(h, t + b"/a/g"))
        rec("unlink-enoent", lib.cfs_unlink(h, t + b"/a/g"))
        rec("rmdir", lib.cfs_rmdir(h, t + b"/a/b"))
        listing(t + b"/a")
    finally:
        lib.cfs_unmount(h)
    return out


def test_each_library_against_each_gateway(libs, gateways):
    runs = {(lname, gname): _battery(lib, addr, f"/{lname}")
            for lname, lib in libs.items() for gname, addr in gateways.items()}
    first = runs["port", "port"]
    for key, got in runs.items():
        assert got == first, key
    errnos = {what: err for what, rc, err, *_ in first}
    assert errnos["open-enoent"] == errnos["stat-enoent"] == errnos["unlink-enoent"] == 2
    # a path through a file resolves as missing in both packages
    assert errnos["stat-through-file"] == errnos["mkdirs-through-file"] == 2
    assert errnos["open-excl-eexist"] == errnos["mkdirs-again"] == 17
    assert errnos["readdir", b"/a/b/f"] == 20  # ENOTDIR
    assert errnos["read-dir-eisdir"] == errnos["rename-onto-nonempty-dir"] == 21
    assert errnos["rmdir-enotempty"] == 39
