"""The port's FUSE mount (``cubefs_tpu_torch/fs/fuse.py``: the raw
``/dev/fuse`` ABI at minor 31, ``mount(2)`` through ctypes) held against
the reference's on the CPU, through the kernel:

- every scenario of ``tests/test_fuse.py`` runs on the port
  (``port_copy``, its ``FsCluster`` the port's);
- the POSIX battery of ``test_fuse.py::test_posix_stress_battery``,
  widened with the errnos, runs through a mount of each package's
  volume: the same ``stat`` fields, listings, bytes and errnos, and the
  same namespace through each package's SDK afterwards;
- a tiered file read through a mount of a ``FileSystem`` with the cold
  tier: the port's mount serves its bytes from the blob plane, the
  reference's answers zeros (ROADMAP.md §3).

No test may hang the suite on a stale mount. Each runs under
``fuse_guard``: every mount made through ``fuse.mount`` is detached
(``MNT_DETACH``) and its device closed when the test ends, and by a
watchdog if the test outlives its deadline, which aborts the connection
so that a call blocked on the mount returns ``ENOTCONN`` and the test
fails; the battery runs in a child process under ``timeout=``. A test
fails if the watchdog fired or a mount under its directory is left in
``/proc/mounts``. Tolerance: exact.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading

import pytest

from cubefs_tpu_torch.fs import fuse
from test_torch_fs import FS_E2E, _port_qos_still, run_in  # noqa: F401  (autouse fixture)
from test_torch_raft import port_copy, scenarios

pytestmark = pytest.mark.skipif(
    not os.path.exists("/dev/fuse") or os.geteuid() != 0,
    reason="needs /dev/fuse and root",
)

FUSE = port_copy("test_fuse", FsCluster=FS_E2E.FsCluster)
DEADLINE_S = 120.0


def _mounts_under(root) -> list[str]:
    root = os.path.abspath(str(root))
    with open("/proc/mounts") as f:
        return [ln for ln in f if ln.split()[1].startswith(root)]


@contextlib.contextmanager
def fuse_guard(root, *modules, deadline=DEADLINE_S):
    """Track every mount made through ``fuse.mount`` of each of
    ``modules`` (the port's by default), detach them all when the block
    ends or when ``deadline`` s have passed, and fail if the watchdog
    fired or a mount under ``root`` is left."""
    mounts, fired = [], threading.Event()
    saved = []
    for mod in modules or (fuse,):
        real = mod.mount

        def tracked(fs, mountpoint, real=real):
            m = real(fs, mountpoint)
            mounts.append(m)
            return m

        saved.append((mod, real))
        mod.mount = tracked

    def detach():
        fired.set()
        for m in list(mounts):
            m.unmount()

    watchdog = threading.Timer(deadline, detach)
    watchdog.daemon = True
    watchdog.start()
    try:
        yield mounts
    finally:
        watchdog.cancel()
        for mod, real in saved:
            mod.mount = real
        for m in mounts:
            m.unmount()
        assert not fired.is_set(), f"a FUSE test outlived {deadline} s; its mounts were detached"
        assert not _mounts_under(root), _mounts_under(root)


def wait_mounted(mnt, timeout=10.0):
    """Wait for the kernel's INIT handshake: a listing in a child process
    that answers."""
    subprocess.run([sys.executable, "-c", f"import os; os.listdir({mnt!r})"],
                   check=True, timeout=timeout)


@pytest.mark.parametrize("name", scenarios(FUSE))
def test_reference_fuse_scenario_on_the_port(name, request, tmp_path):
    with fuse_guard(tmp_path):
        run_in(FUSE, name, request)


def test_every_scenario_runs():
    assert len(scenarios(FUSE)) == 9


# ---------------- one battery through a mount of each package ----------------

BATTERY = r'''
import concurrent.futures as cf, ctypes, errno, json, os, random, shutil, stat, subprocess, sys

mnt = sys.argv[1]
out = {"errnos": {}}

def err(what, fn, *a):
    try:
        fn(*a)
        out["errnos"][what] = 0
    except OSError as e:
        out["errnos"][what] = e.errno

def st(p):
    s = os.lstat(p)
    return [stat.S_IFMT(s.st_mode), stat.S_IMODE(s.st_mode), s.st_size, s.st_nlink,
            s.st_uid, s.st_gid]

deep = mnt
for i in range(12):
    deep = f"{deep}/d{i}"
    os.mkdir(deep)
with open(f"{deep}/leaf.txt", "w") as f:
    f.write("deep")
os.mkdir(f"{mnt}/many")
payloads = {i: random.Random(i).randbytes(2_000 + i) for i in range(64)}

def mk(i):
    with open(f"{mnt}/many/f{i:03d}", "wb") as f:
        f.write(payloads[i])

with cf.ThreadPoolExecutor(8) as ex:
    list(ex.map(mk, range(64)))
out["many"] = sorted(os.listdir(f"{mnt}/many"))
out["bytes_equal"] = all(open(f"{mnt}/many/f{i:03d}", "rb").read() == p
                         for i, p in payloads.items())
with open(f"{mnt}/many/f000", "r+b") as f:
    f.seek(100)
    f.write(b"PATCHED!")
out["patched"] = open(f"{mnt}/many/f000", "rb").read().hex()
os.chmod(f"{mnt}/many/f001", 0o600)
os.truncate(f"{mnt}/many/f002", 10)
os.symlink("many/f003", f"{mnt}/link")
os.rename(f"{mnt}/many/f004", f"{mnt}/moved")
shutil.copy(f"{mnt}/many/f005", f"{mnt}/copied")
os.setxattr(f"{mnt}/copied", "user.k", b"v")
out["xattrs"] = sorted(os.listxattr(f"{mnt}/copied"))
out["xattr"] = os.getxattr(f"{mnt}/copied", "user.k").decode()
out["stat"] = {p: st(f"{mnt}/{p}") for p in
               ("many", "many/f000", "many/f001", "many/f002", "link", "moved", "copied",
                "d0", deep[len(mnt) + 1:] + "/leaf.txt")}
out["readlink"] = os.readlink(f"{mnt}/link")
out["root"] = sorted(os.listdir(mnt))
out["ls"] = subprocess.run(["ls", "-1", mnt], capture_output=True, text=True).stdout
err("open-missing", open, f"{mnt}/nope")
err("mkdir-existing", os.mkdir, f"{mnt}/many")
err("rmdir-nonempty", os.rmdir, f"{mnt}/many")
err("unlink-dir", os.unlink, f"{mnt}/many")
err("open-through-file", open, f"{mnt}/moved/x")
err("listdir-file", os.listdir, f"{mnt}/moved")
err("removexattr-missing", os.removexattr, f"{mnt}/copied", "user.none")
err("readlink-file", os.readlink, f"{mnt}/moved")
libc = ctypes.CDLL(None, use_errno=True)
for what, flag in (("rename-noreplace", 1), ("rename-exchange", 2)):
    rc = libc.renameat2(-100, f"{mnt}/moved".encode(), -100, f"{mnt}/copied".encode(), flag)
    out["errnos"][what] = ctypes.get_errno() if rc else 0
subprocess.run(["rm", "-r", f"{mnt}/many"], check=True)
out["after_rm"] = sorted(os.listdir(mnt))
print(json.dumps(out))
'''


def _mounted_volume(pkg, root):
    """A volume of package ``pkg`` (its ``test_fs_e2e.FsCluster``) mounted
    at ``root/mnt`` by that package's ``fuse.mount``."""
    if pkg == "port":
        cluster_cls, mount = FS_E2E.FsCluster, fuse.mount
    else:
        from test_fs_e2e import FsCluster as cluster_cls

        from cubefs_tpu.fs import fuse as ref_fuse

        mount = ref_fuse.mount
    c = cluster_cls(root)
    mnt = str(root / "mnt")
    mount(c.fs, mnt)
    wait_mounted(mnt)
    return c, mnt


def test_posix_battery_equal_through_either_package(tmp_path):
    from cubefs_tpu.fs import fuse as ref_fuse

    got, clusters = {}, []
    with fuse_guard(tmp_path, fuse, ref_fuse):
        try:
            for pkg in ("port", "ref"):
                (tmp_path / pkg).mkdir()
                c, mnt = _mounted_volume(pkg, tmp_path / pkg)
                clusters.append(c)
                run = subprocess.run([sys.executable, "-c", BATTERY, mnt], capture_output=True,
                                     text=True, timeout=DEADLINE_S)
                assert run.returncode == 0, run.stderr
                got[pkg] = json.loads(run.stdout)
                got[pkg]["sdk_root"] = sorted(c.fs.readdir("/"))
                got[pkg]["sdk_moved"] = c.fs.read_file("/moved").hex()
        finally:
            for c in clusters:
                c.stop()
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port["bytes_equal"] and len(port["many"]) == 64
    assert port["errnos"] == {"open-missing": 2, "mkdir-existing": 17, "rmdir-nonempty": 39,
                              "unlink-dir": 21, "open-through-file": 20, "listdir-file": 20,
                              "removexattr-missing": 61, "readlink-file": 22,
                              "rename-noreplace": 17, "rename-exchange": 22}
    assert port["after_rm"] == port["sdk_root"] == ["copied", "d0", "link", "moved"]


# ---------------- a tiered file through the mount ----------------

def test_tiered_file_reads_cold_through_the_port_mount(tmp_path, monkeypatch):
    """A file tiered into the blob plane, read through a mount of a
    ``FileSystem`` with the cold tier: the port's mount serves its bytes
    from the blob plane (one object read for the whole sequential read,
    then another after the file is released and read again), where the
    reference's reads the released extents and answers zeros (ROADMAP.md
    §3). Both read the hot file beside it."""
    import hashlib

    import numpy as np

    import test_tiering as ref_tiering
    from cubefs_tpu.fs import fuse as ref_fuse
    from test_torch_tiering import TIERING

    data = np.random.default_rng(41).integers(0, 256, 5 * (64 << 10) + 777,
                                              dtype=np.uint8).tobytes()
    got, stops = {}, []
    with fuse_guard(tmp_path, fuse, ref_fuse):
        try:
            for pkg, mod, mount in (("port", TIERING, fuse.mount), ("ref", ref_tiering,
                                                                    ref_fuse.mount)):
                fs, _, _, engine, blob, metas, datas = mod._build_cluster(tmp_path, pkg)
                stops.append(metas + datas)
                fs.mkdir("/cold")
                mod._write_aged(fs, "/cold/f", data)
                fs.write_file("/hot", data[:1000])
                assert mod._lc(fs, engine).scan_once().transitioned == 1
                fs.tiering = engine  # the client's cold tier, as CUBEFS_TIERING=1 builds it
                gets = []
                real_get = blob.get
                blob.get = lambda loc, priority=None: gets.append(1) or real_get(loc, priority)
                mnt = str(tmp_path / pkg / "mnt")
                mount(fs, mnt)
                wait_mounted(mnt)
                reads = [subprocess.run(["sha256sum", f"{mnt}/cold/f", f"{mnt}/cold/f",
                                         f"{mnt}/hot"], capture_output=True, text=True,
                                        timeout=DEADLINE_S).stdout.split()[::2]]
                got[pkg] = (reads, len(gets))
        finally:
            for nodes in stops:
                for n in nodes:
                    n.stop()
    want_cold, zeros = hashlib.sha256(data).hexdigest(), hashlib.sha256(bytes(len(data))).hexdigest()
    hot = hashlib.sha256(data[:1000]).hexdigest()
    assert got["port"] == ([[want_cold, want_cold, hot]], 2)
    assert got["ref"] == ([[zeros, zeros, hot]], 0)


def test_big_writes_and_readahead_are_negotiated(tmp_path):
    """The port's INIT reply takes the kernel's readahead and the flags
    that make it honour ``max_write`` and ``max_pages`` (1 MiB): a 2 MiB
    copy in and out arrives in requests of many pages. The reference's sets
    neither, so the kernel sends it one 4 KiB page a request (ROADMAP.md
    §3). ``cp`` writes 128 KiB a call, which the port's mount takes
    whole. The bytes are the same through both."""
    import struct

    from cubefs_tpu.fs import fuse as ref_fuse

    data = os.urandom(2 << 20)
    src = tmp_path / "src.bin"
    src.write_bytes(data)
    got, clusters = {}, []
    with fuse_guard(tmp_path, fuse, ref_fuse) as mounts:
        try:
            for pkg in ("port", "ref"):
                (tmp_path / pkg).mkdir()
                c, mnt = _mounted_volume(pkg, tmp_path / pkg)
                clusters.append(c)
                m, sizes = mounts[-1], {16: [], 15: []}  # FUSE_WRITE, FUSE_READ
                real = m._dispatch

                def spy(req, real=real, sizes=sizes):
                    opcode = struct.unpack_from("<I", req, 4)[0]
                    if opcode in sizes:
                        sizes[opcode].append(struct.unpack_from("<I", req, 56)[0])
                    return real(req)

                m._dispatch = spy
                for argv in (["cp", str(src), f"{mnt}/x"], ["cp", f"{mnt}/x", str(tmp_path / pkg / "back")]):
                    subprocess.run(argv, check=True, timeout=DEADLINE_S)
                got[pkg] = (max(sizes[16]), len(sizes[16]), max(sizes[15]),
                            (tmp_path / pkg / "back").read_bytes() == data,
                            c.fs.read_file("/x") == data)
        finally:
            for c in clusters:
                c.stop()
    port, ref = got["port"], got["ref"]
    assert port[3:] == ref[3:] == (True, True)
    assert port[0] >= 128 << 10 and port[1] <= 16 and port[2] >= 128 << 10, port  # cp's writes
    assert ref[0] == ref[2] == 4096 and ref[1] == 512, ref
