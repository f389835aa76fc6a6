"""Automount helper (tool/autofs analog).

Reads an automount map — one `MOUNTPOINT VOLUME MASTER` line per entry,
'#' comments — and ensures every entry is mounted via the kernel FUSE
client, remounting entries whose mount died. `--check` parses and
resolves the map against the master without touching /dev/fuse (CI and
dry runs).

Usage:
  python -m cubefs_tpu_torch.tool.autofs --map /etc/cubefs.autofs [--check]

The port's copy of ``cubefs_tpu/tool/autofs.py``: the default mount is the
port's ``fs/fuse.mount``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils import rpc


def parse_map(path: str) -> list[dict]:
    entries = []
    for lineno, line in enumerate(open(path), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 3:
            raise ValueError(f"{path}:{lineno}: want 'MOUNTPOINT VOL MASTER'")
        entries.append({"mountpoint": parts[0], "vol": parts[1],
                        "master": parts[2]})
    return entries


def check(entries: list[dict], pool=None) -> list[dict]:
    """Resolve every entry's volume view (validates vol + master
    reachability) without mounting."""
    pool = pool or rpc.NodePool()
    out = []
    for e in entries:
        view = pool.get(e["master"]).call(
            "client_view", {"name": e["vol"]})[0]["volume"]
        out.append({**e, "mps": len(view["mps"]), "dps": len(view["dps"])})
    return out


def ensure_mounted(entries: list[dict], pool=None, mount_fn=None) -> list[dict]:
    """Mount every entry that is not already a live mount. mount_fn is
    injectable for tests; the default is the kernel FUSE client."""
    from ..fs.client import FileSystem

    pool = pool or rpc.NodePool()
    if mount_fn is None:
        from ..fs.fuse import mount as mount_fn  # pragma: no cover
    results = []
    for e in entries:
        if os.path.ismount(e["mountpoint"]):
            results.append({**e, "status": "already-mounted"})
            continue
        os.makedirs(e["mountpoint"], exist_ok=True)
        view = pool.get(e["master"]).call(
            "client_view", {"name": e["vol"]})[0]["volume"]
        fs = FileSystem(view, pool, master_addr=e["master"])
        mount_fn(fs, e["mountpoint"])
        results.append({**e, "status": "mounted"})
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-autofs")
    ap.add_argument("--map", required=True, help="automount map file")
    ap.add_argument("--check", action="store_true",
                    help="validate the map without mounting")
    args = ap.parse_args(argv)
    entries = parse_map(args.map)
    if args.check:
        print(json.dumps(check(entries), indent=2))
        return
    results = ensure_mounted(entries)
    print(json.dumps(results, indent=2), flush=True)
    if any(r["status"] == "mounted" for r in results):
        # the FUSE fds live in THIS process: exiting would kill every
        # mount just reported; block like automount daemons do
        import threading

        threading.Event().wait()


if __name__ == "__main__":
    sys.exit(main())
