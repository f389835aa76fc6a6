"""Volume metadata snapshot tool (tool/snapshot analog).

Exports a point-in-time, CRC-verified archive of every meta partition's
FSM state (the same serialized shape raft snapshots use), and restores
it into a directory a standalone MetaPartition loads at boot — the
disaster-recovery path for the metadata plane.

Usage:
  python -m cubefs_tpu_torch.tool.snapshot export --master H:P --vol NAME --out DIR
  python -m cubefs_tpu_torch.tool.snapshot verify --dir DIR
  python -m cubefs_tpu_torch.tool.snapshot restore --dir DIR --data-dir META_DIR

The port's copy of ``cubefs_tpu/tool/snapshot.py``. The archive's format
is the reference's: either package's tool restores the other's export
into its own ``fs/metanode.MetaPartition``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

from ..utils import rpc


def export(master_addr: str, vol: str, out_dir: str, pool=None) -> dict:
    pool = pool or rpc.NodePool()
    view = pool.get(master_addr).call(
        "client_view", {"name": vol})[0]["volume"]
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"volume": vol, "mps": []}
    for mp in view["mps"]:
        meta, state = rpc.call_replicas(
            pool, mp.get("addrs") or [mp["addr"]], "export_state",
            {"pid": mp["pid"]}, deadline=10.0)
        crc = zlib.crc32(state)
        if meta.get("crc") != crc:
            raise RuntimeError(
                f"mp {mp['pid']}: state corrupted in transit "
                f"(crc {crc:#x} != {meta.get('crc'):#x})")
        fname = f"mp_{mp['pid']}.state"
        with open(os.path.join(out_dir, fname), "wb") as f:
            f.write(state)
        manifest["mps"].append({"pid": mp["pid"], "start": mp["start"],
                                "end": mp["end"], "file": fname,
                                "crc": crc, "apply_id": meta.get("apply_id")})
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def verify(snap_dir: str) -> dict:
    manifest = json.load(open(os.path.join(snap_dir, "manifest.json")))
    for mp in manifest["mps"]:
        raw = open(os.path.join(snap_dir, mp["file"]), "rb").read()
        if zlib.crc32(raw) != mp["crc"]:
            raise RuntimeError(f"mp {mp['pid']}: archive crc mismatch")
    return manifest


def restore(snap_dir: str, data_dir: str) -> list[int]:
    """Materialize each archived partition as a segmented on-disk
    checkpoint under data_dir/mp_<pid>/ — a standalone MetaPartition
    over that directory boots straight into the archived state."""
    from ..fs.metanode import MetaPartition

    manifest = verify(snap_dir)
    restored = []
    for mp in manifest["mps"]:
        raw = open(os.path.join(snap_dir, mp["file"]), "rb").read()
        pdir = os.path.join(data_dir, f"mp_{mp['pid']}")
        part = MetaPartition(mp["pid"], mp["start"], mp["end"],
                             data_dir=pdir)
        part.restore_state(raw)
        part.snapshot()  # persist as the on-disk checkpoint
        restored.append(mp["pid"])
    return restored


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-snapshot")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("export")
    p.add_argument("--master", required=True)
    p.add_argument("--vol", required=True)
    p.add_argument("--out", required=True)
    p = sub.add_parser("verify")
    p.add_argument("--dir", required=True)
    p = sub.add_parser("restore")
    p.add_argument("--dir", required=True)
    p.add_argument("--data-dir", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "export":
        m = export(args.master, args.vol, args.out)
        print(json.dumps(m, indent=2))
    elif args.cmd == "verify":
        print(json.dumps(verify(args.dir), indent=2))
    else:
        pids = restore(args.dir, args.data_dir)
        print(f"restored partitions: {pids}")


if __name__ == "__main__":
    sys.exit(main())
