"""Role launcher of the port's server.

The port's counterpart of ``cubefs_tpu/cmd.py`` for the one role it
carries, ``codec`` (the codec sidecar, ``codec/service.py``):

    python -m cubefs_tpu_torch.cmd -c config.json

Config keys (JSON):
  role:         codec
  listen_host / listen_port: bind address (port 0: an ephemeral port)
  ec_engine:    the codec engine (codec/engine.py): cuda (the default),
                numpy, cpp, numpy-xor, cpp-xor or auto, which loads the
                persisted crossover table; another name is a KeyError
  device:       the CUDA device (default: the current one), or "cpu" to
                run the kernels' plain versions

It prints ``[codec] listening on host:port`` once it serves, and on
SIGTERM or SIGINT stops the server and exits 0.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading


def run_role(cfg: dict):
    """Build and start the role's service; returns (server, service)."""
    role = cfg.get("role")
    if role != "codec":
        raise SystemExit(f"unknown role {role!r}")
    from .codec.service import CodecService
    from .utils import rpc

    svc = CodecService(engine=cfg.get("ec_engine", "cuda"), device=cfg.get("device"))
    srv = rpc.RpcServer(rpc.expose(svc), host=cfg.get("listen_host", "127.0.0.1"),
                        port=int(cfg.get("listen_port", 0))).start()
    print(f"[{role}] listening on {srv.addr}", flush=True)
    return srv, svc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-server")
    ap.add_argument("-c", "--config", required=True, help="JSON config file")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    srv, _ = run_role(cfg)
    stop.wait()
    print(f"[{cfg['role']}] shutting down", flush=True)
    srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
