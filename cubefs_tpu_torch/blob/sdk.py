"""Embedded blobstore SDK: the blob plane without an access deployment.

Role parity: blobstore/sdk — applications embed the access-layer logic
(code-mode selection, split, encode, quorum write, hedged read,
degraded reconstruct) directly in-process, talking straight to
clustermgr and blobnodes. `BlobClient` wraps AccessHandler with
location (de)serialization, so a consumer needs only the clustermgr
address and a node pool.

QoS shed (429) surfaces here as client backoff: the SDK retries
through a `RetryPolicy`, honoring the gate's retry-after hint, so a
throttled tenant degrades to slower progress instead of hard errors.

The port's copy of ``cubefs_tpu/blob/sdk.py``. Its ``AccessHandler`` runs
the codec on the card unless the ``cfg``'s ``device`` is ``"cpu"`` (the
plain versions); without a card and without that, it raises.
"""

from __future__ import annotations

from ..utils import qos, rpc
from ..utils.retry import RetryPolicy
from .access import AccessConfig, AccessHandler
from .types import Location


class BlobClient:
    """In-process blob put/get/delete (the embedded access client)."""

    def __init__(self, clustermgr, node_pool, cfg: AccessConfig | None = None,
                 proxy=None, client_az: str | None = None,
                 tenant: str | None = None,
                 throttle_policy: RetryPolicy | None = None):
        cm_client = (clustermgr if isinstance(clustermgr, rpc.Client)
                     else rpc.Client(clustermgr))
        proxy_client = (None if proxy is None else
                        proxy if isinstance(proxy, rpc.Client)
                        else rpc.Client(proxy))
        if client_az is not None:
            # embedded clients declare their AZ so degraded LRC reads
            # prefer the local stripe (blob/topology.py contract)
            cfg = cfg or AccessConfig()
            cfg.client_az = client_az
        self.tenant = tenant
        # 429 backoff: a few shaped retries, then the shed propagates
        self._throttle_policy = throttle_policy or RetryPolicy(
            base=0.1, cap=2.0, max_retries=4, deadline=10.0)
        self._h = AccessHandler(cm_client, node_pool, cfg,
                                proxy_client=proxy_client)

    def _shaped(self, op, *args, **kw):
        r = self._throttle_policy.start(op.__name__)
        while True:
            try:
                return op(*args, **kw)
            except qos.QosRejected:
                if not r.tick(reason="throttled"):
                    raise
            except rpc.RpcError as e:
                if e.code != 429 or not r.tick(reason="throttled"):
                    raise

    def put(self, data: bytes, codemode: int | None = None,
            priority: int | None = None) -> dict:
        """Store bytes; returns a JSON-serializable location. Background
        callers (cold-tier migration) pass priority=qos.SCRUB so the
        gate sheds them first under brownout — they can never starve
        foreground traffic."""
        return self._shaped(self._h.put, data, codemode,
                            tenant=self.tenant,
                            priority=priority).to_dict()

    def get(self, location: dict, priority: int | None = None) -> bytes:
        return self._shaped(self._h.get, Location.from_dict(location),
                            tenant=self.tenant, priority=priority)

    def delete(self, location: dict, priority: int | None = None) -> None:
        self._shaped(self._h.delete, Location.from_dict(location),
                     tenant=self.tenant, priority=priority)
