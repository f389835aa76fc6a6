"""Typed service clients (the reference's sdk/master, blobstore/api
analog): every admin/data surface as a concrete Python API over the RPC
wire, instead of hand-rolled method-name strings at call sites.
The port's copy of ``cubefs_tpu/sdk``."""

from .clients import (AccessClient, AuthClient, ClusterMgrClient,
                      ConsoleClient, FlashClient, FlashGroupClient,
                      MasterClient, MetaNodeClient, SchedulerClient,
                      WireClient)

__all__ = ["MasterClient", "SchedulerClient", "ClusterMgrClient",
           "MetaNodeClient", "WireClient",
           "AccessClient", "AuthClient", "FlashClient", "FlashGroupClient",
           "ConsoleClient"]
