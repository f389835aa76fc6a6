"""The blob, raft and rpc scenarios of ``tests/test_chaos.py`` on the port.

Each scenario is the reference's source with every ``cubefs_tpu`` import
pointed at the port (``port_copy``); a blob scenario's cluster is the
port's in-process cluster of ``tests/test_torch_blob.py`` (``device=
"cpu"``, engine ``cuda``: the device path on the plain version) where the
reference builds its own. The file-system plane's scenarios run on the
port's metanode and datanode, the flash-tier drill on the port's
``fs/remotecache.py``, and the AZ blackout on the port's copy of
``tests/test_blob_topology.py``'s ``AZCluster`` (``device="cpu"``), the
dial prober's failed legs on the port's ``blob/dial.py`` and the
noisy-neighbor QoS drill on the port's ``tool/loadgen.py``.
"""

import pytest

from cubefs_tpu_torch.utils import faultinject as fi
from cubefs_tpu_torch.utils import rpc
from test_torch_blob import PORT, Cluster, _isolated  # noqa: F401  (autouse fixture)
from test_torch_blob_topology import BLOB_TOPOLOGY
from test_torch_raft import port_copy, run_scenario

CHAOS = port_copy("test_chaos", Cluster=lambda root, **kw: Cluster(PORT, root, engine="cuda",
                                                                   **kw),
                  AZCluster=BLOB_TOPOLOGY.AZCluster, LRC=BLOB_TOPOLOGY.LRC)
SCENARIOS = {  # the reference's scenarios whose modules the port holds
    "test_no_plan_means_no_hook_and_shared_null_sender",
    "test_blob_put_alloc_bids_exactly_once",
    "test_raft_leader_isolated_mid_write_no_double_apply",
    "test_replica_failover_breaker_opens_and_recovers",
    "test_call_replicas_probes_when_every_breaker_is_open",
    "test_access_get_reconstructs_through_brownout",
    "test_plan_disk_fault_composes_with_transport_fault",
    "test_msr_repair_helper_death_falls_back_exactly_once",
    "test_msr_repair_verify_mismatch_falls_back",
    "test_http_stale_keepalive_and_crc_corruption",
    "test_injected_delay_uses_fake_clock_no_wall_sleep",
    "test_same_seed_reproduces_schedule_byte_for_byte",
    "test_faultinject_demo_smoke",
    "test_pipelined_leader_kill_resolves_every_waiter_once",
    "test_pipelined_follower_partition_drains_inflight",
    # the file-system plane's dedup doors and group commit
    "test_alloc_ino_exactly_once_under_duplicate_and_drop_after",
    "test_alloc_extent_exactly_once_under_duplicate",
    "test_raft_leader_killed_mid_batch_no_partial_apply",
    # the failure-domain topology and the flash read tier
    "test_single_az_blackout_serves_reads_then_rebalances_home",
    "test_flashnode_death_and_az_blackout_reads_stay_exact",
    # the operator tools: the dial prober and the traffic model
    "test_dial_prober_records_failed_legs",
    "test_noisy_neighbor_brownout_drill_is_reproducible",
}


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    assert rpc._fault is None, "a previous test leaked an installed plan"
    yield
    fi.uninstall()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reference_chaos_scenario_on_the_port(name, request):
    run_scenario(CHAOS, name, request)
