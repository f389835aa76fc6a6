"""FS-plane failure-domain topology: the placement scorer for the master.

Role parity: master/topology.go + master/node_selector.go — the fs-plane
twin of blob/topology.py. The master's registries label every node with
AZ (``zone``) > rack; this module is the single authority for turning
those labels plus a load view into replica placements:

  * ``select_hosts``  — dp/mp replica spread: one-per-AZ when enough AZs
    exist, even spread when fewer, one nodeset otherwise
  * ``pick_destination`` — rebuild/migration target with an explicit AZ
    preference ladder (failed replica's AZ > un-colocated AZ > fresh
    rack > least load)
  * ``pick_leader``   — write-leadership rotation inside a replica set
  * ``misplacement``  — the colocation score the rate-limited sweep
    drives to zero (gauge contract: 0 == every dp honors one-per-AZ up
    to the cluster's labeled AZ count)

Everything here is a pure function over registry info dicts
(``addr -> {"zone": ..., "rack": ..., "hb": ...}``); the master owns the
locks and the commit door. The only sanctioned load sorts in the fs
control plane live in this file (lint: CFZ002).

The port's copy of ``cubefs_tpu/fs/topology.py``, with the same
placements.
"""

from __future__ import annotations

DEFAULT_ZONE = "default"


def az_of(info: dict) -> str:
    return info.get("zone") or DEFAULT_ZONE


def rack_of(info: dict) -> str:
    # an unlabeled rack is its own host: rack-spread degrades to
    # host-spread instead of treating all unlabeled nodes as colocated
    return info.get("rack") or info.get("addr", "")


def zones_of(reg: dict, addrs: list[str]) -> dict[str, list[str]]:
    zones: dict[str, list[str]] = {}
    for a in addrs:
        zones.setdefault(az_of(reg.get(a) or {}), []).append(a)
    return zones


def labeled_azs(reg: dict) -> list[str]:
    """Every AZ the registry knows about, including ones with no live
    node — a dark AZ still bounds the fair share the sweep scores
    against (same contract as blob cluster_misplacement)."""
    return sorted({az_of(i) for i in reg.values()})


def nodesets(members: list[str], size: int) -> list[list[str]]:
    """Chunk a zone's nodes into nodesets (failure domains),
    deterministically by address order."""
    members = sorted(members)
    return [members[i:i + size] for i in range(0, len(members), size)]


def order_by_load(addrs: list[str], load: dict) -> list[str]:
    """The only sanctioned load sort outside this module's selectors."""
    return sorted(addrs, key=lambda a: (load.get(a, 0), a))


# ---------------- pluggable node selectors (node_selector.go) ----------
def _select_least_load(cands: list[str], k: int, load: dict,
                       state: dict) -> list[str]:
    return order_by_load(cands, load)[:k]


def _select_round_robin(cands: list[str], k: int, load: dict,
                        state: dict) -> list[str]:
    cands = sorted(cands)
    start = state.get("rr", 0) % len(cands)
    state["rr"] = start + k
    return [cands[(start + i) % len(cands)] for i in range(k)]


def _select_carry_weight(cands: list[str], k: int, load: dict,
                         state: dict) -> list[str]:
    """CarryWeightNodeSelector analog: each node accumulates carry
    proportional to its headroom; the k highest carries win and pay 1."""
    carry = state.setdefault("carry", {})
    for a in cands:
        carry[a] = carry.get(a, 0.0) + 1.0 / (1.0 + load.get(a, 0))
    picks = sorted(cands, key=lambda a: (-carry.get(a, 0.0), a))[:k]
    for a in picks:
        carry[a] -= 1.0
    return picks


SELECTORS = {
    "least_load": _select_least_load,
    "round_robin": _select_round_robin,
    "carry_weight": _select_carry_weight,
}


# ---------------- replica-set placement ----------------
def select_hosts(reg: dict, live: list[str], k: int, load: dict,
                 pick, nodeset_size: int = 3) -> list[str]:
    """Topology-aware placement: one replica per zone when k zones
    exist (cross-AZ volumes); otherwise all replicas from one nodeset
    of the least-loaded zone (the reference keeps a partition's
    replicas inside one failure domain). ``pick`` is the master's
    pluggable selector (cands, k, load) -> picks."""
    zones = zones_of(reg, live)
    if len(zones) >= k > 1:
        zone_load = {z: sum(load.get(a, 0) for a in m)
                     for z, m in zones.items()}
        picked_zones = sorted(zones, key=lambda z: (zone_load[z], z))[:k]
        return [pick(zones[z], 1, load)[0] for z in picked_zones]
    if len(zones) > 1:
        # fewer zones than replicas: spread as evenly as possible —
        # an explicit colocation degrade, scored by misplacement below
        out: list[str] = []
        ordered = sorted(zones, key=lambda z: (-len(zones[z]), z))
        zi = 0
        while len(out) < k:
            z = ordered[zi % len(ordered)]
            remaining = [a for a in zones[z] if a not in out]
            if remaining:
                out.append(pick(remaining, 1, load)[0])
            zi += 1
            if zi > 4 * k:
                break
        return out
    members = next(iter(zones.values()))
    full = [ns for ns in nodesets(members, nodeset_size) if len(ns) >= k]
    if full:
        ns = min(full, key=lambda s: (sum(load.get(a, 0) for a in s), s[0]))
        return pick(ns, k, load)
    return pick(members, k, load)  # no full nodeset: whole zone


def pick_leader(picks: list[str], intra_load: dict | None) -> str:
    """Rotate write leadership: the replica carrying the fewest
    leaderships placed so far in this planning pass wins."""
    return min(picks, key=lambda a: (intra_load or {}).get(a, 0))


def pick_destination(reg: dict, cands: list[str], survivors: list[str],
                     *, prefer_az: str | None = None,
                     load: dict | None = None) -> str:
    """Rebuild/migration target selection (blob pick_destination's
    ladder, fs-shaped): among candidate addrs not already in the
    replica set, prefer — in order —

      1. the failed replica's AZ (``prefer_az``), keeping the dp's
         AZ footprint intact through a rebuild
      2. an AZ not already occupied by a surviving replica (colocation
         comes last, never first)
      3. a rack no survivor lives on
      4. least placement load, then address (deterministic)

    ``survivors`` are the replica addrs that remain after the failure.
    """
    if not cands:
        raise ValueError("no candidate destinations")
    load = load or {}
    surv_az_count: dict[str, int] = {}
    surv_racks = set()
    for a in survivors:
        info = reg.get(a) or {"addr": a}
        surv_az_count[az_of(info)] = surv_az_count.get(az_of(info), 0) + 1
        surv_racks.add(rack_of(info))

    def key(a: str):
        info = reg.get(a) or {"addr": a}
        az = az_of(info)
        return (0 if (prefer_az is not None and az == prefer_az) else 1,
                surv_az_count.get(az, 0),
                1 if rack_of(info) in surv_racks else 0,
                load.get(a, 0), a)

    return min(cands, key=key)


# ---------------- misplacement scoring (sweep contract) ----------------
def fair_share(k: int, az_count: int) -> int:
    """Ceil fair share of k replicas across az_count AZs."""
    return -(-k // max(az_count, 1))


def replica_misplacement(reg: dict, replicas: list[str],
                         cluster_azs: list[str] | None = None) -> list[str]:
    """Replicas colocated in an AZ beyond the cluster's fair share —
    the addrs the sweep should move, deterministically chosen (the
    lexically-first replica in each over-full AZ stays). An unlabeled
    (single-AZ) cluster has fair share == k and never misplaces."""
    azs = cluster_azs if cluster_azs is not None else labeled_azs(reg)
    fair = fair_share(len(replicas), len(azs))
    by_az: dict[str, list[str]] = {}
    for a in replicas:
        by_az.setdefault(az_of(reg.get(a) or {}), []).append(a)
    out: list[str] = []
    for members in by_az.values():
        if len(members) > fair:
            out.extend(sorted(members)[fair:])
    return sorted(out)


def cluster_misplacement(reg: dict, volumes: dict) -> dict:
    """Score every volume's dps against the one-per-AZ contract.
    Returns {"misplaced": total, "dps": [(vol, dp_id, [excess addrs])]}
    — the work list the rate-limited sweep consumes and the value the
    ``cubefs_fs_placement_misplaced`` gauge reports."""
    azs = labeled_azs(reg)
    total = 0
    work: list[tuple[str, int, list[str]]] = []
    for vname, vol in sorted(volumes.items()):
        for dp in vol["dps"]:
            excess = replica_misplacement(reg, dp["replicas"], azs)
            if excess:
                total += len(excess)
                work.append((vname, dp["dp_id"], excess))
    return {"misplaced": total, "dps": work}


# ---------------- operator views ----------------
def topology_tree(reg: dict, live: set, decommissioned: set) -> dict:
    """az -> rack -> {addr: {live, decommissioned}} for one node kind
    (`cubefs-cli topology tree` renders this next to the blob map)."""
    tree: dict[str, dict] = {}
    for a, info in sorted(reg.items()):
        az = tree.setdefault(az_of(info), {})
        az.setdefault(rack_of(info), {})[a] = {
            "live": a in live, "decommissioned": a in decommissioned}
    return tree
