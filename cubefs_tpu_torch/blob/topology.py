"""Failure-domain topology service for the blob plane.

Hierarchy: AZ > rack > host > disk. This module is the ONE place that
picks disks for volume units (tool/lint placement-discipline CFZ keeps
it that way): `place_volume` maps each unit slot to its codemode
AZ via ``Tactic.ec_layout_by_az`` so every LRC local stripe is
physically AZ-local, `pick_destination` chooses repair/rebalance homes
with the same spread rules, and the misplacement scorers feed the
scheduler's rebalance sweep and the `cubefs-cli topology` view.

Pure functions over DiskInfo/VolumeInfo snapshots — no locks, no RPC.
Callers (clustermgr, scheduler) snapshot state under their own lock and
commit the resulting picks through their FSM door.

Label model: a disk with no AZ label belongs to ``DEFAULT_AZ``; a disk
with no rack label is its own rack (one host == one rack), which makes
rack-spread degrade gracefully to host-spread on unlabeled clusters.

The AZ contract engages once a cluster is labeled: clusters whose
NORMAL disks span >= 2 distinct AZs place multi-AZ codemodes strictly
(each local stripe inside one AZ) and fail allocation when they cannot
(unless ``allow_colocated_units`` opts into colocate-with-warning).
Single-AZ clusters keep the legacy least-loaded spread so dev setups
keep working unchanged.

The port's copy of ``cubefs_tpu/blob/topology.py``, with the same behaviour.
"""

from __future__ import annotations

from .types import DiskInfo, DiskStatus, VolumeInfo

DEFAULT_AZ = "az0"


class NoAvailableDisks(Exception):
    """Placement cannot satisfy the failure-domain contract."""


def az_of(d: DiskInfo) -> str:
    return getattr(d, "az", "") or DEFAULT_AZ


def host_of(d: DiskInfo) -> str:
    return d.node_addr


def rack_of(d: DiskInfo) -> str:
    # unlabeled rack: the host is its own rack, so rack-spread degrades
    # to host-spread instead of collapsing to "everything in one rack"
    return getattr(d, "rack", "") or d.node_addr


def normal_disks(disks) -> list[DiskInfo]:
    return [d for d in disks if d.status == DiskStatus.NORMAL]


def by_az(disks) -> dict[str, list[DiskInfo]]:
    out: dict[str, list[DiskInfo]] = {}
    for d in disks:
        out.setdefault(az_of(d), []).append(d)
    return out


def order_by_load(disks) -> list[DiskInfo]:
    """Deterministic least-loaded-first ordering (disk_id tiebreak).
    The only sanctioned load sort outside this module's selectors —
    scheduler.balance consumes it instead of sorting by hand."""
    return sorted(disks, key=lambda d: (d.chunk_count, d.disk_id))


# ---------------- allocation ----------------

def _spread(cands: list[DiskInfo], k: int, used_disks: set[int],
            rack_use: dict[str, int], host_use: dict[str, int],
            allow_colocated: bool, label: str) -> list[DiskInfo]:
    """Pick k disks from cands maximizing diversity: fresh disk first,
    then rack spread, then host spread, then load, then disk_id.
    Mutates the use-counters so successive calls stay globally fair."""
    picks = []
    for _ in range(k):
        pool = [d for d in cands if d.disk_id not in used_disks]
        if not pool:
            if not allow_colocated:
                raise NoAvailableDisks(
                    f"not enough distinct disks for {label} "
                    f"(have {len(cands)}, colocation disabled)")
            pool = cands
        if not pool:
            raise NoAvailableDisks(f"no candidate disks for {label}")
        d = min(pool, key=lambda d: (rack_use.get(rack_of(d), 0),
                                     host_use.get(host_of(d), 0),
                                     d.chunk_count, d.disk_id))
        picks.append(d)
        used_disks.add(d.disk_id)
        rack_use[rack_of(d)] = rack_use.get(rack_of(d), 0) + 1
        host_use[host_of(d)] = host_use.get(host_of(d), 0) + 1
    return picks


def place_volume(t, disks, allow_colocated: bool = False,
                 label: str = "volume") -> tuple[list[DiskInfo], list[str]]:
    """Map every unit slot of tactic `t` to a disk.

    Slot -> AZ comes from ``t.ec_layout_by_az()``: stripe k's slots all
    land in the k-th assigned physical AZ, so each LRC local stripe is
    repairable without crossing an AZ. Within an AZ slots spread across
    racks, then hosts, then by load. Returns (picks, warnings) where
    picks[i] homes unit slot i and warnings name every contract the
    placement had to bend (only possible with allow_colocated).
    """
    normal = normal_disks(disks)
    if not normal:
        raise NoAvailableDisks("no registered disks")
    if len(normal) < t.total and not allow_colocated:
        raise NoAvailableDisks(
            f"{len(normal)} disks < {t.total} units for {label}")

    warnings: list[str] = []
    azs = by_az(normal)
    stripes = t.ec_layout_by_az()

    if t.az_count <= 1 or len(azs) <= 1:
        # single-AZ codemode, or an unlabeled/dev cluster: legacy
        # least-loaded spread (rack/host diversity still applies)
        if t.az_count > 1 and len(azs) <= 1:
            warnings.append(
                f"cross_az: {label} wants {t.az_count} AZs but the "
                f"cluster spans {len(azs)}; placing AZ-oblivious")
        picks = _spread(normal, t.total, set(), {}, {},
                        allow_colocated, label)
        if len({p.disk_id for p in picks}) < len(picks):
            warnings.append(
                f"intra_az: {label} colocates multiple units on one disk")
        return picks, warnings

    # labeled multi-AZ cluster: the contract is live
    if len(azs) < t.az_count:
        if not allow_colocated:
            raise NoAvailableDisks(
                f"{label} needs {t.az_count} AZs but NORMAL disks span "
                f"only {len(azs)} ({sorted(azs)}); set "
                f"allow_colocated_units to place anyway")
        warnings.append(
            f"cross_az: {label} wants {t.az_count} AZs, cluster has "
            f"{len(azs)}; stacking stripes onto reused AZs")

    # assign codemode AZ-index -> physical AZ: roomiest (most disks,
    # least load) AZs first, deterministic name tiebreak; wrap around
    # only in the degraded allow_colocated case above
    ranked = sorted(
        azs, key=lambda a: (-len(azs[a]),
                            sum(d.chunk_count for d in azs[a]), a))
    picks: list[DiskInfo | None] = [None] * t.total
    used: set[int] = set()
    rack_use: dict[str, int] = {}
    host_use: dict[str, int] = {}
    for k, stripe in enumerate(stripes):
        az = ranked[k % len(ranked)]
        if len(azs[az]) < len(stripe) and not allow_colocated:
            raise NoAvailableDisks(
                f"AZ {az} has {len(azs[az])} disks < {len(stripe)} "
                f"units for {label}'s local stripe {k}")
        sub = _spread(azs[az], len(stripe), used, rack_use, host_use,
                      allow_colocated, f"{label} stripe {k} in {az}")
        for slot, d in zip(stripe, sub):
            picks[slot] = d
    if len({p.disk_id for p in picks if p is not None}) < len(picks):
        warnings.append(
            f"intra_az: {label} colocates multiple units on one disk")
    return picks, warnings  # type: ignore[return-value]


# ---------------- repair / rebalance destinations ----------------

def pick_destination(disks, exclude_disks: set[int],
                     hard_exclude: set[int] | None = None, *,
                     prefer_az: str | None = None,
                     require_az: bool = False,
                     avoid_hosts=(),
                     require_new_host: bool = False,
                     allow_colocated: bool = False) -> DiskInfo:
    """Choose a repair/rebalance destination.

    Preference ladder: in-AZ fresh candidates, then (unless require_az)
    any fresh candidate, then — only with allow_colocated — disks the
    volume already uses. avoid_hosts is a soft penalty (hosts holding
    the volume's other units) unless require_new_host makes it absolute:
    rebalance colocation moves must strictly improve spread or not
    happen, while repairs prefer a fresh host but take what exists.
    """
    hard = set(hard_exclude or ())
    avoid = set(avoid_hosts)
    normal = [d for d in normal_disks(disks) if d.disk_id not in hard]
    cands = [d for d in normal if d.disk_id not in exclude_disks]
    pools: list[list[DiskInfo]] = []
    if prefer_az is not None:
        pools.append([d for d in cands if az_of(d) == prefer_az])
    if not require_az:
        pools.append(cands)
        if allow_colocated:
            pools.append(normal)
    elif allow_colocated and prefer_az is not None:
        pools.append([d for d in normal if az_of(d) == prefer_az])
    for pool in pools:
        if require_new_host:
            pool = [d for d in pool if host_of(d) not in avoid]
        if pool:
            return min(pool, key=lambda d: (host_of(d) in avoid,
                                            d.chunk_count, d.disk_id))
    raise NoAvailableDisks(
        "no destination disk outside the volume's failure domains")


def pick_repair_helpers(units, failed_index: int, d: int) -> list[int]:
    """Elect the d helper units for an MSR sub-shard repair, plus
    standby extras for pre-writeback verification.

    Preference order: every survivor in the failed unit's AZ first
    (beta-sized reads that never cross the DCN), then the remote
    survivors round-robin across the other AZs so cross-AZ egress
    spreads evenly instead of draining one AZ. Pure function of the
    volume's unit labels; returns the FULL preference-ordered survivor
    list (>= d entries, first d are the helper set) so the caller can
    use position d as the verification extra."""
    failed_az = units[failed_index].az
    local: list[int] = []
    remote: dict[str, list[int]] = {}
    for u in units:
        if u.index == failed_index:
            continue
        if u.az == failed_az:
            local.append(u.index)
        else:
            remote.setdefault(u.az, []).append(u.index)
    order = sorted(local)
    queues = [sorted(remote[a]) for a in sorted(remote)]
    while any(queues):
        for q in queues:
            if q:
                order.append(q.pop(0))
    if len(order) < d:
        raise NoAvailableDisks(
            f"MSR repair needs d={d} helpers, volume has only "
            f"{len(order)} survivors")
    return order


# ---------------- misplacement scoring ----------------

def unit_az(unit, disk_map: dict[int, DiskInfo]) -> str:
    az = getattr(unit, "az", "")
    if not az:
        d = disk_map.get(unit.disk_id)
        az = az_of(d) if d is not None else DEFAULT_AZ
    return az


def stripe_homes(vol: VolumeInfo, disk_map: dict[int, DiskInfo],
                 cluster_azs) -> list[str] | None:
    """Assign each local stripe of `vol` its home AZ by greedy
    plurality: stripes claim the AZ where most of their units already
    live (ties broken by stripe index then AZ name), leftover stripes
    take the unused AZs in sorted order. Deterministic, and stable as
    rebalance moves units home — the assignment a sweep converges to.

    Returns None when no contract applies (single-AZ codemode, or the
    cluster doesn't span enough AZs for a valid placement to exist).
    """
    t = vol.tactic
    if t.az_count <= 1:
        return None
    azs = sorted(set(cluster_azs))
    if len(azs) < t.az_count:
        return None  # degraded placement was explicit; nothing to chase
    stripes = t.ec_layout_by_az()
    counts: list[dict[str, int]] = []
    for stripe in stripes:
        c: dict[str, int] = {}
        for slot in stripe:
            if slot < len(vol.units):
                a = unit_az(vol.units[slot], disk_map)
                c[a] = c.get(a, 0) + 1
        counts.append(c)
    pairs = sorted(
        ((-n, k, a) for k, c in enumerate(counts) for a, n in c.items()
         if a in azs),
        key=lambda p: (p[0], p[1], p[2]))
    homes: list[str | None] = [None] * len(stripes)
    taken: set[str] = set()
    for _neg, k, a in pairs:
        if homes[k] is None and a not in taken:
            homes[k] = a
            taken.add(a)
    free = [a for a in azs if a not in taken]
    for k in range(len(stripes)):
        if homes[k] is None:
            homes[k] = free.pop(0)
    return homes  # type: ignore[return-value]


def volume_misplacement(vol: VolumeInfo, disk_map: dict[int, DiskInfo],
                        cluster_azs) -> dict:
    """Score one volume: wrong-AZ units (vs the stripe-home assignment)
    and host colocation within a stripe. Each entry names the slot to
    move and where it belongs, ready for the rebalance queue.

    Colocation counts only stacking beyond the unavoidable fair share
    ceil(k / hosts-in-AZ): a 4-unit stripe over a 2-host AZ *must* put
    two units per host, and flagging that would make the sweep chase a
    placement that cannot exist."""
    t = vol.tactic
    homes = stripe_homes(vol, disk_map, cluster_azs)
    az_hosts: dict[str, set] = {}
    for d in normal_disks(disk_map.values()):
        az_hosts.setdefault(az_of(d), set()).add(host_of(d))
    all_hosts = {h for hs in az_hosts.values() for h in hs}
    wrong_az: list[dict] = []
    colocated: list[dict] = []
    stripes = t.ec_layout_by_az() if t.az_count > 1 else [list(range(t.total))]
    for k, stripe in enumerate(stripes):
        hosts: dict[str, list[int]] = {}
        for slot in stripe:
            if slot >= len(vol.units):
                continue
            u = vol.units[slot]
            if homes is not None and unit_az(u, disk_map) != homes[k]:
                wrong_az.append({"vid": vol.vid, "slot": slot,
                                 "have": unit_az(u, disk_map),
                                 "want": homes[k]})
                continue  # fixing the AZ also re-picks rack/host
            hosts.setdefault(u.node_addr, []).append(slot)
        placed = sum(len(s) for s in hosts.values())
        avail = (az_hosts.get(homes[k], set()) if homes is not None
                 else all_hosts)
        allowance = -(-placed // max(len(avail), 1))  # ceil
        for addr, slots in hosts.items():
            for slot in slots[allowance:]:  # fair share keeps the host
                colocated.append({
                    "vid": vol.vid, "slot": slot, "host": addr,
                    "az": homes[k] if homes is not None else ""})
    return {"wrong_az": wrong_az, "colocated": colocated}


def cluster_misplacement(volumes, disk_map: dict[int, DiskInfo]) -> dict:
    """Aggregate misplacement + per-AZ unit counts/skew for the whole
    cluster. `misplaced_units` counts wrong-AZ units only (the gauge's
    contract: zero means every stripe is home); colocation is reported
    separately and fixed opportunistically."""
    # the span is every LABELED AZ, not just AZs with NORMAL capacity: a
    # blacked-out AZ still anchors its stripes' homes, so the gauge
    # reports the exile while the AZ is dark. Moves home stay gated on
    # NORMAL capacity (pick_destination raises, the sweep skips).
    cluster_azs = sorted({az_of(d) for d in disk_map.values()})
    wrong_az: list[dict] = []
    colocated: list[dict] = []
    unit_counts: dict[str, int] = {a: 0 for a in cluster_azs}
    for vol in volumes:
        rep = volume_misplacement(vol, disk_map, cluster_azs)
        wrong_az.extend(rep["wrong_az"])
        colocated.extend(rep["colocated"])
        for u in vol.units:
            a = unit_az(u, disk_map)
            unit_counts[a] = unit_counts.get(a, 0) + 1
    skew = (max(unit_counts.values()) - min(unit_counts.values())
            if unit_counts else 0)
    return {
        "azs": cluster_azs,
        "unit_counts": unit_counts,
        "az_skew": skew,
        "wrong_az": wrong_az,
        "colocated": colocated,
        "misplaced_units": len(wrong_az),
        "colocated_units": len(colocated),
    }


# ---------------- views ----------------

def topology_tree(disks, volumes=()) -> dict:
    """AZ -> rack -> host -> [disk] tree with per-disk unit counts,
    the `cubefs-cli topology blob` payload."""
    units_on: dict[int, int] = {}
    for vol in volumes:
        for u in vol.units:
            units_on[u.disk_id] = units_on.get(u.disk_id, 0) + 1
    tree: dict[str, dict] = {}
    for d in sorted(disks, key=lambda d: d.disk_id):
        host = tree.setdefault(az_of(d), {}).setdefault(
            rack_of(d), {}).setdefault(host_of(d), [])
        host.append({"disk_id": d.disk_id, "path": d.path,
                     "status": int(d.status),
                     "chunk_count": d.chunk_count,
                     "units": units_on.get(d.disk_id, 0)})
    return tree


def cluster_view(disks, volumes) -> dict:
    """Everything the CLI shows: the tree plus misplacement summary."""
    disk_map = {d.disk_id: d for d in disks}
    rep = cluster_misplacement(volumes, disk_map)
    return {
        "tree": topology_tree(disks, volumes),
        "azs": rep["azs"],
        "unit_counts": rep["unit_counts"],
        "az_skew": rep["az_skew"],
        "misplaced_units": rep["misplaced_units"],
        "colocated_units": rep["colocated_units"],
        "volumes": len(list(volumes)),
        "disks": len(disk_map),
    }
