"""Runtime lock witness — the dynamic half of the concurrency sanitizer.

The static lock-order graph (tool/lint/graph.py) proves discipline over
code the resolver can see; this module watches the locks the process
ACTUALLY takes, FreeBSD WITNESS-style, and catches the two failure
shapes that only show up at runtime:

  * lock-order inversion — thread A takes X then Y while thread B takes
    Y then X. Neither thread deadlocks in this run, but the acquisition-
    order graph has a cycle, so some interleaving deadlocks. The witness
    raises on the FIRST observed back-edge, with both acquisition chains
    (this thread's held stack + the remembered sample that created each
    reverse edge), not when the processes finally wedge.
  * lock held across an RPC — the caller's critical section is now as
    slow as the network (the raft-heartbeat-under-lock shape). The rpc
    layer calls `note_rpc()` on every outbound call; if the calling
    thread holds any witnessed lock without an `allow_block`
    justification, that's a raise.

Cost model: when `CUBEFS_SANITIZE` is off (the default), `make_lock()` /
`make_rlock()` return PLAIN `threading.Lock` / `threading.RLock`
objects — identical class, zero wrappers, zero per-acquire overhead —
and the rpc hook is a single module-global identity check (the same
pattern as faultinject's `_fault`). Flip `CUBEFS_SANITIZE=1` (or enter
`installed()`) and locks allocated from then on are witness-wrapped.

Lock identity is the NAME (`"Class.attr"`), matching the static graph's
nodes, so per-instance locks of one class merge into one order node.
Two instances of the SAME name held together (an ordered per-instance
ladder, e.g. per-extent locks) is recorded as an `instance_overlap`
stat, never an edge — a self-edge would be an instant false cycle.

Usage:
    self._lock = lockwitness.make_lock("Scheduler._lock")
    self._propose_lock = lockwitness.make_rlock(
        "ReplicatedFsm._propose_lock",
        allow_block="serializes propose; commit RPCs run under it "
                    "by design (dup-check atomic with commit)")

The wrappers implement the Condition protocol (`_is_owned`,
`_release_save`, `_acquire_restore`), so
`threading.Condition(witnessed_lock)` works for both flavors.

The port's copy of ``cubefs_tpu/utils/lockwitness.py``, with the same behaviour.
"""

from __future__ import annotations

import json
import os
import sys
import threading

__all__ = [
    "make_lock", "make_rlock", "enabled", "install", "uninstall",
    "installed", "active", "note_rpc", "WitnessViolation",
]


class WitnessViolation(RuntimeError):
    """An observed lock-order cycle or lock-held-across-RPC."""


def _caller_site() -> str:
    """file:line of the nearest frame outside this module (and outside
    threading.py, so Condition-driven reacquires attribute usefully)."""
    f = sys._getframe(1)
    here = __file__
    while f is not None:
        fn = f.f_code.co_filename
        if fn != here and not fn.endswith("threading.py"):
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


class LockWitness:
    """Global acquisition-order graph + per-thread held stacks."""

    def __init__(self):
        self._mu = threading.Lock()  # guards the order graph + stats
        # src name -> dst name -> sample of the acquisition that created
        # the edge (enough to print the other side of a cycle report)
        self._succ: dict[str, dict[str, dict]] = {}
        self._tls = threading.local()
        self.acquisitions = 0
        self.rpc_checks = 0
        self.instance_overlaps = 0
        self.max_depth = 0

    # ---- per-thread held stack: list of (lock, site) ----
    def _held(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def held_names(self) -> list[str]:
        return [lk.name for lk, _site in self._held()]

    # ---- acquisition protocol (called by _WitnessLock) ----
    def before_acquire(self, lock: "_WitnessLock", site: str) -> None:
        held = self._held()
        held_entries = [(lk, s) for lk, s in held]
        same_name = [lk for lk, _ in held_entries if lk.name == lock.name]
        if same_name:
            # pure reentrancy (same object, recursive) is silent; a
            # DIFFERENT instance under the same name is an ordered
            # ladder the name-merged graph can't express — count it,
            # don't edge it (a self-edge is an instant false cycle)
            if any(lk is not lock for lk in same_name):
                with self._mu:
                    self.instance_overlaps += 1
            return
        new_edges = [(lk.name, s) for lk, s in held_entries]
        if not new_edges:
            return
        with self._mu:
            # cycle check BEFORE recording: does a path lock.name ->*
            # any-held-name already exist in the order graph?
            target = {name for name, _ in new_edges}
            path = self._find_path(lock.name, target)
            if path is not None:
                msg = self._render_cycle(lock, site, held_entries, path)
                raise WitnessViolation(msg)
            for src, held_site in new_edges:
                dst_map = self._succ.setdefault(src, {})
                if lock.name not in dst_map:
                    dst_map[lock.name] = {
                        "thread": threading.current_thread().name,
                        "held_at": held_site,
                        "acquired_at": site,
                    }

    def after_acquire(self, lock: "_WitnessLock", site: str) -> None:
        held = self._held()
        held.append((lock, site))
        self.acquisitions += 1
        if len(held) > self.max_depth:
            self.max_depth = len(held)

    def on_release(self, lock: "_WitnessLock") -> None:
        held = self._held()
        # innermost matching entry (releases may be out of LIFO order)
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    def pop_all(self, lock: "_WitnessLock") -> int:
        """Condition._release_save support: drop every reentrant hold of
        `lock` on this thread, return how many there were."""
        held = self._held()
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                n += 1
        return n

    def push_n(self, lock: "_WitnessLock", n: int, site: str) -> None:
        held = self._held()
        for _ in range(n):
            held.append((lock, site))

    # ---- the RPC door ----
    def note_rpc(self, addr: str, method: str) -> None:
        self.rpc_checks += 1
        blocking = [(lk, site) for lk, site in self._held()
                    if not lk.allow_block]
        if not blocking:
            return
        held_desc = ", ".join(
            f"`{lk.name}` (acquired at {site})" for lk, site in blocking)
        raise WitnessViolation(
            f"lock held across RPC: thread "
            f"{threading.current_thread().name!r} calls "
            f"{addr}/{method} while holding {held_desc} — the critical "
            "section is now as slow as the network; move the call "
            "outside the lock or justify with make_lock(..., "
            "allow_block=...)")

    # ---- order-graph internals (callers hold self._mu) ----
    def _find_path(self, src: str, targets: set[str]) -> list[str] | None:
        if src in targets:  # can't happen (same-name filtered) but safe
            return [src]
        seen = {src}
        frontier = [[src]]
        while frontier:
            path = frontier.pop(0)
            for nxt in self._succ.get(path[-1], {}):
                if nxt in seen:
                    continue
                if nxt in targets:
                    return path + [nxt]
                seen.add(nxt)
                frontier.append(path + [nxt])
        return None

    def _render_cycle(self, lock, site, held_entries, path) -> str:
        held_desc = ", ".join(
            f"`{lk.name}` (at {s})" for lk, s in held_entries)
        other = []
        for a, b in zip(path, path[1:]):
            sample = self._succ.get(a, {}).get(b, {})
            other.append(
                f"`{a}` then `{b}` (thread "
                f"{sample.get('thread', '?')!r}, held at "
                f"{sample.get('held_at', '?')}, acquired at "
                f"{sample.get('acquired_at', '?')})")
        return (
            f"lock-order cycle: thread "
            f"{threading.current_thread().name!r} acquires "
            f"`{lock.name}` (at {site}) while holding {held_desc}, but "
            f"the order graph already has "
            f"{' -> '.join(f'`{n}`' for n in path)} from: "
            + "; ".join(other))

    # ---- reporting ----
    def stats(self) -> dict:
        with self._mu:
            edges = [
                {"src": a, "dst": b, **sample}
                for a, succs in sorted(self._succ.items())
                for b, sample in sorted(succs.items())
            ]
        return {
            "enabled": True,
            "locks_seen": sorted(
                {e["src"] for e in edges} | {e["dst"] for e in edges}),
            "edges": edges,
            "acquisitions": self.acquisitions,
            "max_held_depth": self.max_depth,
            "rpc_checks": self.rpc_checks,
            "instance_overlaps": self.instance_overlaps,
        }

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.stats(), f, indent=2)
            f.write("\n")
        os.replace(tmp, path)


class _WitnessLock:
    """Witness wrapper over a threading.Lock/RLock. Only ever allocated
    while a witness is active; keeps a reference to ITS witness so locks
    from a finished `installed()` scope degrade to pass-through."""

    __slots__ = ("_witness", "name", "_inner", "_recursive", "allow_block")

    def __init__(self, witness: LockWitness, name: str, recursive: bool,
                 allow_block: str | None):
        self._witness = witness
        self.name = name
        self._recursive = recursive
        self._inner = (threading.RLock() if recursive
                       else threading.Lock())
        self.allow_block = allow_block

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        site = _caller_site()
        w = self._witness
        if w is _active:  # pass-through once its witness is uninstalled
            w.before_acquire(self, site)
        got = (self._inner.acquire(blocking, timeout) if blocking
               else self._inner.acquire(False))
        if got and w is _active:
            w.after_acquire(self, site)
        return got

    def release(self) -> None:
        if self._witness is _active:
            self._witness.on_release(self)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._inner
        if hasattr(inner, "locked"):
            return inner.locked()
        if inner.acquire(False):  # pragma: no cover - RLock < 3.14
            inner.release()
            return False
        return True

    # ---- Condition protocol ----
    def _is_owned(self) -> bool:
        if self._recursive:
            return self._inner._is_owned()
        # plain Lock: the witness's per-thread stack answers exactly
        return any(lk is self for lk, _ in self._witness._held())

    def _release_save(self):
        n = (self._witness.pop_all(self)
             if self._witness is _active else 0)
        if self._recursive:
            return self._inner._release_save(), n
        self._inner.release()
        return None, n

    def _acquire_restore(self, saved) -> None:
        inner_saved, n = saved
        if self._recursive:
            self._inner._acquire_restore(inner_saved)
        else:
            self._inner.acquire()
        if self._witness is _active and n:
            self._witness.push_n(self, n, _caller_site())

    def __repr__(self) -> str:
        return (f"<WitnessLock {self.name!r} "
                f"{'rlock' if self._recursive else 'lock'}>")


# ---------------- module door ----------------

def _env_on() -> bool:
    return os.environ.get("CUBEFS_SANITIZE", "").lower() in (
        "1", "true", "yes", "on")


_active: LockWitness | None = LockWitness() if _env_on() else None


def enabled() -> bool:
    return _active is not None


def active() -> LockWitness | None:
    return _active


def make_lock(name: str, allow_block: str | None = None):
    """A mutex for the witness's eyes. Off: a PLAIN threading.Lock —
    same class, zero overhead. On: a witness-wrapped lock named `name`
    (use the static graph's `Class.attr` node name)."""
    if _active is None:
        return threading.Lock()
    return _WitnessLock(_active, name, recursive=False,
                        allow_block=allow_block)


def make_rlock(name: str, allow_block: str | None = None):
    if _active is None:
        return threading.RLock()
    return _WitnessLock(_active, name, recursive=True,
                        allow_block=allow_block)


def note_rpc(addr: str, method: str) -> None:
    """Called by utils/rpc.py on every outbound call (both transports).
    The caller guards with `lockwitness._active is not None`, so this
    costs nothing when the sanitizer is off."""
    w = _active
    if w is not None:
        w.note_rpc(addr, method)


def install() -> LockWitness:
    """Turn the witness on for locks allocated FROM NOW ON (tests)."""
    global _active
    _active = LockWitness()
    return _active


def uninstall() -> None:
    global _active
    _active = None


class installed:
    """Context manager: `with lockwitness.installed() as w:` — builds a
    cluster inside, every lock it allocates is witnessed, and `w.stats()`
    is available after. Restores the previous door state on exit."""

    def __enter__(self) -> LockWitness:
        self._prev = _active
        return install()

    def __exit__(self, *exc) -> None:
        global _active
        _active = self._prev
