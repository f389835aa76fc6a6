"""Shared capped LRU for the codec's per-matrix host artifacts.

The port's own copy of ``cubefs_tpu/ops/progcache.py``. ``ops/msr.py``
caches its product-matrix rows here: a long-lived repair worker that
touches many geometries (every distinct failed slot and helper set is a
distinct matrix) would otherwise grow an unbounded cache forever. One
process-wide LRU, shared by every family and keyed ``(family, key)``,
holds at most ``CUBEFS_CODEC_PROGCACHE_CAP`` entries (default 256, at
least 8).

``cached(family)`` is the ``functools.lru_cache`` drop-in the kernel
modules use; it keeps a functools-shaped ``cache_info()``. Traffic is
counted as the reference counts it:
``cubefs_codec_program_cache_total{family,event=hit|miss|evict}`` and
the resident-entries gauge (``utils/metrics.py``).
"""

from __future__ import annotations

import collections
import functools
import os
import threading

from ..utils import metrics

CacheInfo = collections.namedtuple("CacheInfo", ["hits", "misses", "maxsize", "currsize"])


def _capacity() -> int:
    try:
        return max(8, int(os.environ.get("CUBEFS_CODEC_PROGCACHE_CAP", 256)))
    except ValueError:
        return 256


class ProgramCache:
    """Thread-safe LRU evicting least-recently-used entries past
    ``capacity``. Builds run outside the lock: two threads racing on one
    cold key may both build (builds are pure), but neither blocks behind
    another family's slow build."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity if capacity is not None else _capacity()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, family: str, key):
        full = (family, key)
        with self._lock:
            if full in self._entries:
                self._entries.move_to_end(full)
                metrics.codec_program_cache.inc(family=family, event="hit")
                return True, self._entries[full]
        metrics.codec_program_cache.inc(family=family, event="miss")
        return False, None

    def put(self, family: str, key, value) -> None:
        full = (family, key)
        with self._lock:
            self._entries[full] = value
            self._entries.move_to_end(full)
            while len(self._entries) > self.capacity:
                (old_family, _), _ = self._entries.popitem(last=False)
                metrics.codec_program_cache.inc(family=old_family, event="evict")
            metrics.codec_program_cache_entries.set(len(self._entries))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# The one instance every family shares, so the cap means what it says.
SHARED = ProgramCache()


def cached(family: str):
    """lru_cache drop-in routing through the SHARED capped cache.

    Hashable positional arguments only. Exposes ``cache_info()``
    (functools-shaped, per-function counters) and ``cache_clear()``
    (drops only this function's entries)."""

    def deco(fn):
        stats = {"hits": 0, "misses": 0}
        prefix = fn.__module__ + "." + fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args):
            key = (prefix,) + args
            hit, value = SHARED.get(family, key)
            if hit:
                stats["hits"] += 1
                return value
            stats["misses"] += 1
            value = fn(*args)
            SHARED.put(family, key, value)
            return value

        def cache_info():
            return CacheInfo(stats["hits"], stats["misses"], SHARED.capacity, len(SHARED))

        def cache_clear():
            with SHARED._lock:
                for k in [k for k in SHARED._entries if k[0] == family and k[1][0] == prefix]:
                    del SHARED._entries[k]
                metrics.codec_program_cache_entries.set(len(SHARED._entries))
            stats["hits"] = stats["misses"] = 0

        wrapper.cache_info = cache_info
        wrapper.cache_clear = cache_clear
        wrapper.cache_family = family
        return wrapper

    return deco
