"""The bounded LRU cache of the port's captured programs (the port of
``torcheval_tpu/parallel/_compile_cache.py``: :class:`LruCache` and
:class:`SpmdCacheInfo`).

The JAX package keeps its ``jit(shard_map(...))`` programs, the engine's
per-signature scan set and serve's program cache in one shape of cache.
The port has no jit: its cached programs are the engine's captured CUDA
graphs (``engine/scan.py``), one a block signature, and serve's shared
bundles (``serve/registry.py``), one a suite signature.  A resident process
cannot hold unbounded graphs, each with its own memory pool, so the
cache is bounded: capacity comes from
``TORCHEVAL_TPU_TORCH_COMPILE_CACHE_CAP`` (read when the cache is built;
default 256) and the least recently used entry is dropped past it.
Dropping a graph frees its memory pool with its last reference.

Left out, as jit artifacts: ``compiled_spmd``, ``spmd_cache_info`` and
``spmd_cache_clear`` (the sharded functions of ``parallel/`` run eagerly).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Hashable, NamedTuple, Optional

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.telemetry import events as _telemetry


class SpmdCacheInfo(NamedTuple):
    """``functools.CacheInfo`` plus the eviction count.  ``peak_bytes``
    stays 0: the JAX package fills it from perfscope's pricing of its
    sharded programs; the port's perfscope reports its figures through
    ``telemetry.explain_perf`` instead."""

    hits: int
    misses: int
    maxsize: int
    currsize: int
    peak_bytes: int = 0
    evictions: int = 0


class LruCache:
    """Bounded LRU memoizer with hit/miss/eviction counters.

    ``capacity=None`` reads ``TORCHEVAL_TPU_TORCH_COMPILE_CACHE_CAP`` at
    construction.  ``telemetry_events=True`` records each lookup (and each
    eviction) on the bus behind the usual one-branch guard.  Thread-safe.
    """

    def __init__(
        self,
        capacity: Optional[int] = None,
        *,
        name: str = "cache",
        telemetry_events: bool = False,
    ) -> None:
        self.name = name
        self.capacity = (
            capacity if capacity and capacity > 0 else _flags.get_int("COMPILE_CACHE_CAP")
        )
        self._events = telemetry_events
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        _LIVE.add(self)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._data

    def get(self, key: Hashable, default: Any = None) -> Any:
        """Probe: refreshes recency and counts a hit when present, counts a
        miss when absent."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                hit = True
                value = self._data[key]
            else:
                self.misses += 1
                hit = False
                value = default
        if self._events and _telemetry.ENABLED:
            _telemetry.record_cache(hit=hit)
        return value

    def put(self, key: Hashable, value: Any) -> None:
        evicted = False
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1
                evicted = True
        if evicted and self._events and _telemetry.ENABLED:
            _telemetry.record_cache(hit=False, evicted=True)

    def get_or_create(self, key: Hashable, factory: Callable[[], Any]) -> Any:
        """The memoizer: counts a hit, or runs ``factory`` outside the lock
        and inserts its value (one miss, possibly one eviction)."""
        value = self.get(key, _MISSING)
        if value is not _MISSING:
            return value
        value = factory()
        self.put(key, value)
        return value

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    def cache_info(self) -> SpmdCacheInfo:
        with self._lock:
            return SpmdCacheInfo(
                self.hits, self.misses, self.capacity, len(self._data), 0, self.evictions
            )


_MISSING = object()

# Every LruCache still referenced, for the process-wide view of
# routing.hot_path_stats(); a dropped cache (and its graphs) leaves it.
_LIVE: "weakref.WeakSet[LruCache]" = weakref.WeakSet()


def cache_totals() -> SpmdCacheInfo:
    """Hits, misses, capacity and live entries summed over every live
    cache of the process (the engine runners' graph caches): the port's
    stand-in for the JAX package's one ``spmd_cache_info()``."""
    hits = misses = maxsize = currsize = evictions = 0
    for cache in list(_LIVE):
        info = cache.cache_info()
        hits += info.hits
        misses += info.misses
        maxsize += info.maxsize
        currsize += info.currsize
        evictions += info.evictions
    return SpmdCacheInfo(hits, misses, maxsize, currsize, 0, evictions)


__all__ = ["LruCache", "SpmdCacheInfo", "cache_totals"]
