"""Fleet-wide prefix→holder directory for the distributed KV economy.

A copy of ``kubeflow_tpu/serving/kv_directory.py`` (pure host logic, no
JAX), kept in this package so the port imports nothing of the JAX one.

The replicas of a serving fleet each carry a private prefix trie and
host-RAM tier (serving/prefix_cache.py, serving/kv_tier.py); this module
is the piece that makes them a FLEET cache: a bounded map from
``prefix_affinity_key`` values (serving/affinity.py — the same keys the
gateway's prefix-affine router already computes per request) to the
replicas believed to hold KV for that key range, plus the cold
content-addressed tier (serving/cold_store.py).

The directory stores HINTS, not truth. A holder entry records the
deepest prefix length a replica advertised for a key, the weights epoch
the bytes were computed under, and which tier held them at publish time
— but the authoritative check is the pull itself: a requester that
imports from a holder validates tokens, block metadata, and epoch on
the fetched envelope, and a miss (holder evicted meanwhile, holder
dead, epoch moved on) simply withdraws the hint and falls through to
the next tier. Wrong hints cost one wasted probe; they can never
corrupt KV. That tolerance is what lets publishes stay cheap
(lock-then-dict-write, no fleet round-trip) on the decoder's hot
eviction/publish paths.

Shared across threads — the gateway's proxy handlers, every replica's
caller-thread submit probes, and the fleet's death sweeps all touch it
— so unlike the trie/tier (caller-serialized), the directory carries
its own leaf lock: no method calls out while holding it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

# Sentinel holder name for bytes that demoted into the shared cold
# store: no replica serves them, requesters probe the cold tier
# directly, but the published hint keeps the key's history visible to
# rollup dashboards (and lets the gateway know the prefix exists at
# all, even with every warm holder gone).
COLD_HOLDER = "<cold>"


@dataclass
class DirectoryHint:
    """One holder's claim on a key: the deepest prefix it advertised,
    the weights epoch that computed the bytes, and the tier they lived
    in at publish time (``hbm``/``host``/``cold``/``route``)."""

    holder: str
    prefix_len: int
    version: int
    tier: str


class KvDirectory:
    """Bounded LRU map: affinity key → {holder → :class:`DirectoryHint`}.

    ``capacity`` bounds the number of distinct KEYS tracked (each key
    holds at most one hint per holder); publishing past it evicts the
    least-recently-touched key — a directory is a cache of routing
    hints, and a forgotten key merely degrades to the pre-directory
    behavior (local tiers, then prefill).
    """

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError("KvDirectory needs a positive capacity")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._keys: OrderedDict[str, dict[str, DirectoryHint]] = \
            OrderedDict()
        self.publishes = 0
        self.withdrawals = 0
        self.hits = 0        # lookups that returned at least one hint
        self.misses = 0      # lookups that found nothing usable
        self.evictions = 0   # keys dropped by the capacity bound
        self.holder_drops = 0  # drop_holder sweeps (replica deaths)

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    # -- publish / withdraw --------------------------------------------

    def publish(self, key: str, holder: str, *, prefix_len: int = 0,
                version: int = 0, tier: str = "hbm") -> None:
        """Record (or deepen/refresh) ``holder``'s claim on ``key``.
        A re-publish keeps the deepest prefix length seen for the same
        epoch — a holder's shallower advert never shrinks its claim —
        but an epoch change REPLACES the hint outright: old-epoch bytes
        are unservable, so their depth is no longer evidence."""
        holder = str(holder)
        if not holder:
            return
        with self._lock:
            hints = self._keys.get(key)
            if hints is None:
                hints = self._keys[key] = {}
            old = hints.get(holder)
            if (old is not None and old.version == int(version)
                    and old.prefix_len > int(prefix_len)):
                prefix_len = old.prefix_len
            hints[holder] = DirectoryHint(
                holder=holder, prefix_len=int(prefix_len),
                version=int(version), tier=str(tier))
            self._keys.move_to_end(key)
            self.publishes += 1
            while len(self._keys) > self.capacity:
                self._keys.popitem(last=False)
                self.evictions += 1

    def withdraw(self, key: str, holder: str) -> None:
        """Remove one holder's claim on ``key`` (a pull against the
        hint came back empty — the holder evicted or moved epochs)."""
        with self._lock:
            hints = self._keys.get(key)
            if hints is None:
                return
            if hints.pop(str(holder), None) is not None:
                self.withdrawals += 1
            if not hints:
                del self._keys[key]

    def drop_holder(self, holder: str) -> None:
        """Sweep every hint naming ``holder`` — a replica died; its
        advertised bytes are gone with it. Cold hints survive (the
        cold store outlives any one replica)."""
        holder = str(holder)
        with self._lock:
            empty = []
            for key, hints in self._keys.items():
                hints.pop(holder, None)
                if not hints:
                    empty.append(key)
            for key in empty:
                del self._keys[key]
            self.holder_drops += 1

    # -- lookup --------------------------------------------------------

    def lookup(self, key: str, *, exclude: tuple = (),
               version: int | None = None) -> list[DirectoryHint]:
        """Hints for ``key``, deepest first. ``exclude`` filters holder
        names (a replica never pulls from itself); ``version`` (when
        given) filters hints stamped with a different weights epoch —
        pre-swap bytes would be refused at import anyway, so probing
        their holders is pure waste."""
        excluded = set(exclude)
        with self._lock:
            hints = self._keys.get(key)
            if not hints:
                self.misses += 1
                return []
            self._keys.move_to_end(key)
            out = [h for h in hints.values()
                   if h.holder not in excluded
                   and (version is None or h.version == int(version))]
            if out:
                self.hits += 1
            else:
                self.misses += 1
        return sorted(out, key=lambda h: (-h.prefix_len, h.holder))

    def holders(self, key: str, *, version: int | None = None,
                warm_only: bool = True) -> list[str]:
        """Holder names for ``key`` (the gateway's spill preference —
        it needs names, not depths). ``warm_only`` skips the cold
        sentinel: you cannot route a request to an object store."""
        return [h.holder
                for h in self.lookup(key, version=version)
                if not (warm_only and h.holder == COLD_HOLDER)]

    def stats(self) -> dict:
        with self._lock:
            return {
                "keys": len(self._keys),
                "capacity": self.capacity,
                "publishes": self.publishes,
                "withdrawals": self.withdrawals,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "holder_drops": self.holder_drops,
            }
