"""Host-side prefix trie for the device-resident prefix KV pool.

A copy of ``kubeflow_tpu/serving/prefix_cache.py`` (pure host logic, no
JAX), kept in this package so the port imports nothing of the JAX one.
The continuous decoder keeps the K/V rows of frequently-shared prompt
prefixes (system prompts, few-shot templates) in a fixed-capacity device
pool (:func:`kubeflow_tpu_torch.models.decode.init_prefix_pool`); this
module is the host half: a trie keyed on token prefixes that maps a new
prompt to the deepest reusable pool slot, with LRU eviction and per-entry
refcounts so a prefix an in-flight admission still reads is never evicted
under it. The port writes the pool in place, so these pins are what keep
a store from landing on a row an admission reads.

Correctness hinges on causality: the K/V rows at positions ``0..d-1``
depend only on tokens ``0..d-1``, so ANY entry whose key starts with the
first ``d`` prompt tokens serves a ``d``-length prefix from its pool
slot's first ``d`` rows — the trie therefore matches through *interior*
nodes (every node knows the entries passing through it), not only at
entry terminals. That is what makes N requests sharing a system prompt
hit even though each published key diverges after the shared part.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(eq=False)  # identity hash: entries live in per-node sets
class PrefixEntry:
    """One cached prefix: ``key`` tokens occupy pool row ``slot`` (dense
    layout) or the refcounted pool blocks ``blocks`` (paged layout —
    ``slot`` is then just a capacity token)."""

    key: tuple[int, ...]
    slot: int
    refs: int = 0       # in-flight admissions reading this slot
    last_used: int = 0  # LRU clock tick
    blocks: tuple[int, ...] | None = None  # paged: KV blocks held
    # Weights epoch the cached K/V was computed under: a live weight
    # push (ContinuousDecoder.update_weights) bumps the decoder's
    # version, and entries stamped with an older one are stale — their
    # bytes answer a model that no longer serves. The decoder refuses
    # and removes stale matches; the cache itself stays version-blind.
    version: int = 0

    def __len__(self) -> int:
        return len(self.key)


@dataclass
class _Node:
    children: dict[int, "_Node"] = field(default_factory=dict)
    # Entries whose key passes through this node (so an interior node can
    # answer "is the path below me cached somewhere?").
    entries: set = field(default_factory=set)


class PrefixCache:
    """Trie + LRU bookkeeping over a fixed number of device pool slots.

    The decoder owns the device pool; this class only decides *which* slot
    serves or receives a prefix. All methods are host-side and O(len(key));
    callers serialize access (the decoder's prefix lock).
    """

    def __init__(self, slots: int, *, min_len: int = 1):
        if slots <= 0:
            raise ValueError("PrefixCache needs at least one slot")
        self.slots = slots
        self.min_len = max(1, int(min_len))
        self._root = _Node()
        self._by_key: dict[tuple[int, ...], PrefixEntry] = {}
        self._free = list(range(slots - 1, -1, -1))
        self._clock = 0
        self.evictions = 0
        # Paged layout: called with the entry on every remove() so its
        # refcounted pool blocks return to the allocator. Fires under
        # whatever lock the caller serializes the cache with — the hook
        # must not re-acquire it.
        self.on_evict = None

    def __len__(self) -> int:
        return len(self._by_key)

    def _tick(self, entry: PrefixEntry) -> None:
        self._clock += 1
        entry.last_used = self._clock

    # -- lookup --------------------------------------------------------

    def match(self, tokens: list[int]) -> tuple[PrefixEntry, int] | None:
        """Longest cached prefix of ``tokens`` usable for suffix prefill.

        Returns ``(entry, depth)`` — reuse the first ``depth`` rows of
        ``entry.slot`` — or None. ``depth`` is capped at ``len(tokens)-1``
        (at least one suffix token must remain to prefill: the last
        prompt position's logits seed generation) and floored at
        ``min_len`` (shorter reuse costs more bookkeeping than prefill).
        The entry is PINNED (refcount +1); callers release() when the
        admission that read the slot has finished.
        """
        node = self._root
        depth = 0
        best: tuple[_Node, int] | None = None
        for tok in tokens[: max(len(tokens) - 1, 0)]:
            child = node.children.get(tok)
            if child is None or not child.entries:
                break
            node = child
            depth += 1
            best = (node, depth)
        if best is None or best[1] < self.min_len:
            return None
        node, depth = best
        entry = max(node.entries, key=lambda e: e.last_used)
        entry.refs += 1
        self._tick(entry)
        return entry, depth

    def has(self, key: tuple[int, ...]) -> bool:
        return tuple(key) in self._by_key

    def touch(self, key: tuple[int, ...]) -> None:
        entry = self._by_key.get(tuple(key))
        if entry is not None:
            self._tick(entry)

    def release(self, entry: PrefixEntry) -> None:
        entry.refs = max(0, entry.refs - 1)

    # -- insert / evict ------------------------------------------------

    def reserve(self, key: tuple[int, ...]) -> PrefixEntry | None:
        """Claim a pool slot for a NEW prefix ``key``.

        Returns the entry whose ``slot`` the caller must now fill on
        device, or None when the key is already cached (its LRU stamp is
        refreshed) or every slot is pinned by an in-flight admission.
        """
        key = tuple(key)
        if len(key) < self.min_len:
            return None
        existing = self._by_key.get(key)
        if existing is not None:
            self._tick(existing)
            return None
        if self._free:
            slot = self._free.pop()
        else:
            victim = self._lru_unpinned()
            if victim is None:
                return None
            self.remove(victim)
            self.evictions += 1
            slot = self._free.pop()
        entry = PrefixEntry(key=key, slot=slot)
        self._tick(entry)
        self._by_key[key] = entry
        node = self._root
        node.entries.add(entry)
        for tok in key:
            node = node.children.setdefault(tok, _Node())
            node.entries.add(entry)
        return entry

    def _lru_unpinned(self) -> PrefixEntry | None:
        candidates = [e for e in self._by_key.values() if e.refs == 0]
        if not candidates:
            return None
        return min(candidates, key=lambda e: e.last_used)

    def entries(self) -> list[PrefixEntry]:
        """Snapshot of every live entry (the weight-swap stale flush
        iterates it; callers hold the same lock as every other call)."""
        return list(self._by_key.values())

    def evict_lru(self) -> bool:
        """Evict the least-recently-used UNPINNED entry (memory-pressure
        reclaim, counted as an eviction). Returns False when every entry
        is pinned or the cache is empty."""
        victim = self._lru_unpinned()
        if victim is None:
            return False
        self.remove(victim)
        self.evictions += 1
        return True

    def remove(self, entry: PrefixEntry) -> None:
        """Drop ``entry`` from the trie and return its slot to the free
        list (explicit removal; eviction accounting is reserve()'s)."""
        if self._by_key.pop(entry.key, None) is None:
            return
        if self.on_evict is not None:
            self.on_evict(entry)
        node = self._root
        node.entries.discard(entry)
        path = [node]
        for tok in entry.key:
            node = node.children.get(tok)
            if node is None:
                break
            node.entries.discard(entry)
            path.append(node)
        # Prune now-empty branches so the trie doesn't grow monotonically.
        for parent, tok in zip(reversed(path[:-1]), reversed(entry.key)):
            child = parent.children.get(tok)
            if child is not None and not child.entries \
                    and not child.children:
                del parent.children[tok]
        self._free.append(entry.slot)
