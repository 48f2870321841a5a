"""Host-RAM tier of the paged KV cache (HBM -> host demotion).

A copy of ``kubeflow_tpu/serving/kv_tier.py`` (pure host logic, no JAX),
kept in this package so the port imports nothing of the JAX one. The
payloads here are torch CPU tensors, exported from the block pool by
``models/decode.py:export_blocks``.

HBM is the scarce resource; host RAM is plentiful next to it. This module
is the host half of the tiered KV cache: a bounded-byte LRU store of
exported block payloads (the handoff arrays, pointed at host memory
instead of a peer), keyed by the token prefix the blocks back.

Two producers feed it:

- **Demotion**: prefix-trie eviction exports the entry's blocks here
  before freeing them, so memory pressure demotes instead of destroys —
  a later trie miss that finds its prefix here re-imports the blocks
  through the ordinary prefix-hit admission (the "second chance" that
  raises effective pool size past HBM at equal device bytes).
- **Suspension**: under low-watermark pressure the decoder exports the
  lowest-priority live stream's KV here (PINNED — a suspended stream's
  bytes must survive until resume, byte-identity depends on them),
  frees its slot and blocks, and parks the request for re-admission.

Payloads are verbatim device bytes (fp arrays or int8 codes+scales), so
promotion is exact by construction — imported blocks are never
recomputed or re-quantized.

Callers serialize access (the decoder's prefix lock), the same contract
as PrefixCache.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def payload_nbytes(payload: dict) -> int:
    """Host bytes a handoff payload occupies (fp ``{"k","v"}`` arrays
    or int8 ``{"q","scale"}`` dicts per side)."""
    total = 0
    stack = [payload]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += int(node.nbytes)
    return total


@dataclass
class TierEntry:
    key: tuple[int, ...]
    payload: dict
    prefix_len: int
    nbytes: int
    pinned: bool = False
    last_used: int = field(default=0)
    # Wall-clock of the last touch — the eviction-age histogram's input
    # (how long demoted bytes sat unreferenced before pressure dropped
    # them: the signal for sizing the tier and the cold store under it).
    touched_t: float = field(default=0.0)
    # Weights epoch the payload's K/V was computed under (same contract
    # as PrefixEntry.version): a demoted payload from before a live
    # weight swap must never feed a fresh request's promotion. Pinned
    # suspended-stream payloads are exempt — they ARE the stream's
    # state, and the stream straddles the swap by design.
    version: int = 0


class HostKvTier:
    """Bounded-byte LRU over exported KV payloads, with pins.

    ``capacity_bytes`` bounds the host RAM spent; an insert evicts LRU
    UNPINNED entries until it fits, and refuses (returns False) when
    pinned bytes alone leave no room — the caller then simply loses the
    second chance (demotion) or declines to suspend (suspension checks
    :meth:`can_fit` first).
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError("HostKvTier needs a positive byte budget")
        self.capacity_bytes = int(capacity_bytes)
        self.bytes_in_use = 0
        self.pinned_bytes = 0
        self.high_water_bytes = 0  # peak bytes_in_use (occupancy gauge)
        self.evictions = 0
        self.demotions = 0   # puts from trie eviction / suspension
        self.promotions = 0  # gets that fed a device re-import
        self._by_key: dict[tuple[int, ...], TierEntry] = {}
        self._clock = 0
        # Eviction hooks, fired from _evict_lru under the CALLER's
        # serialization (the decoder's prefix lock) — so they must stay
        # CPU-only and must not call back into this tier:
        # ``on_evict(entry)`` is the fleet economy's demote-to-cold
        # path (pack the payload, publish the directory hint, BEFORE
        # the bytes drop); ``eviction_age_observe(seconds)`` feeds the
        # eviction-age histogram.
        self.on_evict = None
        self.eviction_age_observe = None

    def __len__(self) -> int:
        return len(self._by_key)

    def _tick(self, entry: TierEntry) -> None:
        self._clock += 1
        entry.last_used = self._clock
        entry.touched_t = time.monotonic()

    def has(self, key: tuple[int, ...]) -> bool:
        return tuple(key) in self._by_key

    def can_fit(self, nbytes: int) -> bool:
        """Would ``nbytes`` fit after evicting every unpinned entry?"""
        return self.pinned_bytes + int(nbytes) <= self.capacity_bytes

    # -- insert / evict ------------------------------------------------

    def put(self, key, payload: dict, prefix_len: int, *,
            pinned: bool = False, version: int = 0) -> bool:
        """Store ``payload`` under ``key`` (evicting LRU unpinned
        entries to fit). Returns False when it cannot fit. Re-putting
        an existing key refreshes it (and may pin it). ``version``
        stamps the weights epoch the bytes were computed under."""
        key = tuple(key)
        nbytes = payload_nbytes(payload)
        old = self._by_key.get(key)
        if old is not None:
            self._drop(old)
        if not self.can_fit(nbytes):
            return False
        while self.bytes_in_use + nbytes > self.capacity_bytes:
            if not self._evict_lru():
                return False
        entry = TierEntry(key=key, payload=payload,
                          prefix_len=int(prefix_len), nbytes=nbytes,
                          pinned=pinned, version=int(version))
        self._tick(entry)
        self._by_key[key] = entry
        self.bytes_in_use += nbytes
        self.high_water_bytes = max(self.high_water_bytes,
                                    self.bytes_in_use)
        if pinned:
            self.pinned_bytes += nbytes
        self.demotions += 1
        return True

    def _drop(self, entry: TierEntry) -> None:
        del self._by_key[entry.key]
        self.bytes_in_use -= entry.nbytes
        if entry.pinned:
            self.pinned_bytes -= entry.nbytes

    def _evict_lru(self) -> bool:
        victims = [e for e in self._by_key.values() if not e.pinned]
        if not victims:
            return False
        victim = min(victims, key=lambda e: e.last_used)
        if self.on_evict is not None:
            # Demote-before-drop: the hook (cold-store pack + directory
            # publish) sees the payload while the bytes still exist.
            # Hook failures must not wedge the eviction — losing the
            # cold copy degrades one future miss to a prefill.
            try:
                self.on_evict(victim)
            except Exception:
                pass
        self._drop(victim)
        self.evictions += 1
        if self.eviction_age_observe is not None and victim.touched_t:
            try:
                self.eviction_age_observe(
                    max(0.0, time.monotonic() - victim.touched_t))
            except Exception:
                pass
        return True

    def note_promotion(self) -> None:
        """Count a successful device re-import fed by this tier."""
        self.promotions += 1

    def discard(self, key) -> None:
        """Remove ``key`` outright (a failed/suspended stream died —
        its pinned bytes must drain, not linger until LRU pressure)."""
        entry = self._by_key.get(tuple(key))
        if entry is not None:
            self._drop(entry)

    def entries(self) -> list[TierEntry]:
        """Snapshot of every stored entry (the weight-swap stale flush
        iterates it; callers serialize as with every other method)."""
        return list(self._by_key.values())

    def unpin(self, key) -> None:
        """Make a suspended stream's payload ordinary LRU cache again
        (resume installed it on device; the copy here is now just a
        second chance)."""
        entry = self._by_key.get(tuple(key))
        if entry is not None and entry.pinned:
            entry.pinned = False
            self.pinned_bytes -= entry.nbytes

    # -- lookup --------------------------------------------------------

    def get(self, key) -> TierEntry | None:
        entry = self._by_key.get(tuple(key))
        if entry is not None:
            self._tick(entry)
        return entry

    def match(self, tokens,
              version: int | None = None) -> tuple[TierEntry, int] | None:
        """Deepest stored payload serving a prefix of ``tokens``:
        returns ``(entry, depth)`` — the first ``depth`` positions of
        ``entry.payload`` back ``tokens[:depth]`` — or None.
        ``version`` (when given) skips entries stamped with a different
        weights epoch: a fresh request must never promote KV computed
        under weights the decoder no longer serves; a resuming
        suspended stream passes None (its payload IS its state).

        Causality makes any SHORTER depth of a stored payload valid
        too (position ``i`` depends only on tokens ``0..i``), so an
        entry whose key merely shares a leading run with the prompt
        still serves that run — the same interior matching the trie
        does, which is what lets the prompt that PUBLISHED a prefix
        hit its own demoted payload again. Depth is capped at
        ``len(tokens) - 1`` (one suffix token must remain to prefill).
        """
        cap = len(tokens) - 1
        best: tuple[TierEntry, int] | None = None
        for entry in self._by_key.values():
            if version is not None and entry.version != version:
                continue
            lim = min(entry.prefix_len, cap)
            if best is not None and lim <= best[1]:
                continue
            key, d = entry.key, 0
            while d < lim and key[d] == tokens[d]:
                d += 1
            if d and (best is None or d > best[1]):
                best = (entry, d)
        if best is not None:
            self._tick(best[0])
        return best
