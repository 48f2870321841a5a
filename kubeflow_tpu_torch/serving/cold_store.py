"""Cold content-addressed tier of the fleet KV economy.

Counterpart of ``kubeflow_tpu/serving/cold_store.py``, over this
package's envelope codec (``serving/handoff.py``). The blobs are the JAX
package's byte for byte (the same packed envelope, the same content key),
so a blob either package writes unpacks in the other; :meth:`ColdKvStore.
match` hands back torch CPU tensors.

The last stop of the KV hierarchy (HBM → host RAM → peer replicas →
HERE): host-tier evictions pack their payload into a handoff
envelope (serving/handoff.py — the same JSON-safe blob the
prefill/decode handoff ships over HTTP) and park it in a shared,
byte-bounded, content-addressed store. A fleet-wide miss that finds
its prefix here re-imports the blob through the ordinary
``_install_prefix_payload`` path — exact bytes, never recomputed.

Content addressing keys each blob by ``blake2b(epoch ‖ prefix
tokens)``: the weights epoch is IN the key, so a live weight push
invalidates every pre-swap blob by construction — post-swap lookups
simply hash to keys that do not exist (stale hits are refused
without a flush pass; LRU pressure reclaims the orphaned bytes). Deduplication falls out the same way: two replicas demoting
the same (epoch, prefix) write one blob.

In process this is a dict of JSON strings; the ``cold_store_ref`` CRD
knob names an instance (``mem://<name>?bytes=<n>``) so colocated
replicas in one process share one store, and a real object-store
backend can slot behind the same four methods. Thread-safe with its
own leaf lock (callers are every replica's submit probes and
prefix-lock-holding eviction hooks): no method calls out while
holding it.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from dataclasses import dataclass

from kubeflow_tpu_torch.serving import handoff as handoff_mod


def content_key(tokens, version: int) -> str:
    """The blob address for a prefix: ``blake2b(epoch ‖ tokens)``.
    Epoch-first so a weight push moves EVERY prefix to fresh
    addresses — staleness is unreachable, not filtered."""
    h = hashlib.blake2b(digest_size=16)
    h.update(int(version).to_bytes(8, "little", signed=True))
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()


@dataclass
class _ColdBlob:
    key: str
    tokens: tuple[int, ...]
    prefix_len: int
    version: int
    blob: str      # json.dumps of the packed handoff envelope
    nbytes: int
    last_used: int = 0


class ColdKvStore:
    """Bounded-byte LRU of packed handoff envelopes, addressed by
    ``(epoch, prefix)`` content key."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError("ColdKvStore needs a positive byte budget")
        self.capacity_bytes = int(capacity_bytes)
        self.bytes_in_use = 0
        self._lock = threading.Lock()
        self._blobs: OrderedDict[str, _ColdBlob] = OrderedDict()
        self._clock = 0
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.refused = 0  # puts that could not fit even after eviction

    def __len__(self) -> int:
        with self._lock:
            return len(self._blobs)

    # -- insert --------------------------------------------------------

    def put(self, handoff: dict, *, version: int) -> str | None:
        """Pack ``handoff`` (a decoder export dict: tokens/prefix_len/
        block metadata/payload arrays) and store it under its content
        key. Returns the key, or None when the blob cannot fit.
        Re-putting an existing key refreshes its LRU position without
        re-serializing identical bytes (the key IS the content)."""
        plen = int(handoff["prefix_len"])
        toks = tuple(int(t) for t in handoff["tokens"][:plen])
        key = content_key(toks, version)
        with self._lock:
            old = self._blobs.get(key)
            if old is not None:
                self._tick(old)
                self._blobs.move_to_end(key)
                return key
        # Serialize OUTSIDE the lock: packing base64-encodes the whole
        # payload, and a concurrent probe must not wait on it.
        blob = json.dumps(handoff_mod.pack(handoff))
        nbytes = len(blob)
        with self._lock:
            if key in self._blobs:  # lost a racing identical put — fine
                return key
            if nbytes > self.capacity_bytes:
                self.refused += 1
                return None
            while self.bytes_in_use + nbytes > self.capacity_bytes:
                _, victim = self._blobs.popitem(last=False)
                self.bytes_in_use -= victim.nbytes
                self.evictions += 1
            entry = _ColdBlob(key=key, tokens=toks, prefix_len=plen,
                              version=int(version), blob=blob,
                              nbytes=nbytes)
            self._tick(entry)
            self._blobs[key] = entry
            self.bytes_in_use += nbytes
            self.puts += 1
        return key

    def _tick(self, entry: _ColdBlob) -> None:
        self._clock += 1
        entry.last_used = self._clock

    # -- lookup --------------------------------------------------------

    def peek_depth(self, tokens, version: int) -> int:
        """Deepest stored prefix depth serving ``tokens`` under
        ``version``, without deserializing anything — the crossover
        check's input (import only when the gain clears the
        threshold)."""
        with self._lock:
            return self._best(tokens, version)[1]

    def _best(self, tokens, version: int) -> tuple[_ColdBlob | None, int]:
        """Caller holds the lock. Same interior matching as
        HostKvTier.match: causality makes any shorter depth of a stored
        prefix valid, capped at len(tokens) - 1 so one suffix token
        remains to prefill."""
        cap = len(tokens) - 1
        version = int(version)
        best: tuple[_ColdBlob | None, int] = (None, 0)
        for entry in self._blobs.values():
            if entry.version != version:
                continue
            lim = min(entry.prefix_len, cap)
            if lim <= best[1]:
                continue
            d = 0
            while d < lim and entry.tokens[d] == int(tokens[d]):
                d += 1
            if d > best[1]:
                best = (entry, d)
        return best

    def match(self, tokens, version: int) -> tuple[dict, int] | None:
        """Deepest stored envelope serving a prefix of ``tokens`` under
        weights epoch ``version``: returns ``(handoff, depth)`` with
        the envelope UNPACKED (torch CPU payload, ready for the importer's
        covering-slice install) — or None. A malformed blob (a future
        backend bitrotting) drops the entry and reports a miss instead
        of handing garbage to a KV pool."""
        with self._lock:
            entry, depth = self._best(tokens, version)
            if entry is None:
                self.misses += 1
                return None
            self._tick(entry)
            self._blobs.move_to_end(entry.key)
            blob = entry.blob
        try:
            handoff = handoff_mod.unpack(json.loads(blob))
        except ValueError:
            with self._lock:
                dead = self._blobs.pop(entry.key, None)
                if dead is not None:
                    self.bytes_in_use -= dead.nbytes
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        return handoff, depth

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._blobs),
                "bytes_in_use": self.bytes_in_use,
                "capacity_bytes": self.capacity_bytes,
                "puts": self.puts,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "refused": self.refused,
            }


# -- named in-process instances (the cold_store_ref knob) ---------------

_REGISTRY: dict[str, ColdKvStore] = {}
_REGISTRY_LOCK = threading.Lock()
_DEFAULT_BYTES = 64 << 20


def cold_store_from_ref(ref: str) -> ColdKvStore | None:
    """Resolve a ``cold_store_ref`` CRD/flag value to a store instance.

    ``mem://<name>[?bytes=<n>]`` names a process-global instance —
    colocated replicas (and tests/benches) sharing a ref share the
    store, which is the whole point of a fleet tier. The first
    resolver of a name fixes its capacity. Empty refs resolve to None
    (cold tier off); unknown schemes raise — a typo'd object-store URL
    must fail the rollout, not silently serve without its cold tier.
    """
    ref = str(ref or "").strip()
    if not ref:
        return None
    if not ref.startswith("mem://"):
        raise ValueError(
            f"unsupported cold_store_ref {ref!r} (only mem://<name>"
            f"[?bytes=<n>] is available in-process)")
    name, _, query = ref[len("mem://"):].partition("?")
    if not name:
        raise ValueError("cold_store_ref mem:// needs a store name")
    nbytes = _DEFAULT_BYTES
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k == "bytes" and v:
            nbytes = int(v)
    with _REGISTRY_LOCK:
        store = _REGISTRY.get(name)
        if store is None:
            store = _REGISTRY[name] = ColdKvStore(nbytes)
    return store
