"""Prefix-affine fleet routing primitives: rendezvous hashing + keys.

A copy of ``kubeflow_tpu/serving/affinity.py`` (pure host logic, no JAX),
kept in this package so the port imports nothing of the JAX one. The
digests are the JAX package's bit for bit: the gateway routes on them and
the fleet KV directory keys on them, so both packages place a prompt on
the same replica.

A replicated decoder pool wants *cache-aware* placement, not round-robin:
`serving/prefix_cache.py` holds each replica's prefix trie on-replica, so
requests sharing a leading-token prefix should concentrate on ONE replica
(its trie warms once and keeps hitting) instead of shattering the prefix
across the fleet. The routing key is therefore a digest of the prompt's
leading tokens, and placement is highest-random-weight (rendezvous)
hashing over the live replica set:

- every (key, replica) pair gets a stable score ``H(replica | key)``;
  the key routes to the top-scoring live replica;
- membership change moves ONLY the keys whose top replica changed —
  ~1/N of keys on scale-up/down, the dead replica's keys on failure —
  while every other key keeps its warm trie (the property consistent
  hashing buys over ``hash(key) % N``).

Digests are BLAKE2 (process- and seed-independent), so the gateway, the
in-process fleet, and a future disaggregated router all place the same
key on the same replica. Pure host logic, no jax — importable by the
gateway without touching the serving stack's device deps.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence

DEFAULT_AFFINITY_TOKENS = 32


def prefix_affinity_key(tokens: Sequence[int],
                        width: int = DEFAULT_AFFINITY_TOKENS) -> str:
    """Routing key for a prompt: digest of its leading ``width`` token
    ids. Prompts sharing those leading tokens share the key (and so the
    replica, and so the prefix-cache entry); ``width`` should be at
    least the deployment's ``prefix_cache_min_len`` so every cacheable
    prefix maps to one key."""
    head = ",".join(str(int(t)) for t in list(tokens)[: max(int(width), 1)])
    return hashlib.blake2b(head.encode(), digest_size=8).hexdigest()


def _score(key: str, member: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(f"{member}|{key}".encode(), digest_size=8).digest(),
        "big")


def rendezvous_order(key: str, members: Iterable[str]) -> list[str]:
    """Members ordered by descending rendezvous score for ``key`` (ties
    broken by name for determinism). ``order[0]`` is the affine replica;
    the tail is the deterministic spill/failover sequence — excluding a
    dead member never reorders the survivors."""
    return sorted(members, key=lambda m: (-_score(key, m), m))


def rendezvous_pick(key: str, members: Iterable[str]) -> str | None:
    """The affine replica for ``key`` among ``members`` (None if empty)."""
    order = rendezvous_order(key, members)
    return order[0] if order else None
