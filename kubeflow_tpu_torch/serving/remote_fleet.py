"""HTTP actor fleet for the RL learner — the cross-pod twin of
:class:`~kubeflow_tpu_torch.serving.fleet.DecoderFleet`.

Counterpart of ``kubeflow_tpu/serving/remote_fleet.py``; its requests
are the JAX package's, so it drives a model server of either package.

Inside one RLJob, learner and actors are separate gangs: the learner
pod reaches each actor's model server over HTTP (pod DNS injected by
the RLJob operator). This module is the minimal client surface the
learner loop (:mod:`kubeflow_tpu_torch.train.rl`) needs from a fleet:

- ``generate`` — one rollout over ``:predict`` (round-robin with dead-
  target exclusion; a dead actor costs throughput, never the run);
- ``broadcast_weights`` — the chunked weight push
  (:func:`kubeflow_tpu_torch.serving.weights.push_weights`'s chunks,
  encoded once) fanned out CONCURRENTLY at each actor's ``:weights``
  endpoint, straggler-tolerant with the same ``max_lag`` routing
  exclusion as the in-process fleet;
- ``metrics``/``stop`` — enough bookkeeping for the result dict.

Weight bytes travel learner→actor directly, never through the gateway.
"""

from __future__ import annotations

import json
import threading
from http.client import HTTPConnection

from kubeflow_tpu_torch.serving.affinity import (
    DEFAULT_AFFINITY_TOKENS,
    prefix_affinity_key,
)
from kubeflow_tpu_torch.serving.weights import (
    DEFAULT_CHUNK_BYTES,
    chunk_bodies,
    post_chunks,
)


class RemoteActorFleet:
    """Round-robin rollout client + weight broadcaster over HTTP
    model-server targets (``host:port`` each).

    ``kv_directory`` (optional, a
    :class:`~kubeflow_tpu_torch.serving.kv_directory.KvDirectory`) makes the
    round-robin KV-economy aware: a rollout whose prompt prefix is
    advertised by a live target lands there (the holder's trie/host
    tier already carries the bytes — RL rollouts share the task prompt,
    so this is the common case), successful rollouts publish their
    target as a holder, and a target marked dead has its hints swept —
    the same directory object the in-process fleet and the gateway
    maintain, so all three planes agree on who holds what."""

    def __init__(self, targets: list[str], model: str, *,
                 weights_max_lag: int = 0,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 timeout: float = 600.0,
                 kv_directory=None,
                 affinity_tokens: int = DEFAULT_AFFINITY_TOKENS):
        if not targets:
            raise ValueError("RemoteActorFleet needs at least one target")
        self.targets = list(targets)
        self.model = model
        self.weights_max_lag = int(weights_max_lag)
        self.chunk_bytes = int(chunk_bytes)
        self.timeout = float(timeout)
        self.kv_directory = kv_directory
        self.affinity_tokens = int(affinity_tokens)
        self._lock = threading.Lock()
        self._rr = 0
        self._dead: set[str] = set()
        self._weights_latest = 0
        self._weights_installed: dict[str, int] = {}
        self.weight_pushes = 0
        self.weight_push_failures = 0
        self.rollouts = 0
        self.directory_routed = 0  # rollouts placed on an advertised holder

    # -- routing -------------------------------------------------------

    def _live(self) -> list[str]:
        with self._lock:
            live = [t for t in self.targets if t not in self._dead]
            latest = self._weights_latest
            if self.weights_max_lag > 0 and latest > 0:
                fresh = [t for t in live
                         if latest - self._weights_installed.get(t, 0)
                         <= self.weights_max_lag]
                live = fresh or live
        return live

    def _pick(self, key: str | None = None) -> str:
        live = self._live()
        if not live:
            raise RuntimeError("every actor target is dead")
        if key is not None and self.kv_directory is not None:
            holders = [h for h in self.kv_directory.holders(key)
                       if h in live]
            if holders:
                with self._lock:
                    self.directory_routed += 1
                    return holders[0]  # deepest advertised prefix
        with self._lock:
            self._rr += 1
            return live[self._rr % len(live)]

    def add_target(self, target: str) -> None:
        """Join a newborn actor address to the rotation (the
        flash-crowd scale-up path — the operator scaled the pool and
        the new pod's DNS just resolved). Its installed weights epoch
        converges on the next broadcast; until then the max-lag
        exclusion treats it exactly like any straggler.

        Control-plane, single-writer: the rotation list is published
        by atomic reference swap (never mutated in place), so the
        lock-free pick path sees a complete snapshot either way."""
        with self._lock:
            self._dead.discard(target)
        if target not in self.targets:
            self.targets = [*self.targets, target]

    def donors(self, exclude: str = "") -> list[str]:
        """Live, non-lagging targets ordered for a newborn's
        ``--weight-peers`` fallback chain (each is a valid source for
        :func:`kubeflow_tpu_torch.serving.weights.pull_weights`); ``exclude``
        drops the newborn's own address."""
        return [t for t in self._live() if t != exclude]

    def _mark_dead(self, target: str) -> None:
        with self._lock:
            self._dead.add(target)
        if self.kv_directory is not None:
            # The target's advertised KV died with its process; stale
            # hints would keep steering rollouts at a dead pod.
            self.kv_directory.drop_holder(target)

    # -- rollouts ------------------------------------------------------

    def generate(self, tokens, max_new_tokens: int,
                 temperature: float = 0.0,
                 timeout: float | None = None) -> dict:
        body = json.dumps({"instances": [{
            "tokens": [int(t) for t in tokens],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
        }]}).encode()
        key = (prefix_affinity_key(tokens, self.affinity_tokens)
               if self.kv_directory is not None else None)
        last_err: Exception | None = None
        for _ in range(len(self.targets)):
            target = self._pick(key)
            host, _, port_s = target.partition(":")
            try:
                conn = HTTPConnection(host, int(port_s or 80),
                                      timeout=timeout or self.timeout)
                try:
                    conn.request(
                        "POST", f"/v1/models/{self.model}:predict",
                        body=body,
                        headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    payload = json.loads(resp.read() or b"{}")
                finally:
                    conn.close()
                if resp.status != 200:
                    raise OSError(
                        f"{target} answered {resp.status}: "
                        f"{payload.get('error', '')}")
                pred = payload["predictions"][0]
                with self._lock:
                    self.rollouts += 1
                if key is not None:
                    # The served prompt's prefix now lives in the
                    # target's trie (its decoder pools finishing
                    # prompts) — advertise it so the next rollout
                    # sharing the prompt lands on the warm replica.
                    self.kv_directory.publish(
                        key, target,
                        prefix_len=max(len(list(tokens)) - 1, 0),
                        tier="route")
                return {"tokens": pred.get("tokens", []),
                        "finish_reason": pred.get("finish_reason", "")}
            except (OSError, ValueError, KeyError, IndexError) as e:
                last_err = e
                self._mark_dead(target)
        raise RuntimeError(
            f"every actor target failed; last error: {last_err}")

    def fetch_kv(self, target: str, tokens, version: int = 0):
        """Peer KV pull over HTTP — the cross-pod transport for a
        decoder's ``peer_fetch`` hook, shaped to its contract: POST the
        prompt at the holder's ``:kv`` endpoint and return
        ``{"envelope": <packed handoff>, "weights_version": v}``, or
        None on any failure (404 = the holder no longer caches the
        prefix; the requester withdraws the hint and falls through).
        ``version`` rides along so the holder can refuse the export
        outright when its own epoch already moved past the
        requester's."""
        host, _, port_s = str(target).partition(":")
        body = json.dumps({"tokens": [int(t) for t in tokens],
                           "weights_version": int(version)}).encode()
        try:
            conn = HTTPConnection(host, int(port_s or 80),
                                  timeout=self.timeout)
            try:
                conn.request("POST", f"/v1/models/{self.model}:kv",
                             body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
        except (OSError, ValueError):
            self._mark_dead(target)
            return None
        if resp.status != 200 or "envelope" not in payload:
            return None
        return {"envelope": payload["envelope"],
                "weights_version": int(payload.get("weights_version", 0))}

    # -- weight streaming ---------------------------------------------

    def broadcast_weights(self, params, *, version: int | None = None,
                          draft_params=None,
                          members: list[str] | None = None) -> dict:
        from concurrent.futures import ThreadPoolExecutor

        with self._lock:
            if version is not None:
                target_v = int(version)
            else:
                # Claim under the lock (see DecoderFleet.broadcast_
                # weights): racing auto-increment pushes must pick
                # distinct epochs or the loser tears the fleet.
                target_v = self._weights_latest + 1
                self._weights_latest = target_v
        # Attempt every target, dead included: an actor pod that
        # restarted behind the same DNS converges on the next push.
        live = list(self.targets)
        unknown: dict[str, str] = {}
        if members is not None:
            # Targeted-subset push (the canary path) — same contract as
            # DecoderFleet.broadcast_weights(members=...).
            known = set(live)
            unknown = {m: "unknown fleet target" for m in members
                       if m not in known}
            live = [t for t in live if t in set(members)]

        # Encoded once, not once a target: the encoding holds the GIL,
        # so the targets' threads would take turns at it.
        bodies = chunk_bodies(params, target_v, draft_params=draft_params,
                              chunk_bytes=self.chunk_bytes) if live else []

        def push(addr):
            try:
                out = post_chunks(addr, self.model, bodies,
                                  timeout=self.timeout)
                return addr, int(out.get("weights_version", target_v)), \
                    None
            except Exception as e:  # noqa: BLE001 — recorded per target
                return addr, None, e

        installed: dict[str, int] = {}
        failed: dict[str, str] = dict(unknown)
        if live:
            with ThreadPoolExecutor(max_workers=min(len(live), 16)) as pool:
                for addr, ver, err in pool.map(push, live):
                    if err is None:
                        installed[addr] = ver
                    else:
                        failed[addr] = str(err)
        with self._lock:
            self.weight_pushes += 1
            self.weight_push_failures += len(failed)
            for addr, ver in installed.items():
                self._weights_installed[addr] = max(
                    ver, self._weights_installed.get(addr, 0))
                self._dead.discard(addr)  # a landed push revives it
            if installed:
                self._weights_latest = max(self._weights_latest,
                                           max(installed.values()))
            latest = self._weights_latest
            lagging = sorted(
                t for t in self.targets if t not in self._dead
                and latest - self._weights_installed.get(t, 0) > 0)
        return {"version": target_v, "installed": installed,
                "failed": failed, "lagging": lagging}

    # -- bookkeeping ---------------------------------------------------

    def metrics(self) -> dict:
        with self._lock:
            return {
                "targets": list(self.targets),
                "dead": sorted(self._dead),
                "rollouts": self.rollouts,
                "directory_routed": self.directory_routed,
                "weight_pushes": self.weight_pushes,
                "weight_push_failures": self.weight_push_failures,
                "weights_latest": self._weights_latest,
                "weights_installed": dict(self._weights_installed),
            }

    def stop(self) -> None:
        """Remote actors have their own lifecycle (the RLJob operator
        tears the pool down); nothing to stop client-side."""
