"""Replicated decoder pool with prefix-affine routing.

Counterpart of ``kubeflow_tpu/serving/fleet.py`` over this package's
:class:`~kubeflow_tpu_torch.serving.continuous.ContinuousDecoder`. The
fleet is host logic only: replicas on one card share its default CUDA
stream (none is put on a stream of its own), so their launches of the
paged decode kernel run one after another, each leaving the kernel's
split-KV arrival counters at zero for the next
(``kernels.py:_paged_counters``).

The in-process face of the fleet layer (the InferenceService operator
reconciles the same shape out of Deployments + the gateway's
``prefix-affine`` route strategy): N ``ContinuousDecoder`` replicas
behind one ``submit()``, requests placed by rendezvous hash of the
prompt's leading tokens (serving/affinity.py) so each replica's prefix
trie concentrates its own key range's hits.

Placement policy per request:

1. hash the prompt's leading ``affinity_tokens`` into a key and order
   the LIVE replicas by rendezvous score — ``order[0]`` is the affine
   replica;
2. if the affine replica is over the pressure bound (queue depth at or
   past ``pressure``, or KV pool fuller than ``kv_pressure``), spill to
   the least-loaded live replica (deterministic: depth, then rendezvous
   order breaks ties) — locality yields to an actual hotspot, but only
   then;
3. a replica whose scheduler died (submit raises, or an in-flight
   stream fails with the decoder's crash error) is marked dead and
   excluded: its keys remap to the next replica in THEIR rendezvous
   order while every other key stays put.

In-flight streams on a dead replica fail fast with
:class:`ReplicaUnavailableError` (``code=502`` — the status the gateway
relays for a dead upstream), never hang out their timeout.

Host-side composition only: the fleet never touches device state, so it
is exactly as safe as its member decoders.
"""

from __future__ import annotations

import random
import threading

from kubeflow_tpu_torch.serving import handoff as handoff_mod
from kubeflow_tpu_torch.serving.affinity import (
    DEFAULT_AFFINITY_TOKENS,
    prefix_affinity_key,
    rendezvous_order,
)
from kubeflow_tpu_torch.serving.qos import DeadlineExceeded, QosRejected


class ReplicaUnavailableError(RuntimeError):
    """A replica died under a request routed to it (HTTP-equivalent 502:
    the backend, not the request, is at fault — clients may retry, and
    the fleet has already excluded the replica)."""

    code = 502

    def __init__(self, replica: str, cause: Exception | None = None):
        super().__init__(
            f"replica {replica!r} is unavailable"
            + (f": {cause}" if cause is not None else ""))
        self.replica = replica
        self.cause = cause


class FleetHandle:
    """Caller-side view of a fleet generation: the member decoder's
    StreamHandle plus the replica it landed on. Replica death surfaces
    as :class:`ReplicaUnavailableError` (and marks the replica dead in
    the fleet) instead of the decoder's raw crash error."""

    def __init__(self, fleet: "DecoderFleet", replica: str, handle):
        self._fleet = fleet
        self.replica = replica
        self._handle = handle

    def _translate(self, err: Exception) -> Exception:
        if self._fleet._is_replica_death(err):
            self._fleet.mark_dead(self.replica, cause=err)
            return ReplicaUnavailableError(self.replica, err)
        return err

    def tokens(self, timeout: float | None = None):
        try:
            yield from self._handle.tokens(timeout)
        except Exception as e:  # noqa: BLE001 — translated and re-raised
            raise self._translate(e) from e

    def result(self, timeout: float | None = None, **kw) -> dict:
        try:
            return self._handle.result(timeout, **kw)
        except Exception as e:  # noqa: BLE001 — translated and re-raised
            raise self._translate(e) from e

    @property
    def ttft_s(self):
        return self._handle.ttft_s


class DecoderFleet:
    """N named decoder replicas behind prefix-affine routing.

    ``replicas`` maps name → a :class:`ContinuousDecoder`-shaped object
    (``submit``/``metrics``/``stop``). ``pressure`` bounds a replica's
    outstanding requests (0 = unbounded, never spill); ``kv_pressure``
    bounds its KV pool fill fraction (0 = ignore). ``router`` is
    "affine" (rendezvous, the default) or "random" (the seeded baseline
    the fleet bench compares against).

    **Disaggregated mode**: replicas carrying ``role == "prefill"``
    (the decoder's own attribute — the same knob the CRD's role
    overrides set) form a prefill pool that runs prompt admission only.
    A submit then becomes the two-hop relay: affine-pick a prefill
    replica and ``export_prompt`` the prompt's KV there, place the
    decode leg on the least-KV-loaded decode replica, ``import_prompt``
    the blocks, and submit the full prompt — which rides the ordinary
    prefix-hit admission against the imported entry, so long prompts
    never stall the decode pool's token cadence behind compute-bound
    prefill dispatches. A failed import (cache full, pool pressure)
    degrades to a plain submit — the decode replica prefills the prompt
    itself: slower, never wrong. A prefill replica dying mid-handoff
    fails that submit fast with the 502-coded error (the fleet excludes
    it; only its affinity keys remap); with the whole prefill pool dead
    the fleet degrades to colocated submits on the decode pool."""

    def __init__(self, replicas: dict, *,
                 affinity_tokens: int = DEFAULT_AFFINITY_TOKENS,
                 pressure: int = 0, kv_pressure: float = 0.0,
                 router: str = "affine", seed: int = 0,
                 weights_max_lag: int = 0):
        if not replicas:
            raise ValueError("DecoderFleet needs at least one replica")
        if router not in ("affine", "random"):
            raise ValueError(f"unknown router {router!r}")
        self._replicas = dict(replicas)
        self._roles = {
            name: getattr(d, "role", "") or ""
            for name, d in self._replicas.items()
        }
        if any(r == "prefill" for r in self._roles.values()) and not any(
                r != "prefill" for r in self._roles.values()):
            raise ValueError(
                "a disaggregated fleet needs at least one decode replica")
        self.affinity_tokens = int(affinity_tokens)
        self.pressure = int(pressure)
        self.kv_pressure = float(kv_pressure)
        self.router = router
        self._rng = random.Random(seed)
        self._dead: set[str] = set()
        self._lock = threading.Lock()
        self.routed = 0
        self.spilled = 0
        self.remapped = 0  # submits re-routed off a just-dead replica
        self.replicas_added = 0  # newborns joined via add_replica
        self.handoffs = 0           # prefill→decode KV relays completed
        self.handoff_fallbacks = 0  # degraded to a plain decode submit
        self.handoff_skipped = 0    # prompts too short to register
        # Live weight streaming: highest weights epoch any replica has
        # installed, per-replica installed epochs, and the skew bound.
        # A replica lagging the fleet by more than ``weights_max_lag``
        # pushes (0 = unbounded) is excluded from ROUTING until a later
        # push lands on it — stragglers converge on the next push, and
        # no request is ever served by weights older than the bound.
        self.weights_max_lag = int(weights_max_lag)
        self._weights_latest = 0
        self._weights_installed: dict[str, int] = {}
        self.weight_pushes = 0          # broadcast_weights calls
        self.weight_push_failures = 0   # per-replica push failures
        # Fleet KV economy: adopt the members' shared prefix directory
        # and cold store (every economy-enabled replica is constructed
        # with the SAME instances — the directory is only useful
        # fleet-wide), and close the loop by installing the in-process
        # peer-fetch path on any replica that has a directory but no
        # transport yet: a replica's submit-time probe then pulls the
        # holder's exported prefix through the handoff envelope codec,
        # exactly the bytes the HTTP ``:kv`` endpoint would ship.
        self.kv_directory = next(
            (getattr(d, "kv_directory", None)
             for d in self._replicas.values()
             if getattr(d, "kv_directory", None) is not None), None)
        self.cold_store = next(
            (getattr(d, "cold_store", None)
             for d in self._replicas.values()
             if getattr(d, "cold_store", None) is not None), None)
        for d in self._replicas.values():
            if (getattr(d, "kv_directory", None) is not None
                    and getattr(d, "_peer_fetch", None) is None):
                d._peer_fetch = self._peer_fetch

    # -- membership ----------------------------------------------------

    def members(self) -> list[str]:
        return sorted(self._replicas)

    def live_members(self) -> list[str]:
        with self._lock:
            return sorted(set(self._replicas) - self._dead)

    def role_of(self, name: str) -> str:
        return self._roles.get(name, "")

    def _warming(self, name: str) -> bool:
        return bool(getattr(self._replicas.get(name), "warming", False))

    def add_replica(self, name: str, decoder, *,
                    warming: bool = True) -> None:
        """Join a newborn replica to a RUNNING fleet (the flash-crowd
        scale-up path; construction-time membership stays the common
        case). The newborn is wired into the fleet's KV economy (shared
        directory adopted, the in-process peer-fetch transport
        installed) and its installed weights epoch is recorded from the
        decoder's own ``weights_version`` — a peer-born decoder stamped
        its donor's epoch at construction, so a concurrent rollout's
        lag accounting sees it as current, not lagging from epoch 0.

        ``warming=True`` (default) admits it via least-loaded spill
        only — no affine key share — until :meth:`mark_warm`; pass
        False for a replica already warmed (e.g. compile-cache birth
        where the dispatch set deserialized).

        Membership mutation is CONTROL-PLANE and single-writer (the
        operator's reconcile loop, a test, or the bench harness) —
        hot-path readers stay lock-free because the membership dicts
        are never mutated in place: a join builds fresh dicts and
        publishes them by atomic reference swap, so a concurrent
        route sees either the old complete snapshot or the new one,
        never a dict growing under iteration."""
        if name in self._replicas:
            raise ValueError(f"replica {name!r} already in the fleet")
        decoder.warming = bool(warming)
        role = getattr(decoder, "role", "") or ""
        with self._lock:
            self.replicas_added += 1
            ver = int(getattr(decoder, "weights_version", 0) or 0)
            if ver:
                self._weights_installed[name] = ver
        self._replicas = {**self._replicas, name: decoder}
        self._roles = {**self._roles, name: role}
        if self.kv_directory is None:
            self.kv_directory = getattr(decoder, "kv_directory", None)
        if self.cold_store is None:
            self.cold_store = getattr(decoder, "cold_store", None)
        if (getattr(decoder, "kv_directory", None) is not None
                and getattr(decoder, "_peer_fetch", None) is None):
            decoder._peer_fetch = self._peer_fetch

    def mark_warm(self, name: str) -> None:
        """Flip a newborn into full affine membership: the next route
        recomputes rendezvous order with it eligible, so exactly the
        keys that hash to it move — every other key stays put."""
        d = self._replicas.get(name)
        if d is not None:
            d.warming = False

    def donor_for(self, name: str = "") -> str | None:
        """A live, warm, non-lagging replica to pull birth weights from
        (the in-process analogue of the operator rendering lower-
        indexed siblings into ``--weight-peers``). ``name`` excludes
        the newborn itself. None when no viable donor exists — the
        caller falls back to checkpoint birth."""
        live = self._fresh(self.live_members())
        for m in live:
            if m != name and not self._warming(m):
                return m
        return None

    @property
    def disaggregated(self) -> bool:
        return any(r == "prefill" for r in self._roles.values())

    def _live_pool(self, prefill: bool) -> list[str]:
        """Live members of one role pool. Decode pool = every non-
        prefill replica (colocated replicas can take decode legs)."""
        return [m for m in self.live_members()
                if (self._roles[m] == "prefill") == prefill]

    def _fresh(self, live: list[str]) -> list[str]:
        """Drop replicas lagging the fleet's weights epoch by more than
        ``weights_max_lag`` pushes. At least one live replica always
        carries the latest epoch (it defined it), so the fallback to
        the raw list only fires when every fresh replica has since
        died — availability then beats freshness."""
        if self.weights_max_lag <= 0:
            return live
        with self._lock:
            latest = self._weights_latest
            if latest <= 0:
                return live
            fresh = [m for m in live
                     if latest - self._weights_installed.get(m, 0)
                     <= self.weights_max_lag]
        return fresh or live

    def mark_dead(self, name: str, cause: Exception | None = None) -> None:
        with self._lock:
            if name not in self._replicas:
                return
            self._dead.add(name)
        # Sweep the dead replica's directory hints OUTSIDE the fleet
        # lock (the directory carries its own leaf lock): its advertised
        # KV died with it, and a requester probing a stale hint would
        # burn a failed fetch per submit until withdrawal. Cold-tier
        # hints survive — the cold store outlives any one replica.
        if self.kv_directory is not None:
            self.kv_directory.drop_holder(name)

    def _peer_fetch(self, holder: str, tokens, version: int):
        """In-process peer KV pull (the transport the remote fleet
        replaces with the ``:kv`` HTTP endpoint): export the deepest
        cached prefix on ``holder`` and ship it as a packed handoff
        envelope — the requester unpacks, validates, and refuses it
        exactly as it would a remote one. Returns None on any miss or
        holder death; the caller withdraws the hint and falls through
        (cold tier, then prefill) — a dead holder costs one probe,
        never a hang."""
        with self._lock:
            d = self._replicas.get(holder)
            if d is None or holder in self._dead:
                return None
        try:
            h = d.export_prefix(list(tokens))
        except KeyError:
            return None  # hint was stale: holder evicted it meanwhile
        except Exception as e:  # noqa: BLE001 — death check below
            if self._is_replica_death(e):
                self.mark_dead(holder, cause=e)
            return None
        ver = h.pop("weights_version", 0)
        return {"envelope": handoff_mod.pack(h), "weights_version": ver}

    @staticmethod
    def _is_replica_death(err: Exception) -> bool:
        """The decoder's crash path (_fail_all) propagates WHATEVER
        killed the scheduler loop into every live stream — RuntimeError
        for a graceful stop, the loop's own exception otherwise — and a
        TimeoutError means the replica stopped responding. The errors
        that are the REQUEST's fault — ValueError (admission
        validation, e.g. an over-budget prompt) and QosRejected (the
        tenant is over rate; DeadlineExceeded is a TimeoutError but
        carries its own type) — must surface to the caller, not kill
        the replica."""
        return not isinstance(err, (ValueError, ReplicaUnavailableError,
                                    QosRejected, DeadlineExceeded))

    # -- placement -----------------------------------------------------

    def _depth(self, name: str) -> int:
        """Approximate outstanding load (queued + in slots). Reads the
        decoder's counters without its locks — a routing heuristic, not
        an invariant."""
        d = self._replicas[name]
        try:
            return int(getattr(d, "_active_count", 0)
                       + len(getattr(d, "_pending", ())))
        except TypeError:  # pragma: no cover — exotic replica stubs
            return 0

    def _kv_fill(self, name: str) -> float:
        d = self._replicas[name]
        alloc = getattr(d, "_alloc", None)
        if alloc is None or not getattr(alloc, "num_blocks", 0):
            return 0.0
        return alloc.blocks_in_use / alloc.num_blocks

    def _over_pressure(self, name: str) -> bool:
        if self.pressure > 0 and self._depth(name) >= self.pressure:
            return True
        return bool(self.kv_pressure > 0
                    and self._kv_fill(name) >= self.kv_pressure)

    def _route_among(self, tokens, live: list[str]) -> str:
        live = self._fresh(live)
        if not live:
            raise ReplicaUnavailableError("<none>")
        with self._lock:
            self.routed += 1
        if self.router == "random":
            with self._lock:
                return self._rng.choice(live)
        key = prefix_affinity_key(tokens, self.affinity_tokens)
        order = rendezvous_order(key, live)
        # Ramped admission: a WARMING newborn takes no affine share —
        # its keys stay on the established replicas until it reports
        # warm (then they rebalance by plain rendezvous order on the
        # next route) — but it stays in the spill pool below, so a
        # genuine hotspot can overflow onto it immediately. All-warming
        # degenerates to plain rendezvous: availability beats ramp.
        primary = next((m for m in order if not self._warming(m)),
                       order[0])
        if len(order) > 1 and self._over_pressure(primary):
            # Spill: least-loaded live replica; rendezvous order breaks
            # depth ties so the choice is deterministic for a given
            # (key, membership, load) snapshot.
            spill = min((m for m in order if m != primary),
                        key=lambda m: (self._depth(m), order.index(m)))
            if self._depth(spill) < self._depth(primary):
                with self._lock:
                    self.spilled += 1
                return spill
        return primary

    def route(self, tokens) -> str:
        """The replica a prompt should land on (no submission): affine
        pick, pressure spill, dead exclusion. In a disaggregated fleet
        this is the PREFILL hop — the affinity-bearing placement (the
        decode leg is load-placed, see :meth:`route_decode`)."""
        if self.disaggregated:
            return self.route_prefill(tokens)
        return self._route_among(tokens, self.live_members())

    def route_prefill(self, tokens) -> str:
        """Affine pick over the live prefill pool (disaggregated
        fleets): shared prefixes keep concentrating on one trie, whose
        replica now does nothing but prefill them."""
        return self._route_among(tokens, self._live_pool(prefill=True))

    def route_decode(self) -> str:
        """The decode leg's placement: least-KV-loaded live decode
        replica (real-byte fill is what binds a decode pool), depth then
        name breaking ties deterministically."""
        live = self._fresh(self._live_pool(prefill=False))
        if not live:
            raise ReplicaUnavailableError("<none>")
        return min(live, key=lambda m: (self._kv_fill(m),
                                        self._depth(m), m))

    # -- serving surface ----------------------------------------------

    def _handoff_viable(self, tokens) -> bool:
        """A handoff is worth attempting only when some live decode
        replica could register it — the exported prefix (prompt minus
        one token) must clear the decode trie's ``min_len``. Short
        long-decode prompts skip the relay entirely instead of paying
        an export that the import would refuse."""
        n = len(list(tokens)) - 1
        for m in self._live_pool(prefill=False):
            cache = getattr(self._replicas[m], "prefix_cache", None)
            if cache is not None and n >= cache.min_len:
                return True
        return False

    def _prefill_handoff(self, tokens):
        """Hop 1 of a disaggregated submit: export the prompt's KV on
        the affine prefill replica. Returns the handoff dict, or None
        when the fleet must degrade to a plain decode-side prefill
        (prefill pool entirely dead, or the export was refused).
        A replica dying UNDER the export fails this submit fast with
        the 502-coded error — the in-flight handoff is lost, the
        replica is excluded, and only its keys remap on the next
        submit."""
        if not self._live_pool(prefill=True):
            with self._lock:
                self.handoff_fallbacks += 1
            return None
        name = self.route_prefill(tokens)
        try:
            return self._replicas[name].export_prompt(tokens)
        except Exception as e:  # noqa: BLE001 — death check below
            if not self._is_replica_death(e):
                # The request's fault (e.g. a 1-token prompt): prefill
                # it on the decode side instead of failing the submit.
                with self._lock:
                    self.handoff_fallbacks += 1
                return None
            self.mark_dead(name, cause=e)
            raise ReplicaUnavailableError(name, e) from e

    def submit(self, tokens, max_new_tokens: int,
               temperature: float = 0.0, *,
               request_id: str | None = None, tenant: str = "",
               priority: int | None = None,
               deadline_ms: float = 0.0) -> FleetHandle:
        """Route and submit, re-routing (and marking dead) when the
        chosen replica's scheduler is already gone — a submit never
        fails just because one replica died. Disaggregated fleets run
        the two-hop relay first: prefill-pool export, decode-pool
        import, then the decode submit below (which prefix-hits the
        imported blocks). ``tenant``/``priority``/``deadline_ms``
        thread through to the replica's QoS admission (a QosRejected
        bubbles to the caller — an over-rate tenant is not a replica
        death)."""
        # QoS kwargs forwarded only when set, so duck-typed replicas
        # (test stubs, wrappers) without the QoS surface keep working
        # for tenant-less traffic.
        qos_kw = {}
        if tenant:
            qos_kw["tenant"] = tenant
        if priority is not None:
            qos_kw["priority"] = priority
        if deadline_ms:
            qos_kw["deadline_ms"] = deadline_ms
        handoff = None
        if self.disaggregated:
            if self._handoff_viable(tokens):
                handoff = self._prefill_handoff(tokens)
            else:
                with self._lock:
                    self.handoff_skipped += 1
        while True:
            name = (self.route_decode() if self.disaggregated
                    else self.route(tokens))
            try:
                if handoff is not None:
                    if self._replicas[name].import_prompt(handoff):
                        with self._lock:
                            self.handoffs += 1
                    else:
                        with self._lock:
                            self.handoff_fallbacks += 1
                handle = self._replicas[name].submit(
                    tokens, max_new_tokens, temperature,
                    request_id=request_id, **qos_kw)
            except Exception as e:  # noqa: BLE001 — death check below
                if not self._is_replica_death(e):
                    raise
                self.mark_dead(name, cause=e)
                with self._lock:
                    self.remapped += 1
                if not self.live_members():
                    raise ReplicaUnavailableError(name, e) from e
                continue
            return FleetHandle(self, name, handle)

    def generate(self, tokens, max_new_tokens: int,
                 temperature: float = 0.0,
                 timeout: float | None = None) -> dict:
        return self.submit(tokens, max_new_tokens, temperature).result(
            timeout)

    # -- live weight streaming ----------------------------------------

    # Fan-out bound: a fleet-wide push at scale must not spawn a thread
    # per replica — 16 concurrent host→device copies saturate the host
    # NIC/PCIe long before 100 threads would help.
    BROADCAST_MAX_WORKERS = 16

    def broadcast_weights(self, params, *, version: int | None = None,
                          draft_params=None,
                          members: list[str] | None = None) -> dict:
        """Fan a weight push out to every live replica CONCURRENTLY
        (each replica's ``update_weights`` double-buffers and swaps
        independently; one slow host→device copy must not serialize
        the fleet behind it). A replica dying mid-push is marked dead
        and excluded — the broadcast completes on the survivors, and a
        straggler that comes back converges on the NEXT push (per-
        replica installed epochs + ``weights_max_lag`` keep it out of
        routing meanwhile). A push failure that is the PUSH's fault
        (shape mismatch) is reported per replica, never kills one.

        ``members`` targets a named subset (the canary path: a rollout
        pushes the candidate epoch into a few replicas while the rest
        keep serving the incumbent); unknown names are reported in
        ``failed`` rather than raising, so a rollout racing a replica
        removal degrades to evidence instead of an exception. A subset
        push does NOT advance the fleet's notion of "every live member
        should hold latest": ``_weights_latest`` still tracks the max
        installed epoch, and members outside the subset show up in
        ``lagging`` — exactly what the rollout controller reads to
        know the canary diverged on purpose.

        Returns ``{"version", "installed": {replica: epoch},
        "failed": {replica: error}, "lagging": [replica, ...]}``."""
        from concurrent.futures import ThreadPoolExecutor

        with self._lock:
            if version is not None:
                target = int(version)
            else:
                # CLAIM the epoch under the lock, not just read it: two
                # racing auto-increment broadcasts (a rollback push vs
                # a learner's live push) that both computed latest+1
                # would install the SAME epoch with different params —
                # per-replica update_weights would then no-op whichever
                # push arrived second, leaving the fleet epoch-uniform
                # but weight-torn and undetectably so. Claiming makes
                # the second racer pick a strictly higher epoch, so the
                # race resolves by monotonicity like every other skew.
                target = self._weights_latest + 1
                self._weights_latest = target
        # Attempt EVERY member, dead included: a replica that died (or
        # was preempted) and came back converges on the next push — a
        # landed install on a replica whose scheduler is alive revives
        # it into routing.
        names = self.members()
        unknown: dict[str, str] = {}
        if members is not None:
            known = set(names)
            unknown = {m: "unknown fleet member" for m in members
                       if m not in known}
            names = [n for n in names if n in set(members)]

        def push(name):
            try:
                return name, self._replicas[name].update_weights(
                    params, version=target,
                    draft_params=draft_params), None
            except Exception as e:  # noqa: BLE001 — death check below
                return name, None, e

        installed: dict[str, int] = {}
        failed: dict[str, str] = dict(unknown)
        if names:
            workers = min(len(names), self.BROADCAST_MAX_WORKERS)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                outcomes = list(pool.map(push, names))
            for name, ver, err in outcomes:
                if err is None:
                    installed[name] = ver
                elif self._is_replica_death(err):
                    self.mark_dead(name, cause=err)
                    failed[name] = str(err)
                else:
                    failed[name] = str(err)
        with self._lock:
            self.weight_pushes += 1
            self.weight_push_failures += len(failed)
            for name, ver in installed.items():
                self._weights_installed[name] = max(
                    ver, self._weights_installed.get(name, 0))
                # Revive a previously-dead replica the push landed on —
                # unless its scheduler loop is known-stopped (a stopped
                # decoder still swaps params fine; routing to it would
                # just re-kill it).
                if not getattr(self._replicas[name], "_stopped", False):
                    self._dead.discard(name)
            if installed:
                self._weights_latest = max(self._weights_latest,
                                           max(installed.values()))
            latest = self._weights_latest
            lagging = sorted(
                m for m in set(self._replicas) - self._dead
                if latest - self._weights_installed.get(m, 0) > 0)
        return {"version": target, "installed": installed,
                "failed": failed, "lagging": lagging}

    def weights_versions(self) -> dict:
        """Per-replica installed weights epoch plus the fleet's latest
        (dashboards and the RL learner's skew check read this)."""
        with self._lock:
            return {"latest": self._weights_latest,
                    "installed": dict(self._weights_installed),
                    "max_lag": self.weights_max_lag}

    def metrics(self) -> dict:
        """Per-replica decoder metrics plus fleet aggregates (the bench
        and the autoscaler read the same names the single-decoder
        metrics() exposes, summed over live replicas)."""
        # Snapshot the mutable fleet state under its lock: mark_dead()
        # runs on caller threads mid-submit, and iterating the live set
        # while it grows is a torn read at best, a RuntimeError at
        # worst.
        with self._lock:
            dead = sorted(self._dead)
            counters = {
                "routed": self.routed, "spilled": self.spilled,
                "replicas_added": self.replicas_added,
                "remapped": self.remapped, "handoffs": self.handoffs,
                "handoff_fallbacks": self.handoff_fallbacks,
                "handoff_skipped": self.handoff_skipped,
                "weight_pushes": self.weight_pushes,
                "weight_push_failures": self.weight_push_failures,
                "weights_latest": self._weights_latest,
                "weights_installed": dict(self._weights_installed),
            }
        per: dict[str, dict] = {}
        for name in self.members():
            if name in dead:
                continue
            per[name] = self._replicas[name].metrics()
        agg_keys = ("tokens_emitted", "requests_admitted", "prefix_hits",
                    "prefix_misses", "kv_blocks_in_use", "in_flight",
                    "queued", "prefill_chunks", "prompt_rejected_too_long",
                    "prefill_tokens", "kv_peer_hits", "kv_peer_misses",
                    "kv_peer_import_bytes", "kv_peer_fetch_failures",
                    "kv_cold_hits", "kv_cold_demotions",
                    "kv_import_stale_refused")
        agg = {k: sum(m.get(k, 0) for m in per.values()) for k in agg_keys}
        if self.kv_directory is not None:
            agg["kv_directory"] = self.kv_directory.stats()
        if self.cold_store is not None:
            agg["kv_cold_store"] = self.cold_store.stats()
        agg.update(replicas=per, live=sorted(per),
                   warming=sorted(m for m in per if self._warming(m)),
                   replicas_added=counters["replicas_added"],
                   dead=dead, routed=counters["routed"],
                   spilled=counters["spilled"],
                   remapped=counters["remapped"],
                   weight_pushes=counters["weight_pushes"],
                   weight_push_failures=counters["weight_push_failures"],
                   weights_latest=counters["weights_latest"],
                   weights_installed=counters["weights_installed"])
        if self.disaggregated:
            agg.update(
                roles=dict(self._roles),
                prefill_pool=self._live_pool(prefill=True),
                decode_pool=self._live_pool(prefill=False),
                handoffs=counters["handoffs"],
                handoff_fallbacks=counters["handoff_fallbacks"],
                handoff_skipped=counters["handoff_skipped"],
            )
        return agg

    def stop(self) -> None:
        for name, d in self._replicas.items():
            try:
                d.stop()
            except Exception:  # pragma: no cover — best-effort teardown
                pass
