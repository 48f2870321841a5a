"""Live weight-push envelopes for the serving path.

Counterpart of ``kubeflow_tpu/serving/weights.py``. A learner pushes
fresh params into running decoders
(:meth:`~kubeflow_tpu_torch.serving.continuous.ContinuousDecoder.update_weights`);
this module is the host-side wire format around that push:

- in process the tree travels as host tensors or numpy arrays;
- across HTTP, :func:`pack_weights` splits the flattened tree into
  size-bounded CHUNKS of base64-encoded leaves, each chunk a
  self-describing versioned envelope POSTed at the model server's
  ``:weights`` endpoint. The server assembles chunks per weights epoch
  (:class:`WeightChunkAssembler`) and installs the tree only when the
  LAST chunk lands, so a half-received push never installs.

Leaves are keyed by their ``a/b/c`` path (``kubeflow_tpu_torch/weights.py:
path_str``, the spelling of the JAX package's ``path_str``), and the
receiver rebuilds the tree against its OWN serving params' structure:
paths it does not know, or a push that does not cover every serving
leaf, fail instead of installing a torn tree. The envelopes are the JAX
package's byte for byte, so a push packed by a JAX learner installs here
and one packed here installs into a JAX server; bf16 leaves travel as
their raw 16-bit pattern under the dtype name ``"bfloat16"``
(``serving/handoff.py``), without ``ml_dtypes``. Unpacked leaves are
torch CPU tensors.
"""

from __future__ import annotations

import json
from http.client import HTTPConnection

import torch

from kubeflow_tpu_torch.serving.handoff import (
    pack_array,
    to_torch,
    unpack_array,
)
from kubeflow_tpu_torch.weights import _unflatten, flatten

# Envelope schema version: receivers reject anything newer rather than
# guess at a layout (a mis-parsed push would install garbage weights).
WEIGHTS_ENVELOPE_VERSION = 1

# Default chunk payload bound. Small enough that a chunk never stalls a
# model server's HTTP thread for long; large enough that tiny models
# ship in one POST.
DEFAULT_CHUNK_BYTES = 8 << 20


def _host(leaf) -> torch.Tensor:
    """A host copy of one leaf (a tensor on any device, or a numpy
    array), in its own dtype."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return to_torch(leaf)


def flatten_params(params) -> dict[str, torch.Tensor]:
    """``path -> host tensor`` for a parameter tree (the port's nested
    dict of tensors, or a numpy tree in the JAX layout); device leaves
    are fetched to the host in their own dtype."""
    return {path: _host(leaf) for path, leaf in flatten(params).items()}


def unflatten_params(leaves: dict, reference):
    """Rebuild a tree shaped like ``reference`` from a ``path -> array``
    map. Raises ``ValueError`` when the push does not cover the
    reference's leaves exactly — a partial tree must never install."""
    want = list(flatten(reference))
    missing = [p for p in want if p not in leaves]
    extra = sorted(set(leaves) - set(want))
    if missing or extra:
        raise ValueError(
            f"weights push does not match the serving tree: "
            f"missing={missing[:3]}{'...' if len(missing) > 3 else ''} "
            f"extra={extra[:3]}{'...' if len(extra) > 3 else ''}")
    return _unflatten({p: leaves[p] for p in want})


def plan_chunks(items: list[tuple[str, torch.Tensor]],
                chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                ) -> list[list[tuple[str, torch.Tensor]]]:
    """Split flattened ``(path, array)`` items into chunk groups on
    leaf boundaries by cumulative payload size. Shared by the push
    packer and the donor-side pull export, so both directions of the
    transport agree on chunk count for a given tree."""
    groups: list[list[tuple[str, torch.Tensor]]] = [[]]
    size = 0
    for path, arr in items:
        nbytes = int(arr.nbytes)
        if groups[-1] and size + nbytes > max(1, int(chunk_bytes)):
            groups.append([])
            size = 0
        groups[-1].append((path, arr))
        size += nbytes
    return groups


def flatten_namespaced(params, draft_params=None,
                       ) -> list[tuple[str, torch.Tensor]]:
    """Flatten a (params, draft) pair into the namespaced ``m/``/``d/``
    item list every envelope carries."""
    items = [("m/" + p, a) for p, a in flatten_params(params).items()]
    if draft_params is not None:
        items += [("d/" + p, a)
                  for p, a in flatten_params(draft_params).items()]
    return items


def pack_chunk(group: list[tuple[str, torch.Tensor]], weights_version: int,
               seq: int, total: int, has_draft: bool) -> dict:
    """One chunk group → its self-describing envelope."""
    return {
        "version": WEIGHTS_ENVELOPE_VERSION,
        "weights_version": int(weights_version),
        "seq": int(seq),
        "chunks": int(total),
        "has_draft": bool(has_draft),
        "leaves": {p: pack_array(a) for p, a in group},
    }


def pack_weights(params, weights_version: int, *,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 draft_params=None) -> list[dict]:
    """Split ``params`` into one or more JSON-safe chunk envelopes.

    Chunks split on leaf boundaries by cumulative payload size; every
    chunk carries ``(weights_version, seq, chunks)`` so the receiver
    can assemble exactly one epoch at a time and discard a superseded
    partial push. ``draft_params`` (a paired draft model's tree) rides
    the same envelopes under a separate namespace, so target and draft
    install in the same epoch."""
    items = flatten_namespaced(params, draft_params)
    groups = plan_chunks(items, chunk_bytes)
    return [pack_chunk(group, weights_version, seq, len(groups),
                       draft_params is not None)
            for seq, group in enumerate(groups)]


def unpack_chunk(env: dict) -> dict:
    """Decode one chunk envelope. Raises ``ValueError`` on a malformed
    or version-mismatched envelope — the server answers 400 instead of
    assembling garbage."""
    if not isinstance(env, dict) or \
            env.get("version") != WEIGHTS_ENVELOPE_VERSION:
        raise ValueError(
            f"unsupported weights envelope version="
            f"{env.get('version') if isinstance(env, dict) else env!r}")
    try:
        wv = int(env["weights_version"])
        seq = int(env["seq"])
        total = int(env["chunks"])
    except (KeyError, TypeError, ValueError):
        raise ValueError("weights envelope missing version/seq/chunks"
                         ) from None
    if not 0 <= seq < total:
        raise ValueError(f"weights chunk seq {seq} outside 0..{total - 1}")
    leaves = env.get("leaves")
    if not isinstance(leaves, dict):
        raise ValueError("weights envelope carries no leaves")
    return {
        "weights_version": wv, "seq": seq, "chunks": total,
        "has_draft": bool(env.get("has_draft")),
        "leaves": {str(p): unpack_array(a, "weights")
                   for p, a in leaves.items()},
    }


class WeightChunkAssembler:
    """Per-epoch chunk assembly on the receiving server.

    Chunks of ONE weights epoch accumulate until all arrive; then
    :meth:`add` returns the complete ``(leaves, has_draft)`` and resets.
    A chunk for a NEWER epoch discards any partial older one (the
    straggler learner lost the race; it converges on the next push); a
    chunk for an older epoch than the assembling one is rejected as
    stale. Callers serialize access (the model server wraps calls in
    its own lock)."""

    def __init__(self) -> None:
        self._version: int | None = None
        self._chunks: int = 0
        self._seen: set[int] = set()
        self._leaves: dict[str, torch.Tensor] = {}
        self._has_draft = False

    @property
    def pending(self) -> int:
        """Chunks still missing for the epoch being assembled."""
        return self._chunks - len(self._seen) if self._seen else 0

    def add(self, chunk: dict) -> tuple[dict, bool] | None:
        wv = chunk["weights_version"]
        if self._version is not None and wv < self._version:
            raise ValueError(
                f"stale weights chunk for epoch {wv}; assembling "
                f"{self._version}")
        if self._version != wv:
            self._version = wv
            self._chunks = chunk["chunks"]
            self._seen = set()
            self._leaves = {}
            self._has_draft = chunk["has_draft"]
        if chunk["chunks"] != self._chunks:
            raise ValueError(
                f"weights chunk count changed mid-push "
                f"({chunk['chunks']} != {self._chunks})")
        if chunk["seq"] in self._seen:
            return None  # duplicate delivery: idempotent
        self._seen.add(chunk["seq"])
        self._leaves.update(chunk["leaves"])
        if len(self._seen) < self._chunks:
            return None
        leaves, has_draft = self._leaves, self._has_draft
        self._version, self._chunks = None, 0
        self._seen, self._leaves = set(), {}
        return leaves, has_draft


def split_namespaces(leaves: dict) -> tuple[dict, dict]:
    """Split assembled leaves into (model, draft) path maps (the
    ``m/``/``d/`` namespaces :func:`pack_weights` writes)."""
    model = {p[2:]: a for p, a in leaves.items() if p.startswith("m/")}
    draft = {p[2:]: a for p, a in leaves.items() if p.startswith("d/")}
    return model, draft


def push_weights(target: str, model: str, params, weights_version: int,
                 *, draft_params=None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 timeout: float = 60.0) -> dict:
    """POST a param pytree at ``target``'s ``:weights`` endpoint
    chunk-by-chunk (``target`` = ``host:port`` of a model server —
    learner-to-server direct, never through the gateway). Returns the
    final chunk's response dict ({"installed": bool, "weights_version":
    int}). Raises ``OSError``/``ValueError`` on transport or protocol
    failure — the caller (broadcast, operator) owns retry policy."""
    host, _, port_s = target.partition(":")
    out: dict = {}
    for env in pack_weights(params, weights_version,
                            chunk_bytes=chunk_bytes,
                            draft_params=draft_params):
        data = json.dumps(env).encode()
        conn = HTTPConnection(host, int(port_s or 80), timeout=timeout)
        try:
            conn.request("POST", f"/v1/models/{model}:weights",
                         body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise ValueError(
                    f"weights push chunk {env['seq']} refused: "
                    f"HTTP {resp.status} {body[:200]!r}")
            out = json.loads(body or b"{}")
        finally:
            conn.close()
    return out


def pull_weights(source: str, model: str, *,
                 timeout: float = 60.0) -> tuple[dict, int, bool]:
    """Pull a donor replica's param pytree over the chunked envelope —
    the push transport's other direction (replica birth): a NEWBORN asks
    a serving peer for its weights instead of touching the checkpoint
    store on the hot path.

    POSTs ``{"seq": k}`` at ``source``'s ``:pull`` endpoint chunk by
    chunk and assembles through :class:`WeightChunkAssembler`, so the
    epoch-consistency rules are the push path's exactly: every chunk
    carries the donor's weights epoch, a push landing ON THE DONOR
    mid-pull bumps the epoch and the assembler discards the partial
    older tree (the pull restarts at the new epoch — a mixed-epoch
    install is impossible by construction), and the assembled tree is
    complete or nothing.

    Returns ``(leaves, weights_version, has_draft)`` — namespaced
    leaves ready for :func:`split_namespaces`. Raises ``OSError`` /
    ``ValueError`` on a dead or misbehaving donor; the caller
    (engine birth) owns the donor-list fallback."""
    host, _, port_s = source.partition(":")
    seq = 0
    version: int | None = None
    asm = WeightChunkAssembler()
    # 2 epoch restarts tolerated: a rollout storm pushing faster than a
    # pull can drain is a donor to give up on, not to chase forever.
    restarts = 0
    while True:
        data = json.dumps({"seq": seq}).encode()
        conn = HTTPConnection(host, int(port_s or 80), timeout=timeout)
        try:
            conn.request("POST", f"/v1/models/{model}:pull", body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise ValueError(
                    f"weights pull chunk {seq} refused: "
                    f"HTTP {resp.status} {body[:200]!r}")
            env = json.loads(body)
        finally:
            conn.close()
        chunk = unpack_chunk(env)
        if version is not None and chunk["weights_version"] != version:
            # The donor swapped epochs mid-pull: restart at chunk 0 of
            # the new epoch (the assembler already dropped the partial).
            restarts += 1
            if restarts > 2:
                raise ValueError(
                    f"donor {source} kept swapping weights epochs "
                    f"mid-pull ({version} -> {chunk['weights_version']})")
            version = chunk["weights_version"]
            done = asm.add(chunk) if chunk["seq"] == 0 else None
            seq = 1 if chunk["seq"] == 0 else 0
            if done is not None:
                leaves, has_draft = done
                return leaves, version, has_draft
            continue
        version = chunk["weights_version"]
        done = asm.add(chunk)
        if done is not None:
            leaves, has_draft = done
            return leaves, version, has_draft
        seq += 1
        if seq >= chunk["chunks"]:
            raise ValueError(
                f"donor {source} never completed epoch {version}: "
                f"{asm.pending} chunks still missing after a full sweep")
