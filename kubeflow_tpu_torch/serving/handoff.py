"""Prompt-KV handoff payloads for disaggregated prefill/decode serving.

Counterpart of ``kubeflow_tpu/serving/handoff.py``. A prefill replica
computes a prompt's KV once and hands the finished blocks to a decode
replica (``models/decode.py``: ``export_blocks`` / ``import_blocks``);
this module is the host-side envelope around that transfer:

- in process, the handoff dict travels as host tensors — no copies
  beyond the device-to-host fetch;
- across HTTP, :func:`pack` base64-encodes each array into a JSON-safe
  dict and :func:`unpack` restores it, with shapes and dtypes carried
  explicitly so a corrupt or mismatched payload fails at the boundary
  instead of scattering junk into the receiving pool.

The payload layout mirrors the block pool: fp pools ship ``{"k", "v"}``
arrays ``[L, nblk, Bs, H, hd]``; int8 pools ship ``{"q", "scale"}`` per
side, codes and scales together, so a quantized handoff is exact. The
payload holds every KV head whatever the exporter's mesh (a
tensor-parallel exporter joins its shards' heads), so a replica of any
shard count imports it; ``mesh.tpShards`` records the exporter's.

The envelopes are byte for byte the JAX package's, so each side unpacks
the other's. numpy has no bfloat16 (JAX takes it from ``ml_dtypes``,
which this package does not import): a bf16 array travels as its raw
16-bit pattern under the dtype name ``"bfloat16"``, written from and read
into ``torch.bfloat16`` through ``Tensor.view(torch.int16)``. :func:`unpack`
returns torch CPU tensors; :func:`pack` takes torch tensors or numpy
arrays.
"""

from __future__ import annotations

import base64

import numpy as np
import torch

# Envelope schema version: receivers reject anything newer rather than
# guess at a layout (a silent mis-parse would corrupt a KV pool).
# Version 2 added the exporter's mesh shape; version-1 envelopes (no mesh
# field) stay importable as exports of an unsharded replica.
HANDOFF_VERSION = 2
_ACCEPTED_VERSIONS = (1, 2)

BF16 = "bfloat16"


def to_host(arr) -> tuple[str, np.ndarray]:
    """(dtype name, contiguous numpy array of the raw elements) for a
    torch tensor or a numpy array; bf16 (torch, or an ``ml_dtypes`` numpy
    array) comes out as its 16-bit pattern."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BF16, t.view(torch.int16).numpy()
        return str(t.dtype).removeprefix("torch."), t.numpy()
    a = np.ascontiguousarray(arr)
    if a.dtype.name == BF16:
        return BF16, a.view(np.int16)
    return a.dtype.name, a


def to_torch(arr) -> torch.Tensor:
    """A host tensor for a numpy array (bf16 from ``ml_dtypes`` included)
    or a tensor (kept as it is)."""
    if isinstance(arr, torch.Tensor):
        return arr
    name, raw = to_host(arr)
    return from_raw(name, raw)


def from_raw(name: str, raw: np.ndarray) -> torch.Tensor:
    """Inverse of :func:`to_host`: a writable host tensor of dtype
    ``name`` over ``raw``'s elements (copied)."""
    if name == BF16:
        return torch.from_numpy(np.array(raw, dtype=np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(raw, dtype=np.dtype(name)))


def tree_to_torch(node):
    """:func:`to_torch` over a payload tree (sides, ``{"q","scale"}``)."""
    if isinstance(node, dict):
        return {k: tree_to_torch(v) for k, v in node.items()}
    return to_torch(node)


def pack_array(arr) -> dict:
    """One array as a JSON-safe ``{"dtype", "shape", "data"}`` dict
    (base64 of the raw elements), as the JAX package writes it."""
    name, a = to_host(arr)
    return {
        "dtype": name,
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def unpack_array(d: dict, what: str = "handoff") -> torch.Tensor:
    """Inverse of :func:`pack_array`: a host tensor; ``ValueError`` on a
    malformed dict."""
    if not isinstance(d, dict) or "data" not in d:
        raise ValueError(f"malformed {what} array")
    raw = base64.b64decode(d["data"])
    name = str(d["dtype"])
    try:
        dtype = np.dtype(np.int16 if name == BF16 else name)
    except TypeError:
        raise ValueError(f"unknown {what} dtype {name!r}") from None
    arr = np.frombuffer(raw, dtype=dtype)
    return from_raw(name, arr.reshape([int(s) for s in d["shape"]]))


def pack(handoff: dict) -> dict:
    """JSON-safe envelope for a decoder ``export_prompt`` result: the
    block payload's arrays (k/v, or k.q/k.scale/... when quantized)
    become base64 strings; tokens, prefix_len, block metadata and the
    exporter's mesh shape ride alongside for the receiver's checks."""
    payload = handoff["payload"]

    def _enc(node):
        if isinstance(node, dict):  # quantized side: {"q", "scale"}
            return {k: pack_array(v) for k, v in node.items()}
        return pack_array(node)

    return {
        "version": HANDOFF_VERSION,
        "tokens": [int(t) for t in handoff["tokens"]],
        "prefix_len": int(handoff["prefix_len"]),
        "block_size": int(handoff["block_size"]),
        "kv_dtype": handoff["kv_dtype"],
        "mesh": {"tpShards": int(handoff.get("tp_shards", 1) or 1),
                 "cpShards": int(handoff.get("cp_shards", 1) or 1),
                 "ppStages": int(handoff.get("pp_stages", 1) or 1)},
        "payload": {side: _enc(payload[side]) for side in ("k", "v")},
    }


def unpack(env: dict) -> dict:
    """Inverse of :func:`pack`, with the payload as torch CPU tensors.
    Raises ``ValueError`` on a malformed or version-mismatched envelope
    (the server answers 400) instead of importing garbage. Version-1
    envelopes unpack as exports of an unsharded replica."""
    if not isinstance(env, dict) or env.get("version") not in \
            _ACCEPTED_VERSIONS:
        raise ValueError(
            f"unsupported handoff envelope "
            f"version={env.get('version') if isinstance(env, dict) else env!r}")
    payload = env.get("payload")
    if not isinstance(payload, dict) or set(payload) != {"k", "v"}:
        raise ValueError("handoff payload must carry 'k' and 'v'")
    mesh = env.get("mesh") or {}
    if not isinstance(mesh, dict):
        raise ValueError("handoff mesh field must be an object")

    def _dec(node):
        if isinstance(node, dict) and "data" not in node:
            return {k: unpack_array(v) for k, v in node.items()}
        return unpack_array(node)

    return {
        "tokens": [int(t) for t in env["tokens"]],
        "prefix_len": int(env["prefix_len"]),
        "block_size": int(env["block_size"]),
        "kv_dtype": str(env.get("kv_dtype", "fp")),
        "tp_shards": int(mesh.get("tpShards", 1) or 1),
        "cp_shards": int(mesh.get("cpShards", 1) or 1),
        "pp_stages": int(mesh.get("ppStages", 1) or 1),
        "payload": {side: _dec(payload[side]) for side in ("k", "v")},
    }
