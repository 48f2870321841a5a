"""Ring attention: exact attention over the ``sequence`` mesh axis;
counterpart of ``kubeflow_tpu/parallel/ring_attention.py``.

Each rank of a ``sequence`` group holds one chunk of the queries, keys and
values of its rows; the K/V chunks go round the ring (:func:`ring_permute`
by -1, JAX's ``ppermute`` pairs ``(j, j - 1)``), so at step ``i`` rank
``idx`` folds the chunk of rank ``(idx + i) % n`` into its online-softmax
state (:func:`_block_attn`, float32 whatever the input dtype). Masks are
in global positions (:func:`_causal_bias`, :func:`span_bias`), with the
finite ``-1e30`` of JAX: a block that masks a row wholly folds junk with
weight one, which the first block that admits a key scales to exact zero
(``-inf`` would give ``NaN``).

JAX's fold is XLA einsums inside ``shard_map``, outside any Pallas kernel,
so it is plain PyTorch here on every device, differentiable: the permute
carries its gradient (the permute by +1). K and V travel as one buffer, so
a step is one permute in the forward and one in the backward, in the same
order on every rank. JAX permutes after the last block too and drops what
arrives; the port skips that permute (``n - 1`` a call), the same
function.

Each process holds its rows already (the batch over data x fsdp is the
process's place on the mesh), so :func:`ring_attention` takes this rank's
``[B, H, T_local, D]`` chunk and returns its chunk of the output.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.parallel.collectives import ring_permute
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_SEQUENCE,
    axis_index,
    axis_size,
)

_NEG_INF = -1e30


def _block_attn(q, k, v, bias, m_prev, num_prev, den_prev, scale):
    """Fold one K/V block into the running online-softmax state.

    q: [B, H, Tq, D]; k, v: [B, H, Tk, D]; bias: an additive mask
    broadcastable to [B, H, Tq, Tk]. State: running max m [B, H, Tq, 1],
    numerator [B, H, Tq, D], denominator [B, H, Tq, 1], all float32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale + bias
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    correction = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new)
    num = num_prev * correction + torch.einsum("bhqk,bhkd->bhqd", p,
                                               v.float())
    den = den_prev * correction + p.sum(dim=-1, keepdim=True)
    return m_new, num, den


def _causal_bias(q_start, k_start, tq: int, tk: int, device=None):
    """[Tq, Tk] float32: 0 where query ``q_start + i`` sees key
    ``k_start + j`` (``j <= i`` globally), -1e30 elsewhere."""
    q_pos = q_start + torch.arange(tq, device=device)[:, None]
    k_pos = k_start + torch.arange(tk, device=device)[None, :]
    return torch.where(q_pos >= k_pos, 0.0, _NEG_INF).float()


def span_bias(pos, q_start, k_start, tq: int, tk: int):
    """Per-row span mask of the chunked-prefill ring: query token ``i``
    of row ``b`` sits at global position ``pos[b] + q_start + i`` and
    attends keys at global positions ``<=`` its own. [B, Tq, Tk]
    float32; add a head dim before :func:`_block_attn`."""
    dev = pos.device
    q_pos = (pos.long()[:, None, None] + q_start
             + torch.arange(tq, device=dev)[None, :, None])
    k_pos = k_start + torch.arange(tk, device=dev)[None, None, :]
    return torch.where(q_pos >= k_pos, 0.0, _NEG_INF).float()


def _init_state(q):
    b, h, t, d = q.shape
    return (torch.full((b, h, t, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, t, 1), dtype=torch.float32, device=q.device))


def ring_attention(q, k, v, mesh, *, causal: bool = True,
                   axis: str = AXIS_SEQUENCE):
    """Exact attention over the ``axis`` ring. q, k, v: this rank's
    ``[B, H, T_local, D]`` chunk (the rank's index along ``axis`` is its
    chunk's place in the sequence); returns its chunk of the output in
    q's dtype. Every rank of the ring calls it at the same point; without
    a mesh it is the one-chunk fold."""
    n = 1 if mesh is None else axis_size(mesh, axis)
    idx = 0 if mesh is None else axis_index(mesh, axis)
    t_local, d = q.shape[2], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    q32 = q.float()
    kv = torch.stack([k.float(), v.float()])
    m, num, den = _init_state(q32)
    for i in range(n):
        # Block i arrived from rank (idx + i) mod n: its global offset.
        src = (idx + i) % n
        if causal:
            bias = _causal_bias(idx * t_local, src * t_local, t_local,
                                t_local, q.device)
        else:
            bias = torch.zeros((t_local, t_local), dtype=torch.float32,
                               device=q.device)
        m, num, den = _block_attn(q32, kv[0], kv[1], bias, m, num, den,
                                  scale)
        if i < n - 1:
            # Pull the next block from the right neighbour.
            kv = ring_permute(kv, mesh, axis, shift=-1)
    return (num / den).to(q.dtype)


def reference_attention(q, k, v, *, causal: bool = True):
    """Unsharded O(T^2) attention, the oracle of the ring. [B, H, T, D]."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        s = s + _causal_bias(0, 0, s.shape[-2], s.shape[-1], q.device)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
