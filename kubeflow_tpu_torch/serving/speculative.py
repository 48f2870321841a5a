"""Draft-token proposers for speculative decoding.

Counterpart of ``kubeflow_tpu/serving/speculative.py``. The continuous
decoder's verify path (``models/decode.py``: ``verify_step`` /
``verify_chunk``) scores K cheap draft tokens per dispatch; the drafts come
from here, behind one ``propose`` surface:

- :class:`NgramProposer`: "prompt lookup" drafting, the continuation that
  followed the most recent earlier occurrence of the context's trailing
  n-gram. Host logic only, no device memory, no model.
- :class:`DraftModelProposer`: a small registry model
  (``draft_mode="model:<name>"``) holding its own dense decode state over
  the target's slot layout. Each round is one call of
  ``extend_and_propose``: force-feed the tokens the target committed since
  the last round (which overwrites whatever the target rejected: the feed
  position IS the rollback), then decode the next proposals greedily.

Proposals are hints, never promises: verification keeps only what the
target itself would have produced, so a wrong draft costs compute, not
correctness.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.decode import (
    extend_and_propose,
    init_decode_state,
)
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving.engine import pow2_bucket


class NgramProposer:
    """Host-side prompt/output n-gram lookup.

    ``propose`` scans the context for the most recent earlier occurrence
    of its trailing ``m``-gram (longest match first, ``max_match`` down
    to ``min_match``) and proposes the tokens that followed it.
    """

    def __init__(self, max_match: int = 3, min_match: int = 1):
        self.max_match = max(1, int(max_match))
        self.min_match = max(1, min(int(min_match), self.max_match))
        self.dispatches = 0  # n-gram drafting never touches the device

    def reset(self, slot: int) -> None:  # per-slot state: none
        pass

    def install_weights(self, params) -> None:
        """N-gram drafting has no weights: a no-op."""

    def _lookup(self, context: list[int], n: int) -> list[int]:
        if n <= 0:
            return []
        for m in range(self.max_match, self.min_match - 1, -1):
            if len(context) <= m:
                continue
            pat = context[-m:]
            # Rightmost occurrence strictly before the trailing one.
            for i in range(len(context) - m - 1, -1, -1):
                if context[i:i + m] == pat:
                    seg = context[i + m: i + m + n]
                    if seg:
                        return seg
                    break  # the match butts against the tail: shorter m
        return []

    def propose(self, requests: list[tuple[int, list[int], int]],
                ) -> dict[int, list[int]]:
        """``requests``: (slot, context tokens, max proposal length) per
        live row → slot -> proposed tokens (possibly empty)."""
        return {slot: self._lookup(ctx, n) for slot, ctx, n in requests}


class DraftModelProposer:
    """Small draft model sharing the target's slot layout.

    Keeps a private dense decode state (``slots`` rows of the target's
    ``total_len``) for the draft model, in its preset's dtype, and
    tracks per slot how many of the request's committed tokens its cache
    already holds. Weights come from the preset's ``init`` with a
    generator seeded ``seed`` on ``device`` (the engine's recipe), or
    from :meth:`install_weights`.
    """

    def __init__(self, model_name: str, target_vocab: int, slots: int,
                 total_len: int, propose_steps: int, seed: int = 0, *,
                 device="cuda"):
        spec = get_model(model_name)
        if spec.family != "transformer":
            raise ValueError(f"draft model {model_name!r} is {spec.family}, "
                             "need a transformer")
        if spec.config.vocab_size != target_vocab:
            raise ValueError(
                f"draft model {model_name!r} vocab "
                f"{spec.config.vocab_size} != target vocab {target_vocab}")
        dev = resolve_device(device)
        self.cfg = spec.config
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.params = spec.init(self.cfg, generator=gen, device=dev)
        self.device = dev
        self.slots = slots
        self.total_len = total_len
        self.propose_steps = max(1, int(propose_steps))
        self.state = init_decode_state(self.cfg, slots, total_len, seed,
                                       device=dev)
        self._fed = [0] * slots  # context tokens already in the draft cache
        self.dispatches = 0

    def reset(self, slot: int) -> None:
        """A new request took ``slot``: its whole prompt is pending feed
        (the stale cache content is overwritten as the feed advances)."""
        self._fed[slot] = 0

    def install_weights(self, params) -> None:
        """Swap in draft weights already placed on the device (a tree of
        the package's layout). The draft cache is kept: what was fed were
        committed target tokens either way."""
        self.params = params

    def propose(self, requests: list[tuple[int, list[int], int]],
                ) -> dict[int, list[int]]:
        if not requests:
            return {}
        pend = {slot: max(len(ctx) - self._fed[slot], 0)
                for slot, ctx, _n in requests}
        width = pow2_bucket(max(max(pend.values()), 1), cap=self.total_len)
        feed = np.zeros((self.slots, width), np.int32)
        # Unused rows park at the cache end: their writes drop.
        pos = np.full((self.slots,), self.total_len, np.int32)
        lens = np.zeros((self.slots,), np.int32)
        for slot, ctx, _n in requests:
            p = min(pend[slot], width)
            seg = ctx[self._fed[slot]: self._fed[slot] + p]
            feed[slot, : len(seg)] = seg
            pos[slot] = self._fed[slot]
            lens[slot] = len(seg)
            self._fed[slot] += len(seg)
        self.state, props = extend_and_propose(
            self.state, self.params, self.cfg,
            *(torch.from_numpy(x).to(self.device) for x in (feed, pos, lens)),
            self.propose_steps)
        self.dispatches += 1
        props = props.cpu().numpy()
        return {slot: props[slot, :n].tolist() for slot, _ctx, n in requests}


def make_proposer(draft_mode: str, *, target_vocab: int, slots: int,
                  total_len: int, propose_steps: int, seed: int = 0,
                  device="cuda"):
    """``draft_mode`` → proposer: ``"ngram"`` or ``"model:<registry-name>"``
    (the ``--draft-mode`` flag). A draft model lives on ``device``."""
    if draft_mode == "ngram":
        return NgramProposer()
    if draft_mode.startswith("model:"):
        return DraftModelProposer(
            draft_mode[len("model:"):], target_vocab, slots, total_len,
            propose_steps, seed=seed, device=device)
    raise ValueError(f"unknown draft_mode {draft_mode!r}; expected 'ngram' "
                     "or 'model:<registry-name>'")
