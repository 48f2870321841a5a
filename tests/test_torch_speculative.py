"""The port's speculative decoding against the JAX package's: the dense
span forward, ``verify_step`` / ``verify_chunk`` on the dense and paged
(gathered and fused) layouts, ``extend_and_propose``, the n-gram and
draft-model proposers, and the continuous decoder's speculation rounds.

Both packages get the same weights (the JAX init, handed across as numpy
arrays) at ``dtype=float32`` on the CPU, and the same numpy states.
Logits, caches and pools agree within 1e-5; tokens, emitted masks, row
scalars, greedy streams and the n-gram ``spec_*`` counters exactly.
Sampled acceptance draws from a torch generator where JAX splits its
threefry key, so it is held to the target distribution instead.
"""

import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kubeflow_tpu.models.decode as jdecode  # noqa: E402
from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu.serving.speculative import (  # noqa: E402
    NgramProposer as JaxNgram,
)
from kubeflow_tpu_torch.models import decode as tdecode  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501
from kubeflow_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.serving.speculative import (  # noqa: E402
    DraftModelProposer,
    NgramProposer,
    make_proposer,
)
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SLOTS, TOTAL, K = 4, 24, 4
NB, BS = 16, 8  # paged: 16 blocks of 8, rows of 3 blocks = TOTAL
TABLE = np.array([[3, 0, 7], [1, 9, 12], [2, 4, 6], [5, 8, 10]], np.int32)
# Slot 0 an ordinary row, slot 1 with 2 tokens of budget left, slot 2 at
# TOTAL - 2 (a 21-token prompt plus the admission's decode step), slot 3
# parked.
PROMPT_LENS = (5, 3, 21, 4)
BUDGETS = (9, 3, 9, 9)
LAYOUTS = [("dense", False), ("paged", False), ("paged", True)]
LAYOUT_IDS = ["dense", "gathered", "fused"]


@pytest.fixture(scope="module")
def models():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _jax_copy(state):
    return jax.tree.map(lambda x: jnp.array(np.array(x)), state)


def _admitted_state(models, layout):
    """A JAX decode state (dense, or paged over TABLE) holding the four
    rows above, as numpy."""
    jcfg, jparams, _, _ = models
    rng = np.random.default_rng(3)
    toks = np.zeros((SLOTS, max(PROMPT_LENS)), np.int32)
    for i, n in enumerate(PROMPT_LENS):
        toks[i, :n] = rng.integers(1, jcfg.vocab_size, n)
    args = (jnp.arange(SLOTS, dtype=jnp.int32), jnp.asarray(toks),
            jnp.asarray(PROMPT_LENS, jnp.int32),
            jnp.asarray(BUDGETS, jnp.int32), jnp.zeros((SLOTS,), jnp.float32))
    if layout == "dense":
        st = jdecode.init_decode_state(jcfg, SLOTS, TOTAL)
        st, *_ = jdecode.admit_rows_and_step(st, jparams, jcfg, *args)
    else:
        st = jdecode.init_paged_state(jcfg, SLOTS, NB, BS, TABLE.shape[1])
        st["block_table"] = jnp.asarray(TABLE)
        st, *_ = jdecode.paged_admit_rows_and_step(st, jparams, jcfg, *args)
    st = jdecode.retire_row(st, jnp.int32(3))
    st = _np_tree(st)
    assert list(st["length"]) == [6, 4, TOTAL - 2, TOTAL]
    return st


def _port_state(np_state, tcfg, seed=0):
    """The port's state over the same numpy arrays."""
    if "pool" in np_state:
        st = tdecode.init_paged_state(tcfg, SLOTS, NB, BS, TABLE.shape[1],
                                      seed, device="cpu")
        st["block_table"].copy_(torch.from_numpy(np_state["block_table"]))
        kv = st["pool"]
        src = np_state["pool"]
    else:
        st = tdecode.init_decode_state(tcfg, SLOTS, TOTAL, seed, device="cpu")
        kv = st["cache"]
        src = np_state["cache"]
    for side in ("k", "v"):
        kv[side].copy_(torch.from_numpy(src[side]))
    for key in ("length", "remaining", "active", "temperature",
                "last_logits"):
        st[key].copy_(torch.from_numpy(np_state[key]))
    return st


def _kv(state):
    side = "pool" if "pool" in state else "cache"
    return {s: np.asarray(state[side][s]) for s in ("k", "v")}


def _chain(models, np_state, steps=6):
    """Each row's greedy continuation (JAX decode steps on a copy)."""
    jcfg, jparams, _, _ = models
    _, toks, _ = jdecode.decode_chunk(_jax_copy(np_state), jparams, jcfg,
                                      steps)
    return np.asarray(toks).T  # [slots, steps]


def _drafts(chain):
    """Row 0 right twice then wrong, rows 1-2 all right (the budget and
    the cache end cap them), row 3 (parked) anything."""
    d = chain[:, :K].copy()
    d[0, 2] = (d[0, 2] + 1) % 256
    d[3] = [1, 2, 3, 4]
    return d


def _assert_verify_equal(t_out, j_out, t_state, j_state):
    (ts, tt, te), (js, jt, je) = t_out, j_out
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    for key in ("length", "remaining", "active"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                      err_msg=key)
    np.testing.assert_allclose(ts["last_logits"].numpy(),
                               np.asarray(js["last_logits"]), **TOL)
    for side, arr in _kv(ts).items():
        np.testing.assert_allclose(arr, _kv(j_state)[side], err_msg=side,
                                   **TOL)


def _assert_untouched(before, after, layout):
    """The parked row, and every position before slot 2's span, are byte
    for byte what they were: no dropped write landed."""
    for side in ("k", "v"):
        a, b = before[side], after[side]
        if layout == "dense":
            np.testing.assert_array_equal(a[:, 3], b[:, 3])
            np.testing.assert_array_equal(a[:, 2, : TOTAL - 2],
                                          b[:, 2, : TOTAL - 2])
        else:
            np.testing.assert_array_equal(a[:, TABLE[3]], b[:, TABLE[3]])
            free = sorted(set(range(NB)) - set(TABLE.ravel()))
            np.testing.assert_array_equal(a[:, free], b[:, free])
            np.testing.assert_array_equal(a[:, TABLE[2, :2]],
                                          b[:, TABLE[2, :2]])


# ---------------------------------------------------------------------------
# The dense span forward
# ---------------------------------------------------------------------------


def test_dense_block_forward_matches_jax_including_a_spill(models):
    """Row 0 spans 29..34 of a 32-position row (three columns spill past
    it and drop), row 1 is parked at 32 (every write drops), row 2 starts
    at 0; what no column may reach stays byte for byte."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    shape = (jcfg.n_layers, 3, 32, jcfg.n_kv_heads, jcfg.head_dim)
    caches = {s: rng.standard_normal(shape).astype(np.float32) for s in "kv"}
    toks = np.array([[5, 9, 2, 7, 1, 3], [3, 3, 8, 1, 2, 2],
                     [8, 1, 4, 4, 2, 6]], np.int32)
    pos = np.array([29, 32, 0], np.int32)
    jl, jk, jv = jdecode._block_forward(
        jparams, jcfg, jnp.asarray(caches["k"]), jnp.asarray(caches["v"]),
        jnp.asarray(toks), jnp.asarray(pos), jnp.ones(toks.shape, bool))
    tk, tv = (torch.from_numpy(caches[s].copy()) for s in "kv")
    tl = tdecode._block_forward(tparams, tcfg, tk, tv,
                                torch.from_numpy(toks),
                                torch.from_numpy(pos), None)
    np.testing.assert_allclose(tl[[0, 2]].numpy(), np.asarray(jl)[[0, 2]],
                               **TOL)
    for got, want, before in ((tk, jk, caches["k"]), (tv, jv, caches["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(got[:, 1].numpy(), before[:, 1])
        np.testing.assert_array_equal(got[:, 0, :29].numpy(),
                                      before[:, 0, :29])
        np.testing.assert_array_equal(got[:, 2, 6:].numpy(),
                                      before[:, 2, 6:])


# ---------------------------------------------------------------------------
# verify_step / verify_chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eos", [False, True], ids=["no-eos", "eos"])
@pytest.mark.parametrize("layout,fused", LAYOUTS, ids=LAYOUT_IDS)
def test_verify_step_matches_jax(models, layout, fused, eos):
    """Partial acceptance (slot 0), the budget cap (slot 1), the cache-end
    cap with a scoring pass that spills two columns past the row (slot
    2 at TOTAL - 2, K = 4) and a parked row (slot 3). With ``eos`` the
    EOS is slot 0's second accepted draft: the row stops on it and parks
    at TOTAL."""
    jcfg, jparams, tcfg, tparams = models
    np_state = _admitted_state(models, layout)
    chain = _chain(models, np_state)
    draft = _drafts(chain)
    dlen = np.array([K, K, K, K], np.int32)
    eos_id = int(chain[0, 1]) if eos else None
    before = _kv(np_state)
    js, jt, je = jdecode.verify_step(_jax_copy(np_state), jparams, jcfg,
                                     jnp.asarray(draft), jnp.asarray(dlen),
                                     eos_id=eos_id, kv_fused=fused)
    ts = _port_state(np_state, tcfg)
    t_out = tdecode.verify_step(ts, tparams, tcfg, torch.from_numpy(draft),
                                torch.from_numpy(dlen), eos_id=eos_id,
                                kv_fused=fused)
    _assert_verify_equal(t_out, (js, jt, je), ts, js)
    _assert_untouched(before, _kv(ts), layout)
    emitted = t_out[2].numpy()
    out = t_out[1].numpy()
    assert emitted.sum(1).tolist() == ([2, 2, 2, 0] if eos else [3, 2, 2, 0])
    assert out[0, :2].tolist() == chain[0, :2].tolist()
    if eos:
        assert int(ts["length"][0]) == TOTAL and not bool(ts["active"][0])
    else:
        assert out[0, 2] == chain[0, 2]  # the correction after the miss
    assert out[2, :2].tolist() == chain[2, :2].tolist()
    assert not ts["active"][[1, 2, 3]].any()


@pytest.mark.parametrize("layout,fused", LAYOUTS, ids=LAYOUT_IDS)
def test_verify_chunk_of_two_matches_jax(models, layout, fused):
    """Two verify steps in one call; the second step's slice starts after
    the first step's commit token, as the decoder lays it out."""
    jcfg, jparams, tcfg, tparams = models
    np_state = _admitted_state(models, layout)
    chain = _chain(models, np_state, steps=8)
    first = chain[:, :2]
    second = chain[:, 3:5]  # chain[:, 2] is the first step's commit
    drafts = np.stack([first, second]).astype(np.int32)
    dlens = np.full((2, SLOTS), 2, np.int32)
    dlens[:, 3] = 0
    js, jt, je = jdecode.verify_chunk(_jax_copy(np_state), jparams, jcfg,
                                      jnp.asarray(drafts),
                                      jnp.asarray(dlens), kv_fused=fused)
    ts = _port_state(np_state, tcfg)
    t_out = tdecode.verify_chunk(ts, tparams, tcfg, torch.from_numpy(drafts),
                                 torch.from_numpy(dlens), kv_fused=fused)
    _assert_verify_equal(t_out, (js, jt, je), ts, js)
    toks, emitted = t_out[1].numpy(), t_out[2].numpy()
    got = [t for s in range(2) for t, e in zip(toks[s, 0], emitted[s, 0])
           if e]
    assert got == chain[0, :6].tolist()  # 2 + commit, twice


def test_verify_greedy_stays_on_the_decode_chain(models):
    """Perfect drafts: one verify emits K accepted tokens and the commit,
    all equal to the plain decode chain, and plain steps continue it."""
    jcfg, _, tcfg, tparams = models
    np_state = _admitted_state(models, "dense")
    chain = _chain(models, np_state, steps=8)
    ts = _port_state(np_state, tcfg)
    draft = torch.from_numpy(chain[:, :K].astype(np.int32))
    _, out, emitted = tdecode.verify_step(ts, tparams, tcfg, draft,
                                          torch.tensor([K, 0, 0, 0]))
    assert out[0].tolist() == chain[0, : K + 1].tolist()
    assert emitted[0].all()
    for j in range(K + 1, 8):
        _, tok, _ = tdecode.decode_step(ts, tparams, tcfg)
        assert int(tok[0]) == chain[0, j]


def _sampled_state(tcfg, tparams, rows, logits, temp, seed):
    """``rows`` identical dense rows (prompt [1, 2, 3]) whose last logits
    are ``logits``, at temperature ``temp``."""
    st = tdecode.init_decode_state(tcfg, rows, 16, seed, device="cpu")
    toks = torch.tensor([[1, 2, 3]] * rows, dtype=torch.int32)
    tdecode._admit_rows_body(st, tparams, tcfg, torch.arange(rows), toks,
                             torch.full((rows,), 3), torch.full((rows,), 8),
                             torch.full((rows,), temp))
    st["last_logits"][:] = logits
    return st


def test_sampled_verify_keeps_the_target_distribution(models):
    """Accept-or-resample against a point-mass draft leaves the first
    emitted token distributed as softmax(last_logits / T). Four seeds of
    2048 rows each (8192 draws); every token's frequency within five
    standard errors of its probability, sqrt(p (1 - p) / 8192)."""
    _, _, tcfg, tparams = models
    logits = torch.full((tcfg.vocab_size,), -1e30)
    logits[[7, 11, 13, 17]] = torch.log(torch.tensor([0.4, 0.3, 0.2, 0.1]))
    temp = 0.8
    p = torch.softmax(logits / temp, dim=-1)
    rows, seeds = 2048, 4
    counts = torch.zeros(tcfg.vocab_size)
    draft = torch.full((rows, 1), 11, dtype=torch.int32)  # p(11) ~ 0.28
    for seed in range(seeds):
        st = _sampled_state(tcfg, tparams, rows, logits, temp, seed)
        ones = torch.ones(rows, dtype=torch.int32)
        _, out, emitted = tdecode.verify_step(st, tparams, tcfg, draft, ones)
        assert emitted[:, 0].all()
        counts += torch.bincount(out[:, 0].long(),
                                 minlength=tcfg.vocab_size).float()
    n = rows * seeds
    freq = counts / n
    bound = 5 * torch.sqrt(p * (1 - p) / n)
    assert (freq[[7, 11, 13, 17]] > 0).all()
    assert ((freq - p).abs() <= bound + 1e-12).all(), (freq[[7, 11, 13, 17]],
                                                       p[[7, 11, 13, 17]])


@pytest.mark.parametrize("top_k", [1, 2])
def test_verify_rejection_resample_excludes_the_draft_token(models, top_k):
    """A rejected draft is masked out of the resample, after the top-k
    cut: with top_k 1 the commit is the argmax; with top_k 2 and the
    draft the second of the two, every rejected row resamples the
    first, never the draft and never a token outside the top two."""
    _, _, tcfg, tparams = models
    logits = torch.full((tcfg.vocab_size,), -5.0)
    logits[[7, 11, 13]] = torch.tensor([2.0, 1.5, 1.4])
    rows = 512
    st = _sampled_state(tcfg, tparams, rows, logits, 0.9, seed=1)
    draft = torch.full((rows, 1), 11 if top_k == 2 else 13,
                       dtype=torch.int32)
    _, out, emitted = tdecode.verify_step(st, tparams, tcfg, draft,
                                          torch.ones(rows, dtype=torch.int32),
                                          top_k=top_k)
    first = out[:, 0]
    assert emitted[:, 0].all()
    if top_k == 1:
        assert (first == 7).all()
    else:
        accepted = (first == 11) & emitted[:, 1]
        assert set(first.tolist()) <= {7, 11}
        assert (first[~accepted] == 7).all()
        assert 0 < int(accepted.sum()) < rows


# ---------------------------------------------------------------------------
# extend_and_propose and the proposers
# ---------------------------------------------------------------------------


def test_extend_and_propose_matches_jax(models):
    """Two rounds on a dense f32 draft state: a first feed (rows of 5
    and 3 tokens, one row parked at the end), then a catch-up feed whose
    row 2 runs past the row's end (the spill drops)."""
    jcfg, jparams, tcfg, tparams = models
    js = jdecode.init_decode_state(jcfg, 3, TOTAL)
    ts = tdecode.init_decode_state(tcfg, 3, TOTAL, device="cpu")
    rounds = [
        (np.array([[5, 9, 2, 7, 1, 0, 0, 0], [3, 3, 8, 0, 0, 0, 0, 0],
                   [0] * 8], np.int32),
         np.array([0, 0, TOTAL], np.int32), np.array([5, 3, 0], np.int32)),
        (np.array([[4, 4, 0, 0], [8, 0, 0, 0], [6, 1, 2, 9]], np.int32),
         np.array([5, 3, 21], np.int32), np.array([2, 1, 4], np.int32)),
    ]
    for feed, pos, lens in rounds:
        js, jp = jdecode.extend_and_propose(
            js, jparams, jcfg, jnp.asarray(feed), jnp.asarray(pos),
            jnp.asarray(lens), 3)
        ts, tp = tdecode.extend_and_propose(
            ts, tparams, tcfg, torch.from_numpy(feed), torch.from_numpy(pos),
            torch.from_numpy(lens), 3)
        np.testing.assert_array_equal(tp[:2].numpy(), np.asarray(jp)[:2])
        for key in ("length", "remaining", "active"):
            np.testing.assert_array_equal(ts[key].numpy(),
                                          np.asarray(js[key]), err_msg=key)
        np.testing.assert_allclose(ts["last_logits"].numpy(),
                                   np.asarray(js["last_logits"]), **TOL)
        for side in ("k", "v"):
            np.testing.assert_allclose(ts["cache"][side].numpy(),
                                       np.asarray(js["cache"][side]), **TOL)


def test_draft_model_proposer_matches_the_target_chain(models):
    """The target's own weights (f32) as the draft: greedy proposals ARE
    the target chain, across incremental catch-up feeds."""
    _, _, tcfg, tparams = models
    prompts = [[1, 2, 3], [7, 5]]
    st = tdecode.init_decode_state(tcfg, 2, TOTAL, device="cpu")
    toks = torch.tensor([[1, 2, 3], [7, 5, 0]], dtype=torch.int32)
    tdecode._admit_rows_body(st, tparams, tcfg, torch.arange(2), toks,
                             torch.tensor([3, 2]), torch.tensor([8, 8]),
                             torch.zeros(2))
    _, ref, _ = tdecode.decode_chunk(st, tparams, tcfg, 6)
    ref = ref.T.tolist()
    prop = DraftModelProposer("lm-test-tiny", 256, slots=2, total_len=TOTAL,
                              propose_steps=3, device="cpu")
    prop.cfg = tcfg
    prop.state = tdecode.init_decode_state(tcfg, 2, TOTAL, device="cpu")
    prop.install_weights(tparams)
    out = prop.propose([(0, prompts[0], 3), (1, prompts[1], 3)])
    assert out == {0: ref[0][:3], 1: ref[1][:3]}
    out = prop.propose([(0, prompts[0] + ref[0][:3], 3),
                        (1, prompts[1] + ref[1][:3], 2)])
    assert out == {0: ref[0][3:6], 1: ref[1][3:5]}
    assert prop.dispatches == 2


def test_ngram_proposes_continuation_of_repeated_pattern():
    p = NgramProposer(max_match=3)
    assert p._lookup([1, 2, 3, 4, 9, 1, 2], 2) == [3, 4]
    assert p._lookup([1, 2, 3, 4, 9, 1, 2], 8) == [3, 4, 9, 1, 2]


def test_ngram_prefers_longest_and_most_recent_match():
    p = NgramProposer(max_match=3)
    assert p._lookup([2, 3, 7, 9, 1, 2, 3, 8, 5, 1, 2, 3], 1) == [8]
    assert p._lookup([1, 2, 5, 9, 1, 2, 6, 9, 1, 2], 1) == [6]


def test_ngram_no_match_returns_empty():
    p = NgramProposer()
    assert p._lookup([1, 2, 3, 4, 5], 4) == []
    assert p._lookup([], 4) == []
    assert p._lookup([1, 2], 0) == []


@pytest.mark.parametrize("kind", ["random", "repeating"])
def test_ngram_matches_jax_on_many_contexts(kind):
    rng = np.random.default_rng(0)
    port, ref = NgramProposer(), JaxNgram()
    reqs = []
    for slot in range(64):
        if kind == "random":
            ctx = rng.integers(0, 6, rng.integers(0, 40)).tolist()
        else:
            pat = rng.integers(0, 50, rng.integers(1, 6)).tolist()
            ctx = (pat * 20)[: rng.integers(1, 60)] + rng.integers(
                0, 50, rng.integers(0, 3)).tolist()
        reqs.append((slot, ctx, int(rng.integers(0, 9))))
    got = port.propose(reqs)
    assert got == ref.propose(reqs)
    assert sum(map(len, got.values())) > 0


def test_make_proposer_validates_mode_and_vocab():
    with pytest.raises(ValueError, match="draft_mode"):
        make_proposer("bogus", target_vocab=256, slots=1, total_len=8,
                      propose_steps=1, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        make_proposer("model:lm-test-tiny", target_vocab=999, slots=1,
                      total_len=8, propose_steps=1, device="cpu")
    assert isinstance(make_proposer("ngram", target_vocab=256, slots=1,
                                    total_len=8, propose_steps=1),
                      NgramProposer)


# ---------------------------------------------------------------------------
# The continuous decoder
# ---------------------------------------------------------------------------

# Repeating prompts, so the n-gram proposer drafts from the first round.
PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 9, 2], [4, 1, 2, 3, 1, 2],
           [5, 6, 7, 8] * 3, [3, 1] * 5]
COUNTERS = ("spec_drafted_tokens", "spec_accepted_tokens",
            "spec_verify_dispatches", "spec_draft_dispatches",
            "decode_steps", "decode_dispatches", "tokens_emitted")
BASE = dict(slots=4, prefill_len=16, max_new_tokens=8)
PAGED = dict(kv_layout="paged", kv_block_size=8)


def _streams(decoder, prompts=PROMPTS, want=8):
    """The prompts one at a time (so rounds are deterministic)."""
    try:
        return ([decoder.generate(p, want, timeout=120)["tokens"]
                 for p in prompts], decoder.metrics())
    finally:
        decoder.stop()


def _jax_draft_weights(decoder):
    """The JAX draft model's weights (its seed-0 init) as the port's
    draft weights, in the draft preset's dtype."""
    spec = get_model("lm-test-tiny")
    tree = jax.tree.map(np.asarray,
                        spec.init(jax.random.PRNGKey(0), spec.config))
    decoder._spec.install_weights(
        params_from_numpy(tree, decoder._spec.cfg, "cpu"))
    return decoder


@pytest.fixture(scope="module")
def reference(models):
    """Speculation off, port and JAX: the greedy streams every run must
    give."""
    jcfg, jparams, tcfg, tparams = models
    want, _ = _streams(JaxDecoder(jparams, jcfg, **BASE))
    got, _ = _streams(ContinuousDecoder(tparams, tcfg, **BASE))
    assert got == want
    return want


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("layout,fused", LAYOUTS, ids=LAYOUT_IDS)
def test_ngram_speculation_matches_jax(models, reference, layout, fused, k):
    """n-gram drafts: the greedy streams equal speculation off, and every
    stream and ``spec_*`` counter equals the JAX decoder's."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(BASE, speculative_k=k, **(PAGED if layout == "paged" else {}),
              kv_fused=fused)
    want, jm = _streams(JaxDecoder(jparams, jcfg, **kw))
    got, m = _streams(ContinuousDecoder(tparams, tcfg, **kw))
    assert got == want == reference
    for key in COUNTERS:
        assert m[key] == jm[key], key
    assert m["spec_verify_dispatches"] > 0 and m["spec_accepted_tokens"] > 0
    assert m["spec_acceptance_rate"] == pytest.approx(
        jm["spec_acceptance_rate"])
    assert m["spec_draft_k"] == pytest.approx(jm["spec_draft_k"])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_draft_model_speculation_matches_jax(models, reference, layout):
    """``model:lm-test-tiny`` holding the JAX draft's weights: streams
    equal speculation off and the JAX decoder's, with most drafts
    kept."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(BASE, speculative_k=3, draft_mode="model:lm-test-tiny",
              **(PAGED if layout == "paged" else {}))
    want, jm = _streams(JaxDecoder(jparams, jcfg, **kw))
    got, m = _streams(_jax_draft_weights(
        ContinuousDecoder(tparams, tcfg, **kw)))
    assert got == want == reference
    assert m["spec_draft_dispatches"] > 0
    assert m["spec_acceptance_rate"] > 0.5, m


def test_chunked_speculation_and_eos_match_jax(models, reference):
    """``chunk_size`` 2 (verify_chunk, two verify steps a round) with the
    draft model, then with EOS: streams equal the JAX decoder's, and EOS
    cuts each stream where speculation off does."""
    jcfg, jparams, tcfg, tparams = models
    kw = dict(BASE, speculative_k=3, chunk_size=2, **PAGED, kv_fused=True,
              draft_mode="model:lm-test-tiny")
    want, _ = _streams(JaxDecoder(jparams, jcfg, **kw))
    got, m = _streams(_jax_draft_weights(
        ContinuousDecoder(tparams, tcfg, **kw)))
    assert got == want == reference
    assert m["spec_verify_dispatches"] > 0
    eos = reference[0][2]
    off, _ = _streams(ContinuousDecoder(tparams, tcfg, **BASE, eos_id=eos))
    want, _ = _streams(JaxDecoder(jparams, jcfg, **kw, eos_id=eos))
    got, _ = _streams(_jax_draft_weights(
        ContinuousDecoder(tparams, tcfg, **kw, eos_id=eos)))
    assert got == want == off
    assert off[0] == reference[0][:3]


def test_draft_length_tunes_down_on_rejection(models, reference):
    """A draft model with other weights (the port's seed-7 init) keeps
    missing: the per-slot draft length shrinks below K, and the streams
    stay those of speculation off."""
    _, _, tcfg, tparams = models
    got, m = _streams(ContinuousDecoder(
        tparams, tcfg, **BASE, speculative_k=4, seed=7,
        draft_mode="model:lm-test-tiny"))
    assert got == reference
    assert m["spec_acceptance_rate"] < 0.9, m
    assert m["spec_draft_k"] < 4, m


def test_sampled_speculation_completes_with_budget(models):
    _, _, tcfg, tparams = models
    d = ContinuousDecoder(tparams, tcfg, **BASE, speculative_k=4)
    try:
        handles = [d.submit(p, 6, temperature=0.9) for p in PROMPTS]
        for h in handles:
            toks = h.result(timeout=120)["tokens"]
            assert len(toks) == 6 and all(0 <= t < 256 for t in toks)
    finally:
        d.stop()


def test_decoder_rejects_a_bad_draft_mode(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="draft_mode"):
        ContinuousDecoder(tparams, tcfg, **BASE, speculative_k=2,
                          draft_mode="bogus")


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_spec_counters_in_the_exposition_equal_metrics():
    server = ModelServer(
        EngineConfig(model="lm-test-tiny", batch_size=4, max_seq_len=16,
                     max_new_tokens=8, speculative_k=4, device="cpu"),
        port=0, batch_timeout_ms=2)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        conn.request("POST", "/v1/models/lm-test-tiny:predict",
                     body=json.dumps({"instances": [
                         {"tokens": p, "max_new_tokens": 8}
                         for p in PROMPTS[3:]]}).encode())
        resp = conn.getresponse()
        resp.read()
        conn.close()
        assert resp.status == 200
        status, text = _get(server.port, "/monitoring/prometheus/metrics")
        assert status == 200
        m = server.decoder.metrics()
    finally:
        server.stop()
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            samples[name] = float(value)
    assert m["spec_verify_dispatches"] > 0
    for key in ("spec_drafted_tokens", "spec_accepted_tokens",
                "spec_verify_dispatches", "spec_draft_dispatches"):
        assert samples[f"serving_{key}_total"] == m[key], key
    assert samples["serving_spec_acceptance_rate"] == pytest.approx(
        m["spec_acceptance_rate"])
    assert samples['serving_dispatch_seconds_count{kind="verify"}'] == \
        m["spec_verify_dispatches"]
