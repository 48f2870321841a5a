"""The port's mixture-of-experts transformer against the JAX package's.

``moe_ffn`` (with and without ``token_valid``, with capacity drops, one
expert against the dense SwiGLU), ``moe-test-tiny``'s loss, router aux
and gradients, its remat policies, and every decode path: the step
functions (dense and paged admission and decode, lockstep ``generate``
over padded rows, the chunk, prefix, verify and draft-model forwards) and
the continuous decoder's greedy streams on each layout and path. Both
packages get the same weights (the JAX init handed across as numpy
arrays) at ``dtype=float32`` on the CPU.

Tolerances: float32 on both sides with sums in another order. ``moe_ffn``
outputs and ``apply``'s logits within 1e-5 of their largest magnitude,
the aux loss 1e-6
relative; losses 1e-5 relative, gradients 1e-4 of each leaf's largest
JAX element; logits 1e-4. Greedy tokens must be identical. On int8
pools a K/V value within float32 rounding of a code boundary may land one
code apart (seen: one code of 93 against 94), which moves its row's
logits by up to 1e-3: there the codes must agree within one step and the
logits within 2e-3.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kubeflow_tpu.models.decode as jdecode  # noqa: E402
from kubeflow_tpu.models import transformer as jtransformer  # noqa: E402
from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu.serving.continuous import (  # noqa: E402
    ContinuousDecoder as JaxDecoder,
)
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import decode as tdecode  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.serving.continuous import ContinuousDecoder  # noqa: E402,E501

NAME = "moe-test-tiny"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
INT8_LOGIT_TOL = dict(rtol=0, atol=2e-3)


@pytest.fixture(scope="module")
def models():
    spec = get_model(NAME, dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config(NAME, dtype=torch.float32)
    return (spec.config, jparams, tcfg,
            weights.params_from_numpy(tree, tcfg, "cpu"), tree)


def _torch_mlp(mlp):
    return {k: torch.from_numpy(np.array(w)) for k, w in mlp.items()}


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["all", "token_valid"])
@pytest.mark.parametrize("cf", [1.25, 0.3], ids=["cf1.25", "drops"])
def test_moe_ffn_matches_jax(models, cf, masked):
    """At capacity factor 0.3 (capacity 4 of 32 choices an expert) most
    choices drop; the kept ones and the aux loss still match."""
    *_, tree = models
    jcfg = jtransformer.config(NAME, dtype=jnp.float32,
                               expert_capacity_factor=cf)
    tcfg = ttransformer.config(NAME, dtype=torch.float32,
                               expert_capacity_factor=cf)
    mlp = jax.tree.map(lambda w: w[1], tree["layers"]["mlp"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    tv = rng.random((2, 16)) < 0.6 if masked else None
    jy, jaux = jtransformer.moe_ffn(
        jnp.asarray(x), mlp, jcfg, None if tv is None else jnp.asarray(tv))
    ty, taux = ttransformer.moe_ffn(
        torch.from_numpy(x), _torch_mlp(mlp), tcfg,
        None if tv is None else torch.from_numpy(tv))
    jy = np.asarray(jy)
    assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    if tv is not None:  # padding gets nothing from the experts
        assert not ty.numpy()[~tv].any()
    if cf < 1:  # drops happened: some valid token got no expert at all
        assert (np.abs(jy).sum(-1) == 0).sum() > (0 if tv is None
                                                   else (~tv).sum())


def test_capacity_drops_overflow_tokens():
    """tests/test_moe.py's case: capacity 1 and every token routed to
    expert 0, so only the first token is computed."""
    jcfg = jtransformer.config(NAME, dtype=jnp.float32, n_experts=2,
                               expert_top_k=1, expert_capacity_factor=1e-9)
    tcfg = ttransformer.config(NAME, dtype=torch.float32, n_experts=2,
                               expert_top_k=1, expert_capacity_factor=1e-9)
    d, f = tcfg.d_model, tcfg.d_ff
    mlp = {
        "router": np.concatenate([np.full((d, 1), 1.0), np.full((d, 1), -1.0)],
                                 axis=1).astype(np.float32),
        "gate": np.full((2, d, f), 0.01, np.float32),
        "up": np.full((2, d, f), 0.01, np.float32),
        "down": np.full((2, f, d), 0.01, np.float32),
    }
    x = np.ones((1, 8, d), np.float32)
    jy, _ = jtransformer.moe_ffn(jnp.asarray(x), mlp, jcfg)
    ty, _ = ttransformer.moe_ffn(torch.from_numpy(x), _torch_mlp(mlp), tcfg)
    y = ty.numpy()[0]
    assert np.abs(y[0]).sum() > 0
    assert not y[1:].any()
    np.testing.assert_allclose(y, np.asarray(jy)[0], rtol=1e-6, atol=1e-7)


def test_single_expert_equals_dense_swiglu():
    """One expert, top-1, ample capacity: the dense SwiGLU on its weights
    (the gate is 1) and aux 1, as tests/test_moe.py holds for JAX."""
    tcfg = ttransformer.config(NAME, dtype=torch.float32, n_experts=1,
                               expert_top_k=1, expert_capacity_factor=2.0)
    g = torch.Generator().manual_seed(0)
    d, f = tcfg.d_model, tcfg.d_ff
    mlp = {"router": torch.randn(d, 1, generator=g) * 0.1,
           "gate": torch.randn(1, d, f, generator=g) * 0.1,
           "up": torch.randn(1, d, f, generator=g) * 0.1,
           "down": torch.randn(1, f, d, generator=g) * 0.1}
    x = torch.randn(2, 16, d, generator=g)
    y, aux = ttransformer.moe_ffn(x, mlp, tcfg)
    dense = (torch.nn.functional.silu(x @ mlp["gate"][0])
             * (x @ mlp["up"][0])) @ mlp["down"][0]
    torch.testing.assert_close(y, dense, rtol=1e-5, atol=1e-6)
    assert aux.item() == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# Training: loss, aux, gradients, remat
# ---------------------------------------------------------------------------


def _loss_and_grads(tcfg, params, tokens):
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in weights.flatten(params).items()}
    loss, met = ttransformer.loss_fn(weights._unflatten(leaves),
                                     {"tokens": torch.from_numpy(tokens)},
                                     tcfg)
    loss.backward()
    return loss, met, {k: p.grad for k, p in leaves.items()}


def test_loss_aux_and_grads_match_jax(models):
    jcfg, jparams, tcfg, _, tree = models
    params = weights.params_from_numpy(tree, tcfg, "cpu",
                                       dtype=torch.float32)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 25)).astype(np.int32)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(p, {"tokens": jnp.asarray(tokens)},
                                       jcfg), has_aux=True)(jparams)
    loss, met, grads = _loss_and_grads(tcfg, params, tokens)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key in ("loss", "z_loss", "router_aux_loss"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   rtol=1e-5)
    jlogits, jaux = jtransformer.apply(jparams, jnp.asarray(tokens[:, :-1]),
                                       jcfg, return_aux=True)
    with torch.no_grad():
        tlogits, taux = ttransformer.apply(
            params, torch.from_numpy(tokens[:, :-1]), tcfg, return_aux=True)
    jlogits = np.asarray(jlogits)
    assert np.abs(tlogits.numpy() - jlogits).max() <= \
        1e-5 * np.abs(jlogits).max()
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    for path, ref in weights.flatten(jax.tree.map(np.asarray,
                                                  jgrads)).items():
        got = grads[path].numpy()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), path


@pytest.mark.parametrize("policy", ["dots", "llm", "llm_qkv", "llm_res",
                                    "none"])
def test_remat_policies_equal_no_remat(models, policy):
    """Remat changes what the backward keeps, never the values: loss, aux
    and gradients equal a run without remat."""
    *_, tcfg, _, tree = models
    params = weights.params_from_numpy(tree, tcfg, "cpu",
                                       dtype=torch.float32)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 17)).astype(
        np.int32)
    ref = _loss_and_grads(tcfg, params, tokens)
    got = _loss_and_grads(replace(tcfg, remat=True, remat_policy=policy),
                          params, tokens)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[1]["router_aux_loss"],
                               ref[1]["router_aux_loss"], rtol=1e-6, atol=0)
    for path, g in ref[2].items():
        torch.testing.assert_close(got[2][path], g, rtol=1e-5, atol=1e-6)


def test_llm_attn_refuses_moe_with_jax_message(models):
    jcfg, jparams, tcfg, tparams, _ = models
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError) as jerr:
        jtransformer.hidden_states(
            jparams, jnp.asarray(tokens),
            replace(jcfg, remat=True, remat_policy="llm_attn"))
    with pytest.raises(ValueError) as terr:
        ttransformer.hidden_states(
            tparams, torch.from_numpy(tokens),
            replace(tcfg, remat=True, remat_policy="llm_attn"))
    assert str(terr.value) == str(jerr.value)


def test_registry_builds_moe_presets():
    spec = tregistry.get_model("moe-1b")
    assert spec.family == "transformer" and spec.config.n_experts == 8
    assert spec.config.expert_capacity_factor == 1.25


# ---------------------------------------------------------------------------
# Decode step functions
# ---------------------------------------------------------------------------

SLOTS, N_BLOCKS, BS, MB = 4, 12, 8, 4
TABLE = np.array([[3, 0, 7, 5], [1, 9, 12, 12], [2, 4, 6, 8],
                  [12, 12, 12, 12]], np.int32)
ADMIT = dict(
    slots=np.array([0, 1, 2, 2], np.int32),  # bucket padding repeats row 2
    toks=np.array([[5, 9, 2, 7, 1, 0], [3, 3, 0, 0, 0, 0],
                   [8, 1, 4, 4, 2, 6], [8, 1, 4, 4, 2, 6]], np.int32),
    lengths=np.array([5, 2, 6, 6], np.int32),
    remaining=np.array([8, 3, 8, 8], np.int32),
    temps=np.zeros((4,), np.float32),
)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _steps_jax(jcfg, jparams, state, admit_fn, fused=False, steps=6):
    a = _j(ADMIT)
    state, last, tok, _ = admit_fn(state, jparams, jcfg, a["slots"],
                                   a["toks"], a["lengths"], a["remaining"],
                                   a["temps"], **fused)
    toks, logits = [np.asarray(tok)], [np.asarray(state["last_logits"])]
    for _ in range(steps):
        state, tok, _ = jdecode.decode_step(state, jparams, jcfg, **fused)
        toks.append(np.asarray(tok))
        logits.append(np.asarray(state["last_logits"]))
    return np.asarray(last), toks, logits, state


def _steps_torch(tcfg, tparams, state, admit_fn, fused=False, steps=6):
    a = _t(ADMIT)
    state, last, tok, _ = admit_fn(state, tparams, tcfg, a["slots"],
                                   a["toks"], a["lengths"], a["remaining"],
                                   a["temps"], **fused)
    toks, logits = [tok.numpy()], [state["last_logits"].numpy().copy()]
    for _ in range(steps):
        state, tok, _ = tdecode.decode_step(state, tparams, tcfg, **fused)
        toks.append(tok.numpy())
        logits.append(state["last_logits"].numpy().copy())
    return last.numpy(), toks, logits, state


def _assert_runs_equal(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got[0], want[0], **tol)
    for step, (t, j) in enumerate(zip(got[1], want[1])):
        np.testing.assert_array_equal(t, j, err_msg=f"step {step}")
    for t, j in zip(got[2], want[2]):
        np.testing.assert_allclose(t, j, **tol)


@pytest.mark.parametrize("layout", ["dense", "paged-gathered",
                                    "paged-fused", "paged-int8"])
def test_admit_and_decode_steps_match_jax(models, layout):
    """Three rows share every decode step: 6 choices on 4 experts at a
    capacity of 2, so which rows share a step decides the drops."""
    jcfg, jparams, tcfg, tparams, _ = models
    if layout == "dense":
        want = _steps_jax(jcfg, jparams,
                          jdecode.init_decode_state(jcfg, SLOTS, 32),
                          jdecode.admit_rows_and_step, {})
        got = _steps_torch(tcfg, tparams,
                           tdecode.init_decode_state(tcfg, SLOTS, 32,
                                                     device="cpu"),
                           tdecode.admit_rows_and_step, {})
    else:
        kv = "int8" if layout == "paged-int8" else "fp"
        fused = {"kv_fused": layout == "paged-fused"}
        js = jdecode.init_paged_state(jcfg, SLOTS, N_BLOCKS, BS, MB,
                                      kv_dtype=kv)
        js["block_table"] = jnp.asarray(TABLE)
        ts = tdecode.init_paged_state(tcfg, SLOTS, N_BLOCKS, BS, MB,
                                      kv_dtype=kv, device="cpu")
        ts["block_table"].copy_(torch.from_numpy(TABLE))
        want = _steps_jax(jcfg, jparams, js,
                          jdecode.paged_admit_rows_and_step, fused)
        got = _steps_torch(tcfg, tparams, ts,
                           tdecode.paged_admit_rows_and_step, fused)
        if kv == "int8":
            for side in ("k", "v"):
                codes = got[3]["pool"][side]["q"].numpy().astype(int)
                ref = np.asarray(want[3]["pool"][side]["q"]).astype(int)
                assert np.abs(codes - ref).max() <= 1
            _assert_runs_equal(got, want, INT8_LOGIT_TOL)
            return
    _assert_runs_equal(got, want)


def test_generate_padded_rows_match_jax(models):
    """Lockstep generate over the engine's padded batch: two real rows,
    two pad rows that ``row_valid`` keeps out of the experts. Equal to
    JAX, and a short prompt's stream is unchanged by a pad-heavy
    neighbour (tests/test_moe.py's case)."""
    jcfg, jparams, tcfg, tparams, _ = models
    prompts = np.zeros((4, 12), np.int32)
    prompts[0, :2] = [9, 3]
    prompts[1, :] = np.arange(12) % 256
    lengths = np.array([2, 12, 1, 1], np.int32)
    row_valid = np.array([True, True, False, False])
    jt, jl = jdecode.generate(
        jparams, jnp.asarray(prompts), jnp.asarray(lengths), jcfg,
        max_new_tokens=6, key=jax.random.PRNGKey(2),
        temperature=jnp.zeros((4,)), row_valid=jnp.asarray(row_valid))
    tt, tl = tdecode.generate(
        tparams, torch.from_numpy(prompts), torch.from_numpy(lengths), tcfg,
        max_new_tokens=6, generator=torch.Generator().manual_seed(2),
        temperature=torch.zeros(4), row_valid=torch.from_numpy(row_valid))
    np.testing.assert_array_equal(tt.numpy()[:2], np.asarray(jt)[:2])
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               **LOGIT_TOL)
    alone, _ = tdecode.generate(
        tparams, torch.tensor([[9, 3]], dtype=torch.int32),
        torch.tensor([2]), tcfg, max_new_tokens=6,
        generator=torch.Generator(), temperature=torch.zeros(1))
    assert tt[0].tolist() == alone[0].tolist()


def _paged_pair(models):
    jcfg, _, tcfg, _, _ = models
    js = jdecode.init_paged_state(jcfg, SLOTS, N_BLOCKS, BS, MB)
    js["block_table"] = jnp.asarray(TABLE)
    ts = tdecode.init_paged_state(tcfg, SLOTS, N_BLOCKS, BS, MB,
                                  device="cpu")
    ts["block_table"].copy_(torch.from_numpy(TABLE))
    return js, ts


@pytest.mark.parametrize("fused", [False, True], ids=["gathered", "fused"])
def test_chunk_then_prefix_admission_match_jax(models, fused):
    """Row 2's 27-token prompt as a padded 16-wide chunk of 11 real
    tokens (``chunk_len``), then the suffix through the prefix admission
    (``arange(s) < suffix_len``), then decode steps."""
    jcfg, jparams, tcfg, tparams, _ = models
    js, ts = _paged_pair(models)
    prompt = (np.arange(27) * 7 + 3) % 256
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :11] = prompt[:11]
    suffix = np.zeros((1, 16), np.int32)
    suffix[0, :16] = prompt[11:]
    js = jdecode.paged_prefill_chunk(js, jparams, jcfg, 2, 0,
                                     jnp.asarray(chunk), 11, kv_fused=fused)
    ts = tdecode.paged_prefill_chunk(ts, tparams, tcfg, 2, 0,
                                     torch.from_numpy(chunk), 11,
                                     kv_fused=fused)
    js, jlast, jtok, _ = jdecode.paged_admit_prefix_and_step(
        js, jparams, jcfg, 2, 11, jnp.asarray(suffix), 27, 6, 0.0,
        kv_fused=fused)
    ts, tlast, ttok, _ = tdecode.paged_admit_prefix_and_step(
        ts, tparams, tcfg, 2, 11, torch.from_numpy(suffix), 27, 6, 0.0,
        kv_fused=fused)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **LOGIT_TOL)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for _ in range(4):
        js, jtok, _ = jdecode.decode_step(js, jparams, jcfg, kv_fused=fused)
        ts, ttok, _ = tdecode.decode_step(ts, tparams, tcfg, kv_fused=fused)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_dense_prefix_admission_matches_jax(models):
    jcfg, jparams, tcfg, tparams, _ = models
    js = jdecode.init_decode_state(jcfg, SLOTS, 32)
    ts = tdecode.init_decode_state(tcfg, SLOTS, 32, device="cpu")
    want = _steps_jax(jcfg, jparams, js, jdecode.admit_rows_and_step, {},
                      steps=0)
    got = _steps_torch(tcfg, tparams, ts, tdecode.admit_rows_and_step, {},
                       steps=0)
    _assert_runs_equal(got, want)
    js, ts = want[3], got[3]
    jpool = jdecode.init_prefix_pool(jcfg, 2, 8)
    tpool = tdecode.init_prefix_pool(tcfg, 2, 8, device="cpu")
    jpool = jdecode.store_prefix_row(jpool, 1, js, 2)
    tpool = tdecode.store_prefix_row(tpool, 1, ts, 2)
    suffix = np.array([[4, 2, 6, 1, 0, 0, 0, 0]], np.int32)
    js, jlast, jtok, _ = jdecode.admit_prefix_and_step(
        js, jparams, jcfg, 3, jpool, 1, 4, jnp.asarray(suffix), 8, 5, 0.0)
    ts, tlast, ttok, _ = tdecode.admit_prefix_and_step(
        ts, tparams, tcfg, 3, tpool, 1, 4, torch.from_numpy(suffix), 8, 5,
        0.0)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **LOGIT_TOL)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("layout", ["dense", "paged-fused"])
def test_verify_step_matches_jax(models, layout):
    """A [slots, 3] scoring pass (``emit0 & in_draft``: a parked row and
    short drafts claim nothing) and the commit pass (``emit0``)."""
    jcfg, jparams, tcfg, tparams, _ = models
    if layout == "dense":
        js = jdecode.init_decode_state(jcfg, SLOTS, 32)
        ts = tdecode.init_decode_state(tcfg, SLOTS, 32, device="cpu")
        fused, admit = {}, ("admit_rows_and_step",)
    else:
        js, ts = _paged_pair(models)
        fused, admit = {"kv_fused": True}, ("paged_admit_rows_and_step",)
    a_j, a_t = _j(ADMIT), _t(ADMIT)
    js, *_ = getattr(jdecode, admit[0])(
        js, jparams, jcfg, a_j["slots"], a_j["toks"], a_j["lengths"],
        a_j["remaining"], a_j["temps"], **fused)
    ts, *_ = getattr(tdecode, admit[0])(
        ts, tparams, tcfg, a_t["slots"], a_t["toks"], a_t["lengths"],
        a_t["remaining"], a_t["temps"], **fused)
    draft = np.array([[7, 1, 2], [4, 4, 4], [2, 6, 9], [0, 0, 0]], np.int32)
    dlen = np.array([3, 1, 2, 0], np.int32)
    js, jout, jem = jdecode.verify_step(js, jparams, jcfg, jnp.asarray(draft),
                                        jnp.asarray(dlen), **fused)
    ts, tout, tem = tdecode.verify_step(ts, tparams, tcfg,
                                        torch.from_numpy(draft),
                                        torch.from_numpy(dlen), **fused)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(np.where(tem.numpy(), tout.numpy(), -1),
                                  np.where(np.asarray(jem), np.asarray(jout),
                                           -1))
    np.testing.assert_allclose(ts["last_logits"].numpy(),
                               np.asarray(js["last_logits"]), **LOGIT_TOL)


def test_extend_and_propose_matches_jax(models):
    """The draft model's catch-up feed (``in_feed``) and its proposals."""
    jcfg, jparams, tcfg, tparams, _ = models
    js = jdecode.init_decode_state(jcfg, SLOTS, 32)
    ts = tdecode.init_decode_state(tcfg, SLOTS, 32, device="cpu")
    feed = np.array([[5, 9, 2, 7], [3, 3, 0, 0], [8, 1, 4, 0], [0, 0, 0, 0]],
                    np.int32)
    pos = np.array([0, 0, 0, 32], np.int32)
    flen = np.array([4, 2, 3, 0], np.int32)
    js, jprop = jdecode.extend_and_propose(js, jparams, jcfg,
                                           jnp.asarray(feed),
                                           jnp.asarray(pos),
                                           jnp.asarray(flen), 3)
    ts, tprop = tdecode.extend_and_propose(ts, tparams, tcfg,
                                           torch.from_numpy(feed),
                                           torch.from_numpy(pos),
                                           torch.from_numpy(flen), 3)
    np.testing.assert_array_equal(tprop.numpy()[:3], np.asarray(jprop)[:3])


# ---------------------------------------------------------------------------
# The continuous decoder's greedy streams
# ---------------------------------------------------------------------------

PROMPTS = [[1, 2, 3], [7, 5], [9, 9, 9, 9, 2], list(range(4, 20)),
           [1, 2, 3, 1, 2, 3, 1, 2, 3]]
LONG = [(j * 7 + 3) % 97 + 1 for j in range(40)]
BASE = dict(slots=4, prefill_len=16, max_new_tokens=8)
PAGED = dict(kv_layout="paged", kv_block_size=8)
PATHS = {
    "dense": {},
    "paged-gathered": PAGED,
    "paged-fused": dict(PAGED, kv_fused=True),
    "chunked": dict(PAGED, kv_fused=True, prefill_chunk_tokens=8,
                    max_prompt_len=48),
    "prefix": dict(PAGED, prefix_cache_slots=4, prefix_cache_min_len=4),
    "spec-dense": dict(speculative_k=3),
    "spec-paged": dict(PAGED, kv_fused=True, speculative_k=3),
}


def _streams(decoder, prompts):
    """The prompts one at a time, so both decoders batch alike."""
    try:
        return [decoder.generate(p, 8, timeout=120)["tokens"]
                for p in prompts]
    finally:
        decoder.stop()


@pytest.mark.parametrize("path", list(PATHS))
def test_continuous_streams_match_jax(models, path):
    jcfg, jparams, tcfg, tparams, _ = models
    prompts = PROMPTS + ([LONG] if path == "chunked" else [])
    if path == "prefix":  # a repeat hits the prefix the first published
        prompts = PROMPTS + [PROMPTS[3][:12] + [7, 7], PROMPTS[4] + [1]]
    kw = dict(BASE, **PATHS[path])
    want = _streams(JaxDecoder(jparams, jcfg, **kw), prompts)
    got = _streams(ContinuousDecoder(tparams, tcfg, **kw), prompts)
    assert got == want


# ---------------------------------------------------------------------------
# Tied router probabilities: the lower expert first, as lax.top_k has it
# ---------------------------------------------------------------------------


def _tied(tree, kind):
    """``tree`` with its router zeroed (every probability ties) or with
    expert 1's column equal to expert 0's (the two tie on every token)."""
    tree = jax.tree.map(np.array, tree)
    router = tree["layers"]["mlp"]["router"]
    if kind == "zero":
        router[...] = 0.0
    else:
        router[..., 1] = router[..., 0]
    return tree


@pytest.mark.parametrize("probs", [
    [1 / 8] * 8,
    list(np.exp([0, 1, 1, 0, 1, 0, 0, 0]) / np.exp([0, 1, 1, 0, 1, 0, 0,
                                                     0]).sum()),
], ids=["uniform", "three-way"])
def test_top_k_experts_breaks_ties_as_lax_top_k(probs):
    p = np.asarray([probs], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 2)
    tv, ti = ttransformer.top_k_experts(torch.from_numpy(p), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", ["zero", "equal_columns"])
def test_tied_router_routes_ffn_and_loss_as_jax(models, kind):
    """Routing indices, ``moe_ffn`` (both choices' slots, so capacity
    positions depend on the order of ties) and the loss with its router
    aux, on a router whose probabilities tie."""
    jcfg, _, tcfg, _, tree = models
    tree = _tied(tree, kind)
    mlp = jax.tree.map(lambda w: w[0], tree["layers"]["mlp"])
    x = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(
        np.float32)
    probs = np.asarray(jax.nn.softmax(x.reshape(32, 64) @ mlp["router"]))
    _, jidx = jax.lax.top_k(jnp.asarray(probs), jcfg.expert_top_k)
    _, tidx = ttransformer.top_k_experts(torch.from_numpy(probs),
                                         tcfg.expert_top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jy, jaux = jtransformer.moe_ffn(jnp.asarray(x), mlp, jcfg)
    ty, taux = ttransformer.moe_ffn(torch.from_numpy(x), _torch_mlp(mlp),
                                    tcfg)
    jy = np.asarray(jy)
    assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 25)).astype(np.int32)
    jloss, jmet = jtransformer.loss_fn(jax.tree.map(jnp.asarray, tree),
                                       {"tokens": jnp.asarray(tokens)}, jcfg)
    params = weights.params_from_numpy(tree, tcfg, "cpu",
                                       dtype=torch.float32)
    with torch.no_grad():
        loss, met = ttransformer.loss_fn(
            params, {"tokens": torch.from_numpy(tokens)}, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["router_aux_loss"].item(),
                               float(jmet["router_aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("kind", ["zero", "equal_columns"])
def test_tied_router_greedy_streams_match_jax(models, kind):
    """The dense continuous decoder's greedy f32 streams, router tied."""
    jcfg, _, tcfg, _, tree = models
    tree = _tied(tree, kind)
    jparams = jax.tree.map(jnp.asarray, tree)
    want = _streams(JaxDecoder(jparams, jcfg, **BASE), PROMPTS)
    got = _streams(ContinuousDecoder(
        weights.params_from_numpy(tree, tcfg, "cpu"), tcfg, **BASE),
        PROMPTS)
    assert got == want
