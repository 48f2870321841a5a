"""The port's dense KV layout, lockstep ``generate`` and dense prefix pool
against the JAX package's, function by function.

Both packages get the same weights (the JAX init, handed across as numpy
arrays through ``params_from_numpy``) at ``dtype=float32`` on the CPU.
States, caches and logits must agree within 1e-5 and tokens exactly. The
writes JAX drops (a parked row's decode write) and the starts it clamps
(``dynamic_update_slice``) are handled explicitly in the port; tests pin
each.
"""

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
from kubeflow_tpu_torch.models import decode as tdecode  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.weights import params_from_numpy  # noqa: E402

SLOTS, T0, TOTAL, POOL = 4, 6, 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)
SCALARS = ("length", "remaining", "active", "temperature", "last_logits")

# A round of three admissions padded to a bucket of four: the last row
# repeats the third verbatim, so slot 2 is scattered twice.
ADMIT = dict(
    slots=np.array([0, 1, 2, 2], np.int32),
    toks=np.array([[5, 9, 2, 7, 1, 0], [3, 3, 0, 0, 0, 0],
                   [8, 1, 4, 4, 2, 6], [8, 1, 4, 4, 2, 6]], np.int32),
    lengths=np.array([5, 2, 6, 6], np.int32),
    remaining=np.array([9, 3, 9, 9], np.int32),
    temps=np.zeros((4,), np.float32),
)


@pytest.fixture(scope="module")
def models():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _assert_state(t_state, j_state, err=""):
    for side in ("k", "v"):
        np.testing.assert_allclose(t_state["cache"][side].numpy(),
                                   np.asarray(j_state["cache"][side]),
                                   err_msg=f"{err} cache {side}", **TOL)
    for key in SCALARS:
        np.testing.assert_allclose(t_state[key].numpy(),
                                   np.asarray(j_state[key]),
                                   err_msg=f"{err} {key}", **TOL)


def _tensors(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_init_prefill_insert_row_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    j_state = jdecode.init_decode_state(jcfg, SLOTS, TOTAL)
    t_state = tdecode.init_decode_state(tcfg, SLOTS, TOTAL, device="cpu")
    _assert_state(t_state, j_state, "init")
    toks, lengths = ADMIT["toks"][:1], ADMIT["lengths"][:1]
    j_cache, j_last = jdecode.prefill(jparams, jnp.asarray(toks),
                                      jnp.asarray(lengths), jcfg,
                                      total_len=TOTAL)
    t_cache, t_last = tdecode.prefill(tparams, torch.from_numpy(toks),
                                      torch.from_numpy(lengths), tcfg,
                                      total_len=TOTAL)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)
    for side in ("k", "v"):
        np.testing.assert_allclose(t_cache[side].numpy(),
                                   np.asarray(j_cache[side]), **TOL)
    j_state = jdecode.insert_row(j_state, jnp.int32(2), j_cache, j_last,
                                 jnp.int32(5), jnp.int32(4),
                                 jnp.float32(0.5))
    tdecode.insert_row(t_state, 2, t_cache, t_last, 5, 4, 0.5)
    _assert_state(t_state, j_state, "insert_row")
    # JAX clamps an out-of-range slot onto the last row; the port raises.
    with pytest.raises(IndexError, match="slot 4"):
        tdecode.insert_row(t_state, SLOTS, t_cache, t_last, 5, 4, 0.5)


def _admitted(models, eos_id=None):
    """Both packages' states after one padded admission round, with the
    admission's outputs."""
    jcfg, jparams, tcfg, tparams = models
    a, at = _jnp(ADMIT), _tensors(ADMIT)
    j_state, j_last, j_tok, j_emit = jdecode.admit_rows_and_step(
        jdecode.init_decode_state(jcfg, SLOTS, TOTAL), jparams, jcfg,
        a["slots"], a["toks"], a["lengths"], a["remaining"], a["temps"],
        eos_id=eos_id)
    t_state, t_last, t_tok, t_emit = tdecode.admit_rows_and_step(
        tdecode.init_decode_state(tcfg, SLOTS, TOTAL, device="cpu"),
        tparams, tcfg, at["slots"], at["toks"], at["lengths"],
        at["remaining"], at["temps"], eos_id=eos_id)
    return ((j_state, j_last, j_tok, j_emit),
            (t_state, t_last, t_tok, t_emit))


def _eos_token(models):
    """A token row 0 emits mid-stream, so an EOS stop really happens."""
    jcfg, jparams, _, _ = models
    (j_state, _, _, _), _ = _admitted(models)
    toks = []
    for _ in range(3):
        j_state, tok, _ = jdecode.decode_step(j_state, jparams, jcfg)
        toks.append(int(tok[0]))
    return toks[2]


def test_admit_rows_padded_bucket_matches_jax(models):
    (j_state, j_last, j_tok, j_emit), (t_state, t_last, t_tok, t_emit) = \
        _admitted(models)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
    _assert_state(t_state, j_state, "admission")
    assert t_state["active"].tolist() == [True, True, True, False]


@pytest.mark.parametrize("chunk", [1, 4], ids=["step", "chunk"])
def test_decode_parked_row_and_eos_match_jax(models, chunk):
    """Eight decode steps after the admission: row 1 spends its budget and
    goes inactive, row 2 is retired by the host after the first round, row 0
    samples the EOS and parks on the device, row 3 was never admitted.
    Tokens must be equal and states within 1e-5 every round."""
    jcfg, jparams, tcfg, tparams = models
    eos = _eos_token(models)
    (j_state, _, j_tok, _), (t_state, _, t_tok, _) = _admitted(models, eos)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    for rnd in range(8 // chunk):
        if rnd == 1:
            j_state = jdecode.retire_row(j_state, jnp.int32(2))
            t_state = tdecode.retire_row(t_state, 2)
        if chunk == 1:
            j_state, j_tok, j_emit = jdecode.decode_step(
                j_state, jparams, jcfg, eos_id=eos)
            t_state, t_tok, t_emit = tdecode.decode_step(
                t_state, tparams, tcfg, eos_id=eos)
        else:
            j_state, j_tok, j_emit = jdecode.decode_chunk(
                j_state, jparams, jcfg, chunk, eos_id=eos)
            t_state, t_tok, t_emit = tdecode.decode_chunk(
                t_state, tparams, tcfg, chunk, eos_id=eos)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok),
                                      err_msg=f"round {rnd}")
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        _assert_state(t_state, j_state, f"round {rnd}")
    # Row 0 hit EOS and row 2 was retired: both parked at the row's end;
    # row 1 spent its budget of 3 and went inactive where it stood.
    assert t_state["length"][:3].tolist() == [TOTAL, 2 + 3, TOTAL]
    assert not t_state["active"].any()


def test_dense_write_of_a_parked_row_lands_nowhere(models):
    """A parked row (length == total) writes back what its row holds —
    the scatter JAX drops — while live rows write their position."""
    _, _, tcfg, tparams = models
    (_, _, _, _), (t_state, _, _, _) = _admitted(models)
    tdecode.retire_row(t_state, 0)
    before = {s: t_state["cache"][s].clone() for s in ("k", "v")}
    tdecode.decode_step(t_state, tparams, tcfg)
    for side in ("k", "v"):
        np.testing.assert_array_equal(t_state["cache"][side][:, 0].numpy(),
                                      before[side][:, 0].numpy())
        assert not torch.equal(t_state["cache"][side][:, 1],
                               before[side][:, 1])


def test_generate_greedy_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks, lengths = ADMIT["toks"][:3], ADMIT["lengths"][:3]
    temps = np.zeros((3,), np.float32)
    row_valid = np.array([True, True, False])
    j_toks, j_last = jdecode.generate(
        jparams, jnp.asarray(toks), jnp.asarray(lengths), jcfg,
        max_new_tokens=7, key=jax.random.PRNGKey(0),
        temperature=jnp.asarray(temps), row_valid=jnp.asarray(row_valid))
    t_toks, t_last = tdecode.generate(
        tparams, torch.from_numpy(toks), torch.from_numpy(lengths), tcfg,
        max_new_tokens=7, generator=torch.Generator().manual_seed(0),
        temperature=torch.from_numpy(temps),
        row_valid=torch.from_numpy(row_valid))
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)
    # A sampled row with top_k=1 can only take the greedy token.
    s_toks, _ = tdecode.generate(
        tparams, torch.from_numpy(toks), torch.from_numpy(lengths), tcfg,
        max_new_tokens=7, generator=torch.Generator().manual_seed(1),
        temperature=torch.tensor([0.0, 1.0, 2.0]), top_k=1)
    np.testing.assert_array_equal(s_toks.numpy(), np.asarray(j_toks))
    empty, _ = tdecode.generate(
        tparams, torch.from_numpy(toks), torch.from_numpy(lengths), tcfg,
        max_new_tokens=0, generator=torch.Generator(),
        temperature=torch.from_numpy(temps))
    assert empty.shape == (3, 0)


def _prefix_setup(models):
    """Both packages: a pool of POOL rows, row 0 published from decode
    state slot 0 after the admission round, row 1 primed from a prefill
    of the third prompt."""
    jcfg, jparams, tcfg, tparams = models
    (j_state, _, _, _), (t_state, _, _, _) = _admitted(models)
    j_pool = jdecode.init_prefix_pool(jcfg, POOL, T0)
    t_pool = tdecode.init_prefix_pool(tcfg, POOL, T0, device="cpu")
    for side in ("k", "v"):
        np.testing.assert_array_equal(t_pool[side].numpy(),
                                      np.asarray(j_pool[side]))
    j_pool = jdecode.store_prefix_row(j_pool, jnp.int32(0), j_state,
                                      jnp.int32(0))
    tdecode.store_prefix_row(t_pool, 0, t_state, 0)
    toks, lengths = ADMIT["toks"][2:3], ADMIT["lengths"][2:3]
    j_cache, _ = jdecode.prefill(jparams, jnp.asarray(toks),
                                 jnp.asarray(lengths), jcfg, total_len=T0)
    t_cache, _ = tdecode.prefill(tparams, torch.from_numpy(toks),
                                 torch.from_numpy(lengths), tcfg,
                                 total_len=T0)
    j_pool = jdecode.store_prefix_cache(j_pool, jnp.int32(1), j_cache)
    tdecode.store_prefix_cache(t_pool, 1, t_cache)
    return j_state, t_state, j_pool, t_pool


def test_prefix_pool_stores_match_jax(models):
    _, _, j_pool, t_pool = _prefix_setup(models)
    for side in ("k", "v"):
        np.testing.assert_allclose(t_pool[side].numpy(),
                                   np.asarray(j_pool[side]), **TOL)
    with pytest.raises(IndexError, match="pool_slot"):
        tdecode.store_prefix_cache(t_pool, POOL, {"k": t_pool["k"][:, :1],
                                                  "v": t_pool["v"][:, :1]})


def test_admit_prefix_and_step_matches_jax(models):
    """Slot 3 admits prompt [8, 1, 4, 4, 2, 6, 3] with its first four
    positions from pool row 1, prefilling the rest as a suffix padded to
    four. Then a store into the same pool row — which the host pin
    forbids while an admission reads it — must leave the admitted row as
    it was: the admission copied the row before anything else ran."""
    jcfg, jparams, tcfg, tparams = models
    j_state, t_state, j_pool, t_pool = _prefix_setup(models)
    suffix = np.array([[2, 6, 3, 0]], np.int32)
    args = dict(prefix_len=4, prompt_len=7, remaining=5, temperature=0.0)
    j_state, j_last, j_tok, j_emit = jdecode.admit_prefix_and_step(
        j_state, jparams, jcfg, jnp.int32(3), j_pool, jnp.int32(1),
        jnp.int32(args["prefix_len"]), jnp.asarray(suffix),
        jnp.int32(args["prompt_len"]), jnp.int32(args["remaining"]),
        jnp.float32(args["temperature"]))
    t_state, t_last, t_tok, t_emit = tdecode.admit_prefix_and_step(
        t_state, tparams, tcfg, 3, t_pool, 1, args["prefix_len"],
        torch.from_numpy(suffix), args["prompt_len"], args["remaining"],
        args["temperature"])
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **TOL)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
    _assert_state(t_state, j_state, "prefix admission")
    row = {s: t_state["cache"][s][:, 3].clone() for s in ("k", "v")}
    tdecode.store_prefix_row(t_pool, 1, t_state, 0)
    for side in ("k", "v"):
        assert torch.equal(t_state["cache"][side][:, 3], row[side])
    # A suffix that would end past the row raises (JAX would clamp the
    # write's start and overwrite the prefix).
    with pytest.raises(ValueError, match="outside"):
        tdecode.admit_prefix_and_step(
            t_state, tparams, tcfg, 3, t_pool, 1, TOTAL - 2,
            torch.from_numpy(suffix), TOTAL, 1, 0.0)
