"""The port's paged decode path against the JAX package's, step by step.

Both packages get the same weights (the JAX init, handed across as numpy
arrays through ``params_from_numpy``) and the same block tables, at
``dtype=float32`` on the CPU: the prefill logits of
``paged_admit_rows_and_step`` and eight ``decode_step``s after it must give
identical greedy tokens and logits within 1e-4, for the gathered and the
fused read, fp and int8 pools. The writes JAX drops and the reads it
clamps are filtered and clamped explicitly in the port; tests pin each.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kubeflow_tpu.models.decode as jdecode  # noqa: E402
from kubeflow_tpu.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.models import decode as tdecode  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.weights import flatten, params_from_numpy  # noqa: E402,E501

SLOTS, N_BLOCKS, BS, MB = 4, 12, 8, 4


@pytest.fixture(scope="module")
def models():
    spec = get_model("lm-test-tiny", dtype=jnp.float32)
    jparams = spec.init(jax.random.PRNGKey(0), spec.config)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    return spec.config, jparams, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _table():
    """Slots 0-2 own blocks (slot 1 only two, so its tail is sentinel);
    slot 3 is never admitted and stays all sentinel."""
    t = np.full((SLOTS, MB), N_BLOCKS, np.int32)
    t[0] = [3, 0, 7, 5]
    t[1, :2] = [1, 9]
    t[2] = [2, 4, 6, 8]
    return t


ADMIT = dict(
    slots=np.array([0, 1, 2, 2], np.int32),  # bucket padding repeats row 2
    toks=np.array([[5, 9, 2, 7, 1, 0], [3, 3, 0, 0, 0, 0],
                   [8, 1, 4, 4, 2, 6], [8, 1, 4, 4, 2, 6]], np.int32),
    lengths=np.array([5, 2, 6, 6], np.int32),
    remaining=np.array([8, 3, 8, 8], np.int32),
    temps=np.zeros((4,), np.float32),
)


def _jax_run(jcfg, jparams, kv_dtype, fused, steps=8, retire_at=4):
    state = jdecode.init_paged_state(jcfg, SLOTS, N_BLOCKS, BS, MB,
                                     kv_dtype=kv_dtype)
    state["block_table"] = jnp.asarray(_table())
    a = {k: jnp.asarray(v) for k, v in ADMIT.items()}
    state, last, tok, _ = jdecode.paged_admit_rows_and_step(
        state, jparams, jcfg, a["slots"], a["toks"], a["lengths"],
        a["remaining"], a["temps"], kv_fused=fused)
    toks, logits = [np.asarray(tok)], [np.asarray(state["last_logits"])]
    for i in range(steps):
        if i == retire_at:
            state = jdecode.retire_row(state, jnp.int32(2))
        state, tok, _ = jdecode.decode_step(state, jparams, jcfg,
                                            kv_fused=fused)
        toks.append(np.asarray(tok))
        logits.append(np.asarray(state["last_logits"]))
    return np.asarray(last), toks, logits, state


def _torch_run(tcfg, tparams, kv_dtype, fused, steps=8, retire_at=4):
    state = tdecode.init_paged_state(tcfg, SLOTS, N_BLOCKS, BS, MB,
                                     kv_dtype=kv_dtype, device="cpu")
    state["block_table"].copy_(torch.from_numpy(_table()))
    a = {k: torch.from_numpy(v) for k, v in ADMIT.items()}
    state, last, tok, _ = tdecode.paged_admit_rows_and_step(
        state, tparams, tcfg, a["slots"], a["toks"], a["lengths"],
        a["remaining"], a["temps"], kv_fused=fused)
    toks, logits = [tok.numpy()], [state["last_logits"].numpy().copy()]
    for i in range(steps):
        if i == retire_at:
            state = tdecode.retire_row(state, 2)
        state, tok, _ = tdecode.decode_step(state, tparams, tcfg,
                                            kv_fused=fused)
        toks.append(tok.numpy())
        logits.append(state["last_logits"].numpy().copy())
    return last.numpy(), toks, logits, state


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_admit_and_decode_steps_match_jax(models, kv_dtype, fused):
    jcfg, jparams, tcfg, tparams = models
    j_last, j_toks, j_logits, j_state = _jax_run(jcfg, jparams, kv_dtype,
                                                 fused)
    t_last, t_toks, t_logits, t_state = _torch_run(tcfg, tparams, kv_dtype,
                                                   fused)
    np.testing.assert_allclose(t_last, j_last, rtol=1e-4, atol=1e-4)
    for step, (jt, tt) in enumerate(zip(j_toks, t_toks)):
        np.testing.assert_array_equal(tt, jt, err_msg=f"step {step}")
    for jl, tl in zip(j_logits, t_logits):
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    for key in ("length", "remaining", "active"):
        np.testing.assert_array_equal(t_state[key].numpy(),
                                      np.asarray(j_state[key]))
    # The pools hold the same K/V wherever a block is owned.
    owned = sorted(int(b) for b in _table().ravel() if b < N_BLOCKS)
    for side in ("k", "v"):
        jp, tp = j_state["pool"][side], t_state["pool"][side]
        if kv_dtype == "int8":
            np.testing.assert_array_equal(
                tp["q"][:, owned].numpy(), np.asarray(jp["q"])[:, owned])
        else:
            np.testing.assert_allclose(tp[:, owned].numpy(),
                                       np.asarray(jp)[:, owned],
                                       rtol=1e-4, atol=1e-4)


def test_decode_chunk_equals_steps(models):
    _jcfg, _jparams, tcfg, tparams = models
    _, step_toks, _, _ = _torch_run(tcfg, tparams, "fp", True, steps=4,
                                    retire_at=99)
    state = tdecode.init_paged_state(tcfg, SLOTS, N_BLOCKS, BS, MB,
                                     device="cpu")
    state["block_table"].copy_(torch.from_numpy(_table()))
    a = {k: torch.from_numpy(v) for k, v in ADMIT.items()}
    state, _, tok, _ = tdecode.paged_admit_rows_and_step(
        state, tparams, tcfg, a["slots"], a["toks"], a["lengths"],
        a["remaining"], a["temps"], kv_fused=True)
    state, toks, emits = tdecode.decode_chunk(state, tparams, tcfg, 4,
                                              kv_fused=True)
    assert toks.shape == emits.shape == (4, SLOTS)
    np.testing.assert_array_equal(toks.numpy(), np.stack(step_toks[1:]))


def test_pool_write_filters_parked_and_sentinel_writes():
    """JAX drops these scatters; the port filters them. A parked row
    (pos == total), a negative position and a sentinel table entry write
    nothing, and the live write lands at (table[b, p // Bs], p % Bs)."""
    n, bs, mb = 3, 4, 2
    pool = torch.zeros(n, bs, 1, 2)
    table = torch.tensor([[2, n], [0, 1], [1, n], [0, n]], dtype=torch.int32)
    cols = torch.tensor([[5], [mb * bs], [-1], [1]], dtype=torch.int32)
    vals = torch.arange(1, 9, dtype=torch.float32).reshape(4, 1, 1, 2)
    tdecode._pool_write(pool, table, cols, vals)
    want = np.zeros((n, bs, 1, 2), np.float32)
    want[0, 1, 0] = [7, 8]  # row 3 only: rows 0-2 are dropped
    np.testing.assert_array_equal(pool.numpy(), want)
    ref = jdecode._pool_write(jnp.zeros((n, bs, 1, 2)), jnp.asarray(
        table.numpy()), jnp.asarray(cols.numpy()), jnp.asarray(vals.numpy()))
    np.testing.assert_array_equal(np.asarray(ref), want)


def test_pool_gather_clamps_sentinels_like_jax():
    rng = np.random.RandomState(4)
    pool = rng.randn(3, 4, 2, 8).astype(np.float32)
    table = np.array([[2, 3], [0, 1]], np.int32)
    ref = jdecode._pool_gather(jnp.asarray(pool), jnp.asarray(table))
    out = tdecode._pool_gather(torch.from_numpy(pool),
                               torch.from_numpy(table))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_retire_row_parks_at_total(models):
    _jcfg, _jparams, tcfg, _tparams = models
    state = tdecode.init_paged_state(tcfg, SLOTS, N_BLOCKS, BS, MB,
                                     device="cpu")
    state["active"][1] = True
    tdecode.retire_row(state, 1)
    assert not state["active"][1] and int(state["length"][1]) == MB * BS


def test_sample_token_greedy_ties_and_top_k():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 4.0, 3.0, 2.0]])
    g = torch.Generator().manual_seed(0)
    greedy = tdecode.sample_token(logits, g, torch.zeros(2))
    np.testing.assert_array_equal(greedy.numpy(), [1, 0])  # first max wins
    draws = torch.stack([tdecode.sample_token(logits, g, torch.ones(2),
                                              top_k=2)
                         for _ in range(200)])
    assert set(draws[:, 1].tolist()) <= {0, 1}  # top-2 only
    assert set(draws[:, 1].tolist()) == {0, 1}


def test_sampled_token_distribution():
    """Temperature > 0 follows softmax(logits / T): JAX keys cannot be
    reproduced, so the check is on the distribution."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.2]]))
    g = torch.Generator().manual_seed(1)
    draws = torch.cat([tdecode.sample_token(logits.expand(500, 3), g,
                                            torch.ones(500))
                       for _ in range(8)])
    freq = torch.bincount(draws.long(), minlength=3).float() / draws.numel()
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.2], atol=0.03)


def test_params_from_numpy_matches_leaf_names_and_dtypes(models):
    jcfg, jparams, _tcfg, _tparams = models
    tree = jax.tree.map(np.asarray, jparams)
    cfg16 = ttransformer.config("lm-test-tiny")
    params = params_from_numpy(tree, cfg16, "cpu")
    jflat, tflat = flatten(tree), flatten(params)
    assert set(jflat) == set(tflat)
    for name, leaf in tflat.items():
        assert tuple(leaf.shape) == jflat[name].shape
        want = (torch.float32 if name in ttransformer.NORM_LEAVES
                else torch.bfloat16)
        assert leaf.dtype == want, name


def test_init_matches_jax_layout_and_scale():
    cfg = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    params = ttransformer.init(cfg, generator=g, device="cpu")
    spec = get_model("lm-test-tiny")
    jtree = jax.tree.map(np.asarray,
                         spec.init(jax.random.PRNGKey(0), spec.config))
    tflat, jflat = flatten(params), flatten(jtree)
    assert set(tflat) == set(jflat)
    for name, leaf in tflat.items():
        assert tuple(leaf.shape) == jflat[name].shape
    wq = params["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.01
    assert (params["final_norm"] == 1).all()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttransformer.config("moe-test-tiny")


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ttransformer.config("lm-test-tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttransformer.init(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdecode.init_paged_state(cfg, 2, 4, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({}, cfg)
