"""Remat policies, grouped layers and the chunked LM loss of the port
against the JAX package's, on the CPU.

Every ``jax.checkpoint`` policy of JAX's table, and ``scan_group_size`` 2,
must give the loss and gradients of JAX's ``jax.value_and_grad`` on the
same weights and tokens (of the model without remat, computed once a
model: a policy decides what the backward keeps, not what it computes);
``loss_chunks`` must give those of JAX's ``chunked_lm_head_loss``. The
port must refuse what JAX refuses, with JAX's message. What a policy keeps is counted too: the
bytes the forward saves for the backward (``saved_tensors_hooks``), and
how often the flash forward runs.

Tolerances, as ``tests/test_torch_train.py``: float32 on both sides with
sums in another order; losses to 1e-5 relative, gradients to 1e-4 of
their largest element.
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

from kubeflow_tpu.models import registry as jregistry  # noqa: E402
from kubeflow_tpu.models import transformer as jtransformer  # noqa: E402
from kubeflow_tpu.ops import losses as jlosses  # noqa: E402
from kubeflow_tpu_torch import weights  # noqa: E402
from kubeflow_tpu_torch.models import registry as tregistry  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttransformer  # noqa: E402,E501
from kubeflow_tpu_torch.ops import attention as tattn  # noqa: E402
from kubeflow_tpu_torch.ops import losses as tlosses  # noqa: E402
from kubeflow_tpu_torch.train import data as tdata  # noqa: E402

# A tiny config at head_dim 128 that asks for the splash kernel by name
# (tests/test_torch_train.py's).
TINY_HD128 = dict(vocab_size=128, d_model=256, n_layers=2, n_heads=2,
                  n_kv_heads=1, d_ff=256, max_seq_len=64, remat=False,
                  scan_layers=False, attn_impl="splash", attn_block_k=16)
POLICIES = ["dots", "dots_batched", "llm", "llm_qkv", "llm_attn", "llm_res",
            "none"]
REMATS = [{"remat": True, "remat_policy": p} for p in POLICIES] + [
    {"remat": True, "remat_policy": "llm", "scan_layers": True,
     "scan_group_size": 2},
    {"remat": True, "remat_policy": "llm_res", "scan_layers": True,
     "scan_group_size": 2},
]
REMAT_IDS = POLICIES + ["group2-llm", "group2-llm_res"]


_REFERENCES: dict = {}


def _jax_reference(base: dict, seq: int, jax_overrides: dict):
    """(weights, tokens, loss, metrics, grads) of JAX's model ``base`` with
    ``jax_overrides``, computed once per process."""
    key = (tuple(sorted(base.items())), seq,
           tuple(sorted(jax_overrides.items())))
    if key not in _REFERENCES:
        jm = jregistry.get_model("lm-test-tiny", dtype=jnp.float32,
                                 **{**base, **jax_overrides})
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                jm.config))
        tokens = np.random.default_rng(1).integers(
            0, jm.config.vocab_size, (2, seq + 1), dtype=np.int32)
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(tokens)},
                                 jm.config), has_aux=True))(tree)
        _REFERENCES[key] = (tree, tokens, float(jloss),
                            {k: float(v) for k, v in jmet.items()},
                            weights.flatten(jax.tree.map(np.asarray,
                                                         jgrads)))
    return _REFERENCES[key]


def _check_against_jax(base, overrides, seq=24, jax_overrides=None):
    tree, tokens, jloss, jmet, jgrads = _jax_reference(
        base, seq, {"remat": False} if jax_overrides is None
        else jax_overrides)
    tm = tregistry.get_model("lm-test-tiny", dtype=torch.float32,
                             **{**base, **overrides})
    params = weights.params_from_numpy(tree, tm.config, device="cpu",
                                       dtype=torch.float32)
    batch = {"tokens": tokens}
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in weights.flatten(params).items()}
    loss, met = tm.loss_fn(weights._unflatten(leaves),
                           tdata.place_batch(batch, torch.device("cpu")),
                           tm.config)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for key in ("loss", "z_loss", "tokens"):
        np.testing.assert_allclose(met[key].item(), jmet[key], rtol=1e-5)
    for path, ref in jgrads.items():
        got = leaves[path].grad.numpy()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), path


@pytest.mark.parametrize("overrides", REMATS, ids=REMAT_IDS)
def test_remat_matches_jax_tiny(overrides):
    _check_against_jax({}, overrides)


@pytest.mark.parametrize("overrides", REMATS, ids=REMAT_IDS)
def test_remat_matches_jax_hd128_splash(overrides):
    _check_against_jax(TINY_HD128, overrides, seq=16)


def test_loss_chunks_match_jax_loss_fn():
    """Against JAX's loss_fn with the same loss_chunks (its chunked head
    under jax.checkpoint), with remat on both sides."""
    chunked = {"loss_chunks": 4, "remat": True, "remat_policy": "llm"}
    _check_against_jax({}, chunked, jax_overrides=chunked)


def test_chunked_lm_head_loss_matches_jax_gradients():
    """The loss alone on ragged masks (negative labels in some chunks, one
    chunk wholly masked): loss, metrics and the gradients of x and the
    head against ``jax.grad`` of JAX's function."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 40)) / 4).astype(np.float32)
    labels = rng.integers(0, 40, 32).astype(np.int32)
    labels[3] = labels[17] = -1
    labels[24:] = -1

    def jfn(x, head):
        return jlosses.chunked_lm_head_loss(x, head, jnp.asarray(labels),
                                            z_loss=1e-4, n_chunks=4)

    (jloss, jmet), (jdx, jdh) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    loss, met = tlosses.chunked_lm_head_loss(
        tx, th, torch.from_numpy(labels), z_loss=1e-4, n_chunks=4)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key in ("loss", "z_loss", "tokens"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   rtol=1e-5)
    for got, ref in ((tx.grad, jdx), (th.grad, jdh)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    with torch.no_grad():  # an inference call opens no region
        again, _ = tlosses.chunked_lm_head_loss(
            tx, th, torch.from_numpy(labels), z_loss=1e-4, n_chunks=4)
    assert again.item() == loss.item()
    with pytest.raises(ValueError, match="not divisible by n_chunks"):
        tlosses.chunked_lm_head_loss(tx, th, torch.from_numpy(labels),
                                     n_chunks=5)


@pytest.mark.parametrize("overrides", [
    {"remat": True, "remat_policy": "llm_attn", "scan_group_size": 2},
    {"remat": True, "remat_policy": "llm_attn", "n_experts": 4},
    {"scan_group_size": 2, "scan_layers": False},
    {"scan_group_size": 3},
], ids=["llm_attn-group", "llm_attn-moe", "group-unscanned",
        "group-indivisible"])
def test_refusals_carry_jax_messages(overrides):
    jcfg = jtransformer.config("lm-test-tiny", dtype=jnp.float32,
                               **overrides)
    jparams = jtransformer.init(jax.random.PRNGKey(0), jcfg)
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError) as jerr:
        jtransformer.hidden_states(jparams, jnp.asarray(tokens), jcfg)
    dense = ttransformer.config("lm-test-tiny", dtype=torch.float32)
    # The dense init serves every case: the refusal comes before any
    # layer runs.
    tcfg = replace(dense, **overrides)
    params = ttransformer.init(dense, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    with pytest.raises(ValueError) as terr:
        ttransformer.hidden_states(params, torch.from_numpy(tokens), tcfg)
    assert str(terr.value) == str(jerr.value)


def _saved_bytes(overrides):
    """Bytes of the distinct storages the forward saves for the backward,
    the parameters' own storages left out."""
    tm = tregistry.get_model("lm-test-tiny", dtype=torch.float32,
                             **overrides)
    params = tm.init(tm.config, generator=torch.Generator().manual_seed(0),
                     device="cpu", param_dtype=torch.float32)
    for p in weights.flatten(params).values():
        p.requires_grad_(True)
    own = {p.untyped_storage().data_ptr()
           for p in weights.flatten(params).values()}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            saved[st.data_ptr()] = st.nbytes()
        return t

    batch = tdata.place_batch(tdata.synthetic_batch(tm, 2, 24, seed=1),
                              torch.device("cpu"))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tm.loss_fn(params, batch, tm.config)
    loss.backward()
    return sum(saved.values())


def test_saved_bytes_order_none_llm_no_remat():
    """"none" keeps each layer's input, "llm" also the attention context
    and the gate and up products, no remat every activation."""
    none = _saved_bytes({"remat": True, "remat_policy": "none"})
    llm = _saved_bytes({"remat": True, "remat_policy": "llm"})
    full = _saved_bytes({"remat": False})
    assert none < llm < full, (none, llm, full)


@pytest.mark.parametrize("policy,runs", [
    ("llm", 2), ("none", 2), ("dots", 2), ("llm_res", 1), ("llm_attn", 1),
])
def test_flash_forward_runs_again_only_where_jax_reruns_it(monkeypatch,
                                                           policy, runs):
    """The flash forward's computation (here its plain version) runs once
    a layer in the forward and, for every policy but "llm_res" (which
    keeps its out and lse) and "llm_attn" (attention outside any region),
    once more in the backward."""
    calls = []
    plain = tattn._flash_fwd_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tattn, "_flash_fwd_plain", counted)
    tm = tregistry.get_model("lm-test-tiny", dtype=torch.float32,
                             remat=True, remat_policy=policy)
    params = tm.init(tm.config, generator=torch.Generator().manual_seed(0),
                     device="cpu", param_dtype=torch.float32)
    for p in weights.flatten(params).values():
        p.requires_grad_(True)
    batch = tdata.place_batch(tdata.synthetic_batch(tm, 2, 16, seed=1),
                              torch.device("cpu"))
    loss, _ = tm.loss_fn(params, batch, tm.config)
    assert len(calls) == tm.config.n_layers
    loss.backward()
    assert len(calls) == runs * tm.config.n_layers
