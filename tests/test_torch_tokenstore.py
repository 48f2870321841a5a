"""The port's copy of the token store against the JAX package's, on the CPU.

The same file, seed, ``start_step`` and shard give the same batches from
both, through the native library and through the numpy path, and the
copied C++ source is the JAX package's byte for byte. Token batches are
integers: equality is exact.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Six test workers share the host's cores: cap torch's intra-op
# threads so the timing tests of other files keep their cadence.
torch.set_num_threads(2)

from kubeflow_tpu.train import tokenstore as jstore  # noqa: E402
from kubeflow_tpu_torch.train import tokenstore as tstore  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "corpus.ktpu")
    rng = np.random.default_rng(0)
    tstore.write_token_file(path, rng.integers(0, 32_000, 20_000))
    return path


def test_written_files_are_byte_identical(tmp_path):
    tokens = np.arange(1000, dtype=np.int32) * 7
    jstore.write_token_file(str(tmp_path / "j.ktpu"), tokens)
    tstore.write_token_file(str(tmp_path / "t.ktpu"), tokens)
    assert filecmp.cmp(tmp_path / "j.ktpu", tmp_path / "t.ktpu",
                       shallow=False)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed,start_step,shard,num_shards", [
    (0, 0, 0, 1), (7, 5, 0, 1), (7, 5, 1, 2), (123, 40, 3, 4),
])
def test_stream_equals_jax(corpus, native, seed, start_step, shard,
                           num_shards):
    ours = tstore.TokenStore(corpus, native=native)
    theirs = jstore.TokenStore(corpus, native=native)
    try:
        assert ours.native == native and ours.n_tokens == theirs.n_tokens
        a = ours.stream(4, 64, seed=seed, start_step=start_step,
                        shard=shard, num_shards=num_shards)
        b = theirs.stream(4, 64, seed=seed, start_step=start_step,
                          shard=shard, num_shards=num_shards)
        for _ in range(3):
            np.testing.assert_array_equal(next(a)["tokens"],
                                          next(b)["tokens"])
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_sequential_batches_equal_jax(corpus, native):
    ours = tstore.TokenStore(corpus, native=native)
    theirs = jstore.TokenStore(corpus, native=native)
    try:
        for start_row, shard in ((0, 0), (5, 1), (300, 3)):
            np.testing.assert_array_equal(
                ours.sequential_batch(4, 128, start_row=start_row,
                                      shard=shard, num_shards=4),
                theirs.sequential_batch(4, 128, start_row=start_row,
                                        shard=shard, num_shards=4))
    finally:
        ours.close()
        theirs.close()


def test_native_and_numpy_paths_are_bit_identical(corpus):
    native = tstore.TokenStore(corpus, native=True)
    fallback = tstore.TokenStore(corpus, native=False)
    try:
        for step in (0, 1, 17):
            np.testing.assert_array_equal(
                native.sample_batch(8, 129, seed=42, step=step),
                fallback.sample_batch(8, 129, seed=42, step=step))
    finally:
        native.close()


def test_copied_source_is_byte_identical_and_builds_in_the_port():
    ours = os.path.join(REPO, "kubeflow_tpu_torch", "native",
                        "tokenstore.cc")
    theirs = os.path.join(REPO, "kubeflow_tpu", "native", "tokenstore.cc")
    assert filecmp.cmp(ours, theirs, shallow=False)
    lib = tstore._build_library()
    assert lib is not None
    assert os.path.dirname(lib) == os.path.join(REPO, "build",
                                                "kubeflow_tpu_torch")
    assert tstore._SOURCE == ours


def test_short_corpus_raises_on_both_paths(tmp_path):
    path = str(tmp_path / "short.ktpu")
    tstore.write_token_file(path, np.arange(10))
    for native in (True, False):
        store = tstore.TokenStore(path, native=native)
        with pytest.raises(ValueError, match="shorter than window"):
            store.sample_batch(2, 11)
        store.close()
