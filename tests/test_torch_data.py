"""The port's token pipeline against ``repro.data``: both sources draw with
numpy exactly as the reference does, so every batch is bit-identical for
any (seed, step, shard), returned as int64 tensors on the caller's
device."""
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSynth
from repro.data import TokenFileDataset as JFile
from repro.data import batch_for_step as j_batch_for_step
from repro_torch.data import SyntheticLM, TokenFileDataset, batch_for_step

torch.set_num_threads(1)

CASES = [(0, 0, 0, 1), (3, 7, 0, 1), (9, 123, 1, 2), (5, 2, 3, 4)]


def _same(got, want):
    for k in ("inputs", "labels"):
        assert got[k].dtype == torch.int64 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("seed,step,shard,num_shards", CASES)
@pytest.mark.parametrize("vocab", [512, 32001])
def test_synthetic_batches_bit_identical(seed, step, shard, num_shards,
                                         vocab):
    want = JSynth(vocab=vocab, seed=seed).batch(step, 8, 33, shard,
                                                num_shards)
    got = SyntheticLM(vocab=vocab, seed=seed).batch(step, 8, 33, shard,
                                                    num_shards)
    _same(got, want)
    assert got["inputs"].shape == (8 // num_shards, 33)
    # labels are the inputs shifted by one
    assert torch.equal(got["inputs"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("seed,step,shard,num_shards", CASES)
@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_token_file_batches_bit_identical(tmp_path, seed, step, shard,
                                          num_shards, dtype):
    path = str(tmp_path / "tokens.bin")
    toks = np.random.default_rng(seed).integers(
        0, 70000 if dtype == "uint32" else 65535, 5000).astype(dtype)
    toks.tofile(path)
    want = JFile(path, vocab=1000, dtype=dtype, seed=seed).batch(
        step, 4, 64, shard, num_shards)
    got = TokenFileDataset(path, vocab=1000, dtype=dtype, seed=seed).batch(
        step, 4, 64, shard, num_shards)
    _same(got, want)


def test_batch_for_step_matches_and_refuses_embeddings():
    want = j_batch_for_step(JSynth(vocab=512, seed=2), 4, 4, 16, shard=1,
                            num_shards=2)
    src = SyntheticLM(vocab=512, seed=2)
    _same(batch_for_step(src, 4, 4, 16, shard=1, num_shards=2), want)
    # the stub frontend (once refused): the reference's own table gives
    # the reference's embedding batch
    import jax
    import jax.numpy as jnp
    table = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (512, 32),
                                         jnp.float32) * 0.02)
    emb = j_batch_for_step(JSynth(vocab=512, seed=2), 0, 4, 16,
                           embeddings_dim=32)
    got = batch_for_step(src, 0, 4, 16, embeddings_dim=32, table=table)
    assert got["inputs"].dtype == torch.float32
    np.testing.assert_array_equal(got["inputs"].numpy(),
                                  np.asarray(emb["inputs"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(emb["labels"]))
    with pytest.raises(ValueError, match="multiple"):
        src.batch(0, 5, 16, num_shards=2)
    assert batch_for_step(src, 0, 2, 8, device="meta")["inputs"].is_meta
