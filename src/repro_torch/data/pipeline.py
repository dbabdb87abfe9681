"""Deterministic, stateless, shardable token pipeline.

Counterpart of ``repro.data.pipeline``.  A batch is a pure function of
(seed, step, shard_id), drawn with numpy exactly as the reference draws it,
so the port's token batches are bit-identical to the reference's; they come
back as int64 tensors on the caller's device.  A restart replays any step
without saved iterator state; hosts pass ``shard_id/num_shards`` and get
disjoint batch slices.

Two sources:
  * SyntheticLM — a second-order Markov language with zipfian marginals and
    long-range copy structure: learnable, with no external data.
  * TokenFileDataset — a memory-mapped flat token file, the same
    (seed, step) -> offsets determinism.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, 0xE07E2]))


def _as_batch(toks: np.ndarray, device) -> dict:
    t = torch.from_numpy(toks.astype(np.int64)).to(device)
    return {"inputs": t[:, :-1], "labels": t[:, 1:]}


@dataclasses.dataclass
class SyntheticLM:
    """Second-order Markov chain + copy spans, zipf marginals."""

    vocab: int
    seed: int = 0
    copy_prob: float = 0.15
    copy_back: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = min(self.vocab, 4096)  # transition table over a core vocab
        self.core = V
        # sparse-ish second-order structure: next = f(prev) + noise
        self.succ = rng.integers(0, V, size=(V, 4))
        zipf = 1.0 / np.arange(1, V + 1)
        self.marg = zipf / zipf.sum()

    def sequence(self, rng: np.random.Generator, length: int) -> np.ndarray:
        V = self.core
        out = np.empty(length, np.int32)
        out[0] = rng.choice(V, p=self.marg)
        choices = rng.integers(0, 4, size=length)
        noise = rng.random(length)
        copy_at = rng.random(length) < self.copy_prob
        back = rng.integers(1, self.copy_back + 1, size=length)
        for t in range(1, length):
            if copy_at[t] and t > back[t]:
                out[t] = out[t - back[t]]
            elif noise[t] < 0.85:
                out[t] = self.succ[out[t - 1], choices[t]]
            else:
                out[t] = rng.choice(V, p=self.marg)
        return out

    def batch(self, step: int, batch: int, seq: int, shard: int = 0,
              num_shards: int = 1, device="cpu"):
        if batch % num_shards:
            raise ValueError(f"batch {batch} is not a multiple of "
                             f"{num_shards} shards")
        rng = _rng(self.seed, step, shard)
        toks = np.stack([self.sequence(rng, seq + 1)
                         for _ in range(batch // num_shards)])
        return _as_batch(toks, device)


@dataclasses.dataclass
class TokenFileDataset:
    """Flat binary token file (uint16/uint32), memory-mapped."""

    path: str
    vocab: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self.data = np.memmap(self.path, dtype=self.dtype, mode="r")

    def batch(self, step: int, batch: int, seq: int, shard: int = 0,
              num_shards: int = 1, device="cpu"):
        if batch % num_shards:
            raise ValueError(f"batch {batch} is not a multiple of "
                             f"{num_shards} shards")
        rng = _rng(self.seed, step, shard)
        hi = len(self.data) - (seq + 1)
        offs = rng.integers(0, hi, size=batch // num_shards)
        toks = np.stack([np.asarray(self.data[o:o + seq + 1]) for o in offs])
        return _as_batch(toks.astype(np.int32) % self.vocab, device)


def embedding_table(seed: int, vocab: int, dim: int, device="cpu"):
    """The stub frontend's fixed random ``[vocab, dim]`` table times 0.02,
    drawn on the CPU from a ``torch.Generator`` seeded with ``seed`` (the
    reference draws it with ``jax.random.normal(PRNGKey(seed))``: the
    numbers differ, the distribution does not)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    t = torch.randn((vocab, dim), generator=gen, dtype=torch.float32)
    return (t * 0.02).to(device)


def batch_for_step(source, step: int, batch: int, seq: int, *, shard: int = 0,
                   num_shards: int = 1, embeddings_dim: int | None = None,
                   table=None, device="cpu"):
    """Uniform entry point.  With ``embeddings_dim`` (audio/vlm archs) the
    inputs become stub frontend embeddings: rows of a fixed random
    ``[vocab, embeddings_dim]`` table gathered by the token ids; the labels
    stay ids.  ``table`` gives the table (a tensor or numpy array, e.g. the
    reference's own); by default :func:`embedding_table` draws it from the
    source's seed."""
    b = source.batch(step, batch, seq, shard, num_shards, device=device)
    if embeddings_dim is not None:
        if table is None:
            table = embedding_table(source.seed, source.vocab,
                                    embeddings_dim, device)
        if not isinstance(table, torch.Tensor):
            table = torch.from_numpy(np.array(table, dtype=np.float32))
        table = table.to(device=device, dtype=torch.float32)
        if tuple(table.shape) != (source.vocab, embeddings_dim):
            raise ValueError(f"embedding table {tuple(table.shape)} is not "
                             f"[{source.vocab}, {embeddings_dim}]")
        ids = b["inputs"]
        rows = torch.index_select(table, 0, ids.reshape(-1))
        b = {"inputs": rows.reshape(*ids.shape, embeddings_dim),
             "labels": b["labels"]}
    return b
