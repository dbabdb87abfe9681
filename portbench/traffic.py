"""The one traffic generator: a traffic file's parameters and a seed give
the sequence of requests the clients send, in order.

A file (``traffic/<name>.json``) holds::

  {"loop": "closed", "clients": 8, "len_quantum": 16,
   "prompt_len": {"lognormal": {"median": 1500, "sigma": 0.8},
                  "scale": 0.3333, "min": 16, "max": 4032},
   "output_len": [8, 32]}

A length is either a range ``[lo, hi]`` (uniform) or a log-normal
distribution with its median and sigma, times ``scale`` (default 1),
clipped to ``[min, max]``.  Requests come in blocks of ``clients``: every
block holds the same lengths, the mean of each of ``clients`` equal-
probability strata of the distribution (rounded to the quantum; for a
range, the middle of each of equal strata), paired and ordered anew in
each block.  The strata's means keep the distribution's mean and its
tail's weight: the last stratum stands for the top ``1/clients`` of it,
and the warm loop's first block serves every length the window serves.

The order of the lengths is one fixed trace that every seed replays,
drawn from ``order_seed`` (default 0); ``--seed`` draws the token ids,
uniform over the vocabulary.  So every seed sends the same sizes in the
same order and a window holds the same work whatever the seed: with a
heavy tail, where a window of some three blocks cuts the sequence would
otherwise move its rate and tails by tens of percent from seed to seed.
A closed loop hands the next request of the sequence to the client that
has just completed one."""
from __future__ import annotations

import dataclasses
import json
import math
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass(frozen=True)
class Spec:
    prompt: np.ndarray      # int32 token ids
    max_new: int


def _strata(dist, n: int, q: int) -> np.ndarray:
    """The ``n`` block sizes of a length distribution, in multiples of
    ``q`` (above ``lo`` for a range)."""
    if isinstance(dist, (list, tuple)):
        lo, hi = dist
        steps = (hi - lo) / q
        mid = (np.arange(n) + 0.5) * steps / n
        return lo + q * np.floor(mid + 0.5).astype(np.int64)
    ln = dist["lognormal"]
    m, s = float(ln["median"]) * float(dist.get("scale", 1.0)), \
        float(ln["sigma"])
    Z = NormalDist()
    edges = [-math.inf] + [Z.inv_cdf(i / n) for i in range(1, n)] \
        + [math.inf]
    cdf = [0.0 if e == -math.inf else 1.0 if e == math.inf
           else Z.cdf(e - s) for e in edges]
    # E[X | stratum i] = m e^{s^2/2} (Phi(b - s) - Phi(a - s)) / (1/n)
    means = [m * math.exp(s * s / 2) * (cdf[i + 1] - cdf[i]) * n
             for i in range(n)]
    out = q * np.floor(np.asarray(means) / q + 0.5).astype(np.int64)
    return np.clip(out, int(dist.get("min", q)), int(dist.get("max", 1 << 30)))


@dataclasses.dataclass(frozen=True)
class Traffic:
    loop: str
    clients: int
    prompt_sizes: tuple[int, ...]
    output_sizes: tuple[int, ...]
    len_quantum: int
    order_seed: int = 0

    @classmethod
    def load(cls, path) -> "Traffic":
        with open(path) as f:
            d = json.load(f)
        if d["loop"] != "closed":
            raise ValueError(f"loop {d['loop']!r}: the generator drives a "
                             "closed loop")
        n, q = int(d["clients"]), int(d.get("len_quantum", 1))
        return cls(loop=d["loop"], clients=n,
                   prompt_sizes=tuple(int(v) for v in
                                      _strata(d["prompt_len"], n, q)),
                   output_sizes=tuple(int(v) for v in
                                      _strata(d["output_len"], n, 1)),
                   len_quantum=q, order_seed=int(d.get("order_seed", 0)))

    @property
    def max_output(self) -> int:
        return max(self.output_sizes)

    def requests(self, seed: int, vocab: int):
        """The endless sequence of request specs for ``seed``."""
        order = np.random.default_rng(self.order_seed)
        rng = np.random.default_rng(int(seed))
        plens = np.asarray(self.prompt_sizes)
        olens = np.asarray(self.output_sizes)
        while True:
            for p, o in zip(order.permutation(plens),
                            order.permutation(olens)):
                ids = rng.integers(0, vocab, int(p), dtype=np.int64)
                yield Spec(ids.astype(np.int32), int(o))
