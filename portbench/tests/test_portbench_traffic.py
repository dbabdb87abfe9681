"""The traffic generator: the same seed gives the same requests, and every
seed the same sizes in the same order, each the mean of its stratum of
the traffic file's distribution."""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
from statistics import NormalDist

import numpy as np
import pytest

from portbench.traffic import Traffic, _strata

HERE = os.path.dirname(os.path.abspath(__file__))
DOC = os.path.join(HERE, "..", "traffic", "doc.json")


def _take(t, seed, n, vocab=64000):
    return list(itertools.islice(t.requests(seed, vocab), n))


def test_same_seed_same_requests():
    t = Traffic.load(DOC)
    a, b = _take(t, 2 ** 31 + 5, 24), _take(t, 2 ** 31 + 5, 24)
    assert [r.max_new for r in a] == [r.max_new for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt, y.prompt)
    c = _take(t, 2 ** 31 + 6, 24)
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


def test_every_seed_replays_the_same_lengths_in_the_same_order():
    """The sizes' order is the traffic file's fixed trace; the seed draws
    only the token ids, so every seed's window holds the same work."""
    t = Traffic.load(DOC)
    runs = [_take(t, seed, 40) for seed in (0, 7, 2 ** 31 + 11)]
    lens = {tuple((len(r.prompt), r.max_new) for r in run) for run in runs}
    assert len(lens) == 1
    other = dataclasses.replace(t, order_seed=t.order_seed + 1)
    assert [(len(r.prompt), r.max_new) for r in _take(other, 0, 40)] != \
        [(len(r.prompt), r.max_new) for r in runs[0]]


def test_every_block_holds_the_same_sizes():
    t = Traffic.load(DOC)
    for seed in (0, 1, 2 ** 33 + 1):
        reqs = _take(t, seed, 4 * t.clients)
        for b in range(4):
            block = reqs[b * t.clients:(b + 1) * t.clients]
            assert sorted(len(r.prompt) for r in block) == \
                sorted(t.prompt_sizes)
            assert sorted(r.max_new for r in block) == \
                sorted(t.output_sizes)
        ids = np.concatenate([r.prompt for r in reqs])
        assert ids.min() >= 0 and ids.max() < 64000
    assert all(n % t.len_quantum == 0 for n in t.prompt_sizes)
    assert t.max_output == max(t.output_sizes)


@pytest.mark.parametrize("sigma", [0.5, 0.8, 1.2])
def test_lognormal_strata_keep_the_mean_and_the_tail(sigma):
    """Each size is the mean of its stratum: the block's mean is the
    distribution's, its sizes rise, and the last one stands above the
    quantile where the top stratum starts."""
    n, med = 8, 1500.0
    dist = {"lognormal": {"median": med, "sigma": sigma}}
    sizes = _strata(dist, n, 1)
    assert list(sizes) == sorted(sizes)
    mean = med * math.exp(sigma ** 2 / 2)
    assert abs(sizes.mean() - mean) <= 0.01 * mean
    top = med * math.exp(sigma * NormalDist().inv_cdf(1 - 1 / n))
    assert sizes[-1] > top
    x = np.random.default_rng(3).lognormal(math.log(med), sigma, 400_000)
    np.testing.assert_allclose(
        sizes, [s.mean() for s in np.array_split(np.sort(x), n)],
        rtol=0.03)
    scaled = _strata(dict(dist, scale=1 / 3, max=4032), n, 16)
    assert all(v % 16 == 0 and v <= 4032 for v in scaled)
    np.testing.assert_allclose(scaled, np.minimum(sizes / 3, 4032), atol=8)


def test_ranges_keep_their_strata():
    """A range's sizes are the middles of equal strata, in the quantum."""
    assert list(_strata([512, 1024], 8, 16)) == \
        [544, 608, 672, 736, 800, 864, 928, 992]
    assert list(_strata([8, 32], 8, 1)) == [10, 13, 16, 19, 22, 25, 28, 31]


def test_open_loops_are_refused(tmp_path):
    p = tmp_path / "open.json"
    with open(DOC) as f:
        d = json.load(f)
    d["loop"] = "open"
    p.write_text(json.dumps(d))
    try:
        Traffic.load(str(p))
    except ValueError:
        return
    raise AssertionError("an open loop was accepted")
