"""How ``correct`` is decided: the served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed and holding the one
with the longest prompt and one of every slot, is run through the
reference decoder the configuration names (``reference/decoder.py``) with
the weights drawn again from the seed: each request's prompt as the
program prefilled it and the tokens it served.  Each served token's gap
is how far its logit lies below the reference's best logit at its
position (greedy decoding picks the best, so a sound run reads the gaps
of near ties that the program's own rounding broke the other way).  The
numbers compared are those the cell's workload file names a limit for:
the widest gap over the sample's tokens, and the mean gap where the
widest does not separate sound runs from the control (it counts how often
and how far tokens part).  A served id outside the vocabulary reads
1e30.  A request that came back with fewer tokens than it asked for, or
failed, is counted apart and has the limit 0."""
from __future__ import annotations

import importlib
import sys

import numpy as np
import torch

from .reference import posit as RP
from .weights import make_params


def reference(path: str):
    """The reference decoder a configuration names by its ``reference``
    key: a module file under ``portbench/`` (``reference/decoder.py``),
    with ``Decoder``, ``Request`` and ``gaps``."""
    if not path.endswith(".py") or path.startswith(("/", ".")):
        raise ValueError(f"reference {path!r}: a .py file under portbench/")
    return importlib.import_module(
        "portbench." + path[:-3].replace("/", "."))


def sample(reqs, seed: int, min_tokens: int, max_requests: int):
    """The requests to compare: the longest prompt first, then one of
    each slot that served the window (drawn from the seed), then others
    drawn from the seed until ``min_tokens`` served tokens are in or
    ``max_requests`` are taken."""
    if not reqs:
        return []
    reqs = sorted(reqs, key=lambda r: r.rid)
    longest = max(reqs, key=lambda r: (len(r.packed), r.rid))
    rest = [r for r in reqs if r is not longest]
    order = [rest[int(i)] for i in
             np.random.default_rng(int(seed) + 1).permutation(len(rest))]
    out, slots = [longest], {longest.slot}
    for r in order:
        if r.slot not in slots and len(out) < max_requests:
            out.append(r)
            slots.add(r.slot)
    taken = {r.rid for r in out}
    n = sum(len(r.served) for r in out)
    for r in order:
        if n >= min_tokens or len(out) >= max_requests:
            break
        if r.rid not in taken:
            out.append(r)
            n += len(r.served)
    return out


def gaps(shapes, serve: dict, seed: int, reqs, device,
         ref: str = "reference/decoder.py", block: int = 16) -> dict:
    """Every served token's gap over ``reqs`` (each with ``packed`` and
    ``served``), a block of requests at a time: their mean (the number
    compared), the widest, the widest of first tokens (the prefill's), and
    the share of tokens that are not the reference's best."""
    D = reference(ref)
    fmt = RP.variant(serve["width"], serve["variant"])
    cache = "posit" if serve.get("cache_dtype", "").startswith("uint") \
        else "bfloat16"
    params = make_params(shapes, seed, device)
    dec = D.Decoder(shapes, fmt, cache, device,
                    page=serve.get("page_size", 16))
    all_g, first = [], []
    for b0 in range(0, len(reqs), block):
        part = [D.Request(r.packed, r.served) for r in reqs[b0:b0 + block]]
        for lg, r in zip(dec.logits(params, part), part):
            g = D.gaps(lg, r.served)
            all_g.append(g)
            first.append(float(g[0]))
    del params
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    print(f"portbench: reference weight planes {dec.planes_s:.2f} s",
          file=sys.stderr, flush=True)
    g = torch.cat(all_g)
    return {"mean": float(g.mean()), "widest": float(g.max()),
            "first": max(first), "off_best": float((g > 0).double().mean())}
