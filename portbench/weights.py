"""The benchmark's weights: drawn from the seed on the device in one call,
in the type they are served in (float32), laid out as the port's
parameter tree (``{"embed": {"e"}, "layers": [...], "ln_f": {"g"}}``).

Both sides get the same weights: the program is handed the tree, and the
reference draws it again from the seed once the program is gone.  The
scales are the port's init scales (fan-in ``d_in^-0.5``, the embedding
0.02, Mamba-2's conv, decay and step constants)."""
from __future__ import annotations

import math

import torch

from .shapes import Shapes

_ALIGN = 64  # elements: every leaf starts on a 256-byte boundary


def _leaves(s: Shapes):
    """(path, shape, init) of every leaf: the embedding, each layer's as
    its family lays them out, the final norm."""
    out = [(("embed", "e"), (s.vocab_padded, s.d_model), ("normal", 0.02))]
    for i in range(s.n_layers):
        out += s.fam.layer_leaves(s, i)
    out.append((("ln_f", "g"), (s.d_model,), ("ones",)))
    return out


def make_params(shapes: Shapes, seed: int, device) -> dict:
    """The parameter tree drawn from ``seed`` on ``device``: every normal
    leaf is a view of one ``torch.randn`` buffer."""
    leaves = _leaves(shapes)
    offs, total = [], 0
    for _, shape, init in leaves:
        offs.append(total)
        if init[0] == "normal":
            total += -(-math.prod(shape) // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    buf = torch.randn(total, generator=gen, device=device,
                      dtype=torch.float32)
    tree = {"layers": [{} for _ in range(shapes.n_layers)]}
    f32 = dict(dtype=torch.float32, device=device)
    for (path, shape, init), off in zip(leaves, offs):
        kind = init[0]
        if kind == "normal":
            t = buf[off:off + math.prod(shape)].view(shape).mul_(init[1])
        elif kind == "ones":
            t = torch.ones(shape, **f32)
        elif kind == "zeros":
            t = torch.zeros(shape, **f32)
        elif kind == "a_log":
            t = torch.log(torch.linspace(1.0, 16.0, shape[0], **f32))
        else:  # dt_bias: the inverse softplus of steps in [1e-3, 1e-1]
            t = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, shape[0],
                                                     **f32)))
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(node, list) else \
                node.setdefault(key, {})
        node[path[-1]] = t
    return tree

