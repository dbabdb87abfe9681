"""Layer 0 of gemma2-2b FULL under the production placement on (data,
model) = (1, 2) gloo ranks sharing one card, against one process, at P16
L-21b on the ``cuda`` backend: where a placed rank's numbers part from one
process's.

    python3 scripts/placed_layer0.py              # on the card
    python3 scripts/placed_layer0.py --smoke      # SMOKE size on the CPU

Runs layer 0 of the seed-0 model (chip_smoke 3l(e)'s weights) on a 4 x
16-token prompt, forward and head, twice on each rank: with the
column-parallel products' logmac K-split planned for the whole product's
columns (``logmac.column_block``, the port's path; each such call is then
replayed with the whole weight and its columns held bit for bit,
``chip_smoke.recording``), and with the K-split planned for the rank's
own columns.  Both keep the row-parallel products' sum over the two
ranks.  Prints, for each, the max |diff| from one process's of the two
row-parallel products' inputs (the rank's block of the features) and
outputs (attention's ``wo``, the MLP's down projection), of layer 0's
output and of its logits, with the logits' share outside rtol 1e-4 / atol
2e-3, then the card's name and power limit and one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
from chip_smoke import (PLACED_PROMPT, _Checks, _l21b, card_line,  # noqa: E402
                        recording)

RANKS_DIR = os.path.join(ROOT, "build", "placed_layer0_ranks")


def layer0(smoke: bool, device: str):
    """The 1-layer model and layer 0 of the seed-0 model's parameters."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.models.transformer import Model
    cfg = gemma2_2b.SMOKE if smoke else gemma2_2b.FULL
    params = Model(cfg, numerics=_l21b("cuda"), device=device).init(0)
    params = {"embed": params["embed"], "layers": params["layers"][:1],
              "ln_f": params["ln_f"]}
    cfg = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    return Model(cfg, numerics=_l21b("cuda"), device=device), params


def forward(model, params, ids, ctx, checks=None):
    """{layer 0's logits, its output, the row-parallel products' inputs
    and outputs in call order, its pre-scales and the head's}; ``checks``
    hold the layer's calls (not the head's: the plain encode of a [2304,
    128000] block takes ~20 GiB of int64 temporaries)."""
    import torch
    from repro_torch.models import layers as L
    rows, row_apply = [], L.row_apply

    def spy(p, h, ctx, h_split=False):
        y = row_apply(p, h, ctx, h_split)
        rows.append((h.float().cpu(), y.float().cpu()))
        return y
    L.row_apply = spy
    try:
        with torch.no_grad():
            with recording(checks) as rec:
                hidden = model.forward(params, ids, ctx)[0]
            with recording() as rec_head:
                h = model.head(params, hidden, ctx)
    finally:
        L.row_apply = row_apply
    return {"logits": h.float().cpu(), "hidden": hidden.float().cpu(),
            "rows": rows, "scales": rec + rec_head}


def rank_body(rank, world, store, smoke, ids):
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import logmac as LM
    from repro_torch.launch import pin_exact_f32
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import Ctx
    device = "cpu" if smoke else "cuda"
    if not smoke:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    pin_exact_f32()
    try:
        model, whole = layer0(smoke, device)
        mesh = make_mesh((1, 2), ("data", "model"), device=device)
        params = SH.place(whole, SH.params_pspecs(whole, mesh), mesh)
        ctx = Ctx(numerics=model.numerics, mesh=mesh,
                  placement="production")
        ids = ids.to(device)
        checks = _Checks(column_group=ctx.model_group)
        out = {"whole": forward(model, params, ids, ctx, checks)}
        block = LM.column_block
        LM.column_block = lambda parts: contextlib.nullcontext()
        try:
            out["own"] = forward(model, params, ids, ctx)
        finally:
            LM.column_block = block
        out["columns"] = sorted(set(checks.columns))
        out["column_checks"] = len(checks.columns)
        torch.save(out, os.path.join(RANKS_DIR, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="gemma2-2b SMOKE on the CPU's plain kernels")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch.launch import pin_exact_f32
    from repro_torch.models.layers import Ctx
    if not args.smoke and not torch.cuda.is_available():
        print("placed_layer0: no CUDA device available", file=sys.stderr)
        return 2
    pin_exact_f32()
    device = "cpu" if args.smoke else "cuda"
    if not args.smoke:
        from repro_torch.kernels import _build
        _build.build_all()
    model, whole = layer0(args.smoke, device)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab, size=PLACED_PROMPT).astype(np.int64))
    ref = forward(model, whole, ids.to(device), Ctx(numerics=model.numerics))
    del model, whole
    if not args.smoke:
        torch.cuda.empty_cache()
    shutil.rmtree(RANKS_DIR, ignore_errors=True)
    os.makedirs(RANKS_DIR)
    try:
        mp.spawn(rank_body, args=(2, os.path.join(RANKS_DIR, "store"),
                                  args.smoke, ids), nprocs=2, join=True)
        ranks = [torch.load(os.path.join(RANKS_DIR, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(RANKS_DIR, ignore_errors=True)
    res = {"config": "gemma2-2b " + ("SMOKE" if args.smoke else "FULL"),
           "layers": 1, "prompt": list(PLACED_PROMPT), "format": "P16 L-21b",
           "column_checks": ranks[0]["column_checks"],
           "columns": ranks[0]["columns"]}
    def worst(name, fn):
        return max(float((fn(r[name], i) - fn(ref, i)).abs().max())
                   for i, r in enumerate(ranks))

    def block(h, i):         # rank i's block of one process's features
        n = h.shape[-1] // 2
        return h[..., i * n:(i + 1) * n]

    for name in ("whole", "own"):
        got = {"prescales_equal": all(r[name]["scales"] == ref["scales"]
                                      for r in ranks)}
        for j, what in enumerate(("wo", "down")):
            got[what + "_input"] = max(float((
                r[name]["rows"][j][0] - block(ref["rows"][j][0], i)
            ).abs().max()) for i, r in enumerate(ranks))
            got[what + "_output"] = worst(
                name, lambda o, i, j=j: o["rows"][j][1])
        got["layer0_output"] = worst(name, lambda o, i: o["hidden"])
        got["logits"] = worst(name, lambda o, i: o["logits"])
        got["logits_outside_bar"] = max(float((~torch.isclose(
            r[name]["logits"], ref["logits"], rtol=1e-4, atol=2e-3)
        ).float().mean()) for r in ranks)
        res[f"split_for_{name}_columns"] = got
        print(f"K-split for the {name} columns: max |diff| from one "
              f"process's {got}")
    if not args.smoke:
        print(card_line())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
