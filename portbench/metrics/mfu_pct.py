"""The model FLOPs of the tokens processed in the profiled slice over its
seconds, as a share of the card's bf16 peak (device layer; moves
``output_tok_s``).  Counted in closed form (``portbench/counts.py``)."""

from portbench import counts


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0 or not rec["traced_spans"]:
        return None
    s = rec["shapes"]
    flops = 0
    for sp in rec["traced_spans"]:
        if sp.kind == "prefill":
            flops += counts.prefill_flops(s, sp.real or sp.rows)
        else:
            flops += counts.decode_flops(s, sp.contexts)
    return 100.0 * flops / (tr["window_s"] * counts.PEAK_FLOPS)
