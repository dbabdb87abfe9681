"""Paged decode's least time (each active slot's K and V posit words over
its context, q and the output, at the HBM rate) over the device time of
the paged-decode kernels, in the profiled slice (kernels layer; moves
``output_tok_s``)."""

from portbench import counts


def read(rec):
    tr = rec["trace"]
    if tr is None or not rec["serve"].get("paged"):
        return None
    dev = tr["by_group"].get("paged_decode", 0.0)
    if dev <= 0:
        return None
    s = rec["shapes"]
    w = 16 if rec["serve"].get("cache_dtype") == "uint16" else 8
    least = sum(counts.paged_decode_least_s(
        s, [c + 1 for c in sp.contexts], w)
        for sp in rec["traced_spans"] if sp.kind == "step")
    return 100.0 * least / dev
