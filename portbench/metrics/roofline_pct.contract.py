"""The projections' least time over the device time of the port's
contraction kernels (the encodes and the logmac kernels), in the profiled
slice (kernels layer; moves ``output_tok_s``).  The least time counts
each projection contraction of the slice's prefills and steps in closed
form (``portbench/counts.py``): real prompt rows, active slots."""

from portbench import counts


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["by_group"].get("contract", 0.0) <= 0:
        return None
    s, w = rec["shapes"], rec["serve"]["width"]
    least = 0.0
    for sp in rec["traced_spans"]:
        if sp.kind == "prefill":
            least += counts.contract_least_s(s, sp.real or sp.rows, w, 1)
        else:
            least += counts.contract_least_s(s, sp.rows, w, sp.rows)
    return 100.0 * least / tr["by_group"]["contract"]
