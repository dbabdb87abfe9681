"""Share of the device's kernel time in kernels that are not the port's
own (torch's and cuBLAS's, run by the reference-engine fallback): names
from the profiler, the port's listed in ``kernels/*.json`` (numerics
layer; moves ``output_tok_s``)."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["kernel_s"] <= 0:
        return None
    return 100.0 * tr["by_group"]["fallback"] / tr["kernel_s"]
