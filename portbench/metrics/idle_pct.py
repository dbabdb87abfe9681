"""Share of the profiled slice of the window with no kernel running on
the device (device layer; moves ``output_tok_s``)."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
