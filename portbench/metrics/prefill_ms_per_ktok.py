"""Host time inside ``prefill_slot`` per 1000 prompt tokens, over the
window's prefills (engine layer; moves ``ttft_p50_ms``)."""


def read(rec):
    pre = [s for s in rec["spans"] if s.kind == "prefill"]
    toks = sum(s.real or s.rows for s in pre)
    if not toks:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in pre) / (toks / 1e3)
