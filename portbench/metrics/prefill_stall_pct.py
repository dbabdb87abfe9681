"""Share of the window spent inside ``prefill_slot`` while at least one
other slot was decoding: the stall every active request's next token
waits out (scheduler layer; moves ``itl_p95_ms``)."""


def read(rec):
    stall = sum(s.t1 - s.t0 for s in rec["spans"]
                if s.kind == "prefill" and s.others > 0)
    return 100.0 * stall / rec["seconds"]
