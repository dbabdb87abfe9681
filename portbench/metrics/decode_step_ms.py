"""Host time inside ``step_slots`` over the window, divided by its calls
(engine layer; moves ``output_tok_s``)."""


def read(rec):
    st = [s for s in rec["spans"] if s.kind == "step"]
    if not st:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in st) / len(st)
