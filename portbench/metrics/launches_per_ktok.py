"""The program's own launch counter (``kernels/_build.LAUNCHES``) summed
over the window, per 1000 tokens processed, prompt and generated
(numerics layer; moves ``output_tok_s``).  ``logmac`` counts each logmac
launch once; its per-kernel keys count the same launches again and are
left out."""

_AGAIN = ("logmac_small", "logmac_mma", "logmac_pieces", "logmac_tile")


def read(rec):
    n = sum(v for k, v in rec["launches"].items() if k not in _AGAIN)
    toks = sum((s.real or s.rows) if s.kind == "prefill" else s.rows
               for s in rec["spans"])
    if not toks:
        return None
    return n / (toks / 1e3)
