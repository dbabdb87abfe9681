"""A cell at SMOKE size for the CPU tests: the port's SMOKE configs, a
short closed loop of two clients, the kernels' plain versions."""
from __future__ import annotations

import dataclasses
import json
import os

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_cell(tmp_path, family: str):
    from repro_torch import configs
    arch = "yi-6b" if family == "dense" else "hymba-1.5b"
    model = dataclasses.asdict(configs.get_config(arch).SMOKE)
    if family == "dense":
        serve = {"backend": "cuda", "width": 16, "variant": "L-21b",
                 "max_len": 256, "paged": True, "page_size": 16,
                 "cache_dtype": "uint16"}
    else:
        serve = {"backend": "cuda", "width": 16, "variant": "L-21b",
                 "max_len": 256, "paged": False,
                 "bucket": model["ssm_chunk"], "cache_dtype": "bfloat16"}
    traffic = {"loop": "closed", "clients": 2, "prompt_len": [32, 96],
               "len_quantum": 16, "output_len": [3, 6]}
    path = tmp_path / f"traffic-{family}.json"
    path.write_text(json.dumps(traffic))
    return {"bench": {}, "cell": {"name": f"smoke-{family}"},
            "config": {"model": model, "serve": serve,
                       "reference": "reference/decoder.py"},
            "workload": {"check": {"min_tokens": 24, "max_requests": 6,
                                   "limits": {"widest_gap": 0.1,
                                              "mean_gap": 0.01}},
                         "trace": {"lead_s": 0.2, "slice_s": 0.5}},
            "dir": PB, "traffic": str(path)}
