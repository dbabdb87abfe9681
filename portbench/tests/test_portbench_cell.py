"""The harness is driven by data: a cell, a traffic mix and a per-layer
metric are found by their names from new files alone.  A harness run
holds neither JAX nor the JAX package, its reference nothing of the port,
and without a card it prints no result."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run as R
from portbench.traffic import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
NAME = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
           "0123456789_.-")


def _checkout(tmp_path):
    """A copy of the manifest and the harness's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_a_new_cell_is_found_by_name_from_new_files(tmp_path):
    root = _checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "yi6b-chat", "config": "yi-6b", "traffic": "chat",
         "chips": 1, "why": "short chat on many slots"})
    # hymba-doc's files are here: its cell needs the two entries alone
    bench["configs"].append(
        {"name": "hymba-1.5b",
         "source": "https://huggingface.co/nvidia/Hymba-1.5B-Base",
         "file": "portbench/configs/hymba-1.5b.json", "reduced": [],
         "why": "the hybrid"})
    bench["workloads"].append(
        {"name": "hymba-doc", "config": "hymba-1.5b", "traffic": "passage",
         "chips": 1, "why": "passages on the hybrid"})
    bench["per_layer"].append(
        {"name": "queue_depth", "unit": "requests", "better": "lower",
         "source": "program_counter", "layer": "scheduler",
         "moves": "ttft_p50_ms", "workloads": ["yi6b-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "traffic" / "chat.json").write_text(json.dumps(
        {"loop": "closed", "clients": 64, "prompt_len": [256, 1024],
         "len_quantum": 16, "output_len": [128, 256]}))
    (root / "portbench" / "metrics" / "queue_depth.py").write_text(
        "def read(rec):\n    return 3.0\n")
    c = R.load_cell("yi6b-chat", root=str(root))
    assert c["config"]["model"]["d_model"] == 4096
    assert Traffic.load(c["traffic"]).clients == 64
    readers = R.metric_readers(c, "per_layer")
    assert readers["queue_depth"][1]({}) == 3.0
    hymba = R.load_cell("hymba-doc", root=str(root))
    assert hymba["config"]["model"]["family"] == "hybrid"
    assert Traffic.load(hymba["traffic"]).prompt_sizes[::7] == (144, 256)
    assert "roofline_pct.paged_decode" not in R.metric_readers(hymba,
                                                               "per_layer")
    assert set(R.metric_readers(c, "end_to_end")) == {
        m["name"] for m in bench["end_to_end"]}



def test_a_new_family_is_found_from_new_files(tmp_path, monkeypatch):
    """A configuration of a new family brings ``families/<family>.py`` and
    the reference module its ``reference`` key names; the harness finds
    both by name, and no file that is there changes."""
    import portbench.families as FAM
    import portbench.reference as REF
    from portbench import check
    from portbench.counts import decode_flops, prefill_flops
    from portbench.shapes import Shapes
    from portbench.weights import make_params
    fam, ref = tmp_path / "fam", tmp_path / "ref"
    fam.mkdir()
    ref.mkdir()
    (fam / "toyssm.py").write_text(
        "from portbench.families import dense\n"
        "projections = dense.projections\n"
        "window_of = dense.window_of\n"
        "def layer_leaves(s, i):\n"
        "    return [(('layers', i, 'mix', 'w'), (s.d_model, s.extra['k']),\n"
        "             ('normal', 1.0))]\n"
        "def mixer_prompt_flops(s):\n"
        "    return 7\n"
        "def mixer_decode_flops(s):\n"
        "    return 3\n")
    (ref / "toyref.py").write_text("WHO = 'toy'\n")
    monkeypatch.setattr(FAM, "__path__", list(FAM.__path__) + [str(fam)])
    monkeypatch.setattr(REF, "__path__", list(REF.__path__) + [str(ref)])
    model = {"family": "toyssm", "n_layers": 2, "d_model": 8, "n_heads": 2,
             "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab": 32,
             "k": 5}
    s = Shapes.of(model)
    assert s.extra == {"k": 5}
    params = make_params(s, 3, "cpu")
    assert params["layers"][1]["mix"]["w"].shape == (8, 5)
    dense = Shapes.of(dict(model, family="dense"))
    assert prefill_flops(s, 10) - prefill_flops(dense, 10) == 70
    assert decode_flops(s, [4, 9]) - decode_flops(dense, [4, 9]) == 6
    assert check.reference("reference/toyref.py").WHO == "toy"
    with pytest.raises(ValueError, match="toyssm"):
        Shapes.of(dict(model, family="nosuch"))

def test_every_manifest_entry_has_its_files():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for conf in bench["configs"]:
        with open(os.path.join(ROOT, conf["file"])) as f:
            assert json.load(f)["model"]
        assert conf["reduced"] == []
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(PB, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(PB, "workloads",
                                           f"{w['name']}.json"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(PB, "metrics",
                                           f"{m['name']}.py"))
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in bench[k]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= NAME and len(n) <= 64
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def _modules_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "src")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(HERE), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_harness_run_holds_no_jax(tmp_path):
    """Top-level names compared whole: ``repro_torch`` begins with
    ``repro`` and is the program, ``repro`` is the JAX package."""
    code = f"""
import json, sys, pathlib, torch
torch.set_num_threads(2)
from portbench import run as R
from portbench_smoke import smoke_cell
c = smoke_cell(pathlib.Path({str(tmp_path)!r}), "dense")
R.run_cell(c, 7, 1.0, True, device="cpu", program=R.import_program())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _modules_after(code)
    assert "repro_torch" in top
    assert not top & set(R.FORBIDDEN)


def test_the_reference_holds_nothing_of_the_port():
    code = """
import json, sys
import portbench.check, portbench.reference.decoder, portbench.weights
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    top = _modules_after(code)
    assert not top & ({"repro_torch"} | set(R.FORBIDDEN))


def test_without_a_card_there_is_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(PB, "run.py"), "--workload",
         "yi6b-doc", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of each cell of the manifest at its full size, judged as
    the driver judges it (the card; ``python3 -m pytest -m cuda
    portbench/tests``)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cell in (w["name"] for w in bench["workloads"]):
        out = subprocess.run(
            [sys.executable, os.path.join(PB, "run.py"), "--workload", cell,
             "--seed", "2147483659", "--seconds", "15", "--trace", "0"],
            capture_output=True, text=True, timeout=900, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
