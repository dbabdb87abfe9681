"""Runnable examples of the port, one per script of the reference's
``examples/``: ``python -m repro_torch.examples.<name>`` runs on the CUDA
card, ``--device cpu`` on the CPU.  Each module's ``run(device, ...)``
takes smaller sizes for tests; its defaults are the reference script's."""
from __future__ import annotations

import argparse

import torch


def device_of(name: str) -> torch.device:
    """The device an example runs on: ``cuda`` raises without a card (no
    fallback), and pins exact f32 contractions on it."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available; pass --device cpu to run on "
                               "the CPU")
        from repro_torch.launch import pin_exact_f32
        pin_exact_f32()
    return dev


def cli(doc: str, argv=None) -> str:
    """The examples' one flag: ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv).device
