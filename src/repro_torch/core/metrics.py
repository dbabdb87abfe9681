"""Arithmetic error metrics of the paper (Section IV-A), on torch tensors.

Counterpart of ``repro.core.metrics``.  All metrics compare an approximate
product tensor against the exact product:
  MSE  = mean((approx - exact)^2)
  MAE  = mean(|approx - exact|)
  NMED = mean(|approx - exact|) / max(|exact|)      (normalized mean error distance)
  MRED = mean(|approx - exact| / |exact|)           (mean relative error distance)
Both tensors are taken as float32, as the reference takes them; each value
is a 0-dim float32 tensor on their device.
"""
from __future__ import annotations

import torch


def error_metrics(approx, exact):
    approx = torch.as_tensor(approx).to(torch.float32)
    exact = torch.as_tensor(exact).to(device=approx.device, dtype=torch.float32)
    err = approx - exact
    abs_err = torch.abs(err)
    aex = torch.abs(exact)
    denom = torch.clamp(torch.max(aex), min=1e-30)
    nz = aex > 1e-30
    red = torch.where(nz, abs_err / torch.clamp(aex, min=1e-30),
                      torch.zeros((), device=err.device))
    return dict(
        mse=torch.mean(err * err),
        mae=torch.mean(abs_err),
        nmed=torch.mean(abs_err) / denom,
        mred=torch.sum(red) / torch.clamp(nz.sum(), min=1).to(torch.float32),
    )
