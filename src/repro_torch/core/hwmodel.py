"""Analytical hardware cost model calibrated to the paper's tables.

Counterpart of ``repro.core.hwmodel`` (numpy only; the tables are copied
as data).  Silicon metrics (LUTs, GHz, mW, mm^2) are properties of the
28-nm ASIC / FPGA implementation, not of a program, so this module embeds
the paper's published design points verbatim (Tables II, III, IV, V, IX) and exposes

  * direct lookups — the benchmark harness reprints each paper table from
    these records so the reproduction is auditable;
  * a structural regression ``predict_fpga`` following the paper's own cost
    narrative (mantissa datapath cost ~ stages x retained width; bounded
    regime shrinks decode/encode; EDP = P * D^2) for configurations between
    the published points.

Throughput identities recovered from Table IV (exact to table precision):
    TP_P8  = 40.00 * freq_GHz      [GOPS]
    TP_P16 = 18.95 * freq_GHz
    TP_P32 =  4.21 * freq_GHz
    EE     = TP / power,   CD = TP / area / 10 (the paper's convention)
"""
from __future__ import annotations

import numpy as np

VARIANTS = ("R4BM", "L-1", "L-2", "L-21", "L-22", "L-1b", "L-2b", "L-21b", "L-22b")

# (LUTs, FFs, delay_ns, power_mW, EDP_aJs) — Table II
FPGA = {
    ("scalar", 8): {
        "R4BM": (517, 175, 2.69, 93, 0.67), "L-1": (414, 141, 1.90, 64.3, 0.24),
        "L-2": (438, 149, 2.01, 70.1, 0.29), "L-21": (409, 139, 1.87, 63.2, 0.23),
        "L-22": (416, 141, 1.89, 64.6, 0.24), "L-1b": (306, 105, 1.07, 29.58, 0.17),
        "L-2b": (322, 110, 1.15, 33.4, 0.24), "L-21b": (303, 98, 1.04, 29.1, 0.16),
        "L-22b": (310, 112, 1.10, 30.4, 0.19)},
    ("scalar", 16): {
        "R4BM": (1874, 528, 4.35, 159, 3.0), "L-1": (1495, 412, 2.77, 102, 0.79),
        "L-2": (1600, 440, 2.96, 109.9, 0.97), "L-21": (1478, 406, 2.73, 100.4, 0.75),
        "L-22": (1510, 417, 2.79, 103.5, 0.81), "L-1b": (784, 208, 1.86, 76.4, 0.53),
        "L-2b": (824, 225, 1.93, 79.5, 0.62), "L-21b": (752, 217, 1.83, 73.2, 0.48),
        "L-22b": (763, 189, 1.88, 75.3, 0.51)},
    ("simd_8_16", 16): {
        "R4BM": (2486, 801, 5.10, 214, 5.6), "L-1": (1702, 525, 3.13, 118.9, 1.17),
        "L-2": (1810, 558, 3.35, 127.8, 1.45), "L-21": (1680, 518, 3.09, 116.6, 1.11),
        "L-22": (1716, 530, 3.16, 120.5, 1.20), "L-1b": (1182, 389, 1.82, 59.6, 0.67),
        "L-2b": (1260, 406, 1.97, 67.2, 0.86), "L-21b": (1157, 353, 1.75, 60.8, 0.62),
        "L-22b": (1209, 392, 1.80, 62.9, 0.69)},
    ("scalar", 32): {
        "R4BM": (4134, 1580, 10.6, 402, 45.2), "L-1": (3510, 1330, 4.40, 227, 4.40),
        "L-2": (3730, 1415, 4.95, 242, 5.90), "L-21": (3480, 1320, 4.35, 224.5, 4.25),
        "L-22": (3520, 1335, 4.40, 227.5, 4.45), "L-1b": (2420, 925, 2.53, 113, 3.62),
        "L-2b": (2598, 992, 2.92, 128, 3.45), "L-21b": (2458, 898, 2.47, 116, 3.53),
        "L-22b": (2475, 987, 2.51, 119, 3.74)},
    ("simd_8_16_32", 32): {
        "R4BM": (6163, 1875, 2.50, 569, 3.56), "L-1": (4390, 1990, 5.50, 252, 7.60),
        "L-2": (4810, 1840, 5.55, 255.5, 7.90), "L-21": (4310, 1930, 5.30, 245.5, 6.90),
        "L-22": (4470, 2020, 5.70, 260, 8.50), "L-1b": (3028, 1396, 3.16, 126.8, 4.22),
        "L-2b": (3349, 1286, 3.28, 135.7, 4.86), "L-21b": (3020, 1318, 3.04, 128.1, 3.94),
        "L-22b": (3142, 1494, 3.22, 134.2, 4.63)},
}
FPGA_PRIOR = {"TCAS-II'24": (8054, 1718, 4.62, 296, 6.4),
              "TVLSI'22": (8065, 1072, 5.56, 376, 11.6),
              "TCAS-II'22": (5972, 1634, 3.74, 499, 7.0)}

# (fxp_mae%, fxp_mse%, posit_mae%, posit_mse%, area_mm2, freq_GHz, power_mW) — Table III
ASIC = {
    "Exact": (0, 0, 0.04, 0.09, 0.052, 0.67, 99),
    "L-1": (15.10, 1.21, 6.00, 0.43, 0.022, 1.52, 30.3),
    "L-2": (11.84, 0.99, 5.04, 0.35, 0.024, 1.12, 32.7),
    "L-21": (12.70, 1.06, 5.42, 0.39, 0.021, 1.38, 30.3),
    "L-22": (12.20, 1.01, 5.18, 0.37, 0.022, 1.28, 30.5),
    "L-1b": (15.90, 1.27, 6.45, 0.47, 0.015, 1.84, 20.7),
    "L-2b": (12.60, 1.04, 5.35, 0.38, 0.016, 1.56, 22.1),
    "L-21b": (13.35, 1.10, 5.82, 0.41, 0.013, 1.72, 19.8),
    "L-22b": (12.90, 1.08, 5.56, 0.39, 0.014, 1.66, 20.5),
}

# stage-wise area um^2 / power mW: (S0, S2S3, S4S5, S5out), freq, EDP(1e-5 fJ.s) — Table V
STAGEWISE = {
    "L-1": ((2156, 11782, 3058, 5714), (1.78, 11.8, 9.2, 7.52), 1.52, 1.32),
    "L-2": ((2156, 13185, 3058, 5714), (1.78, 14.2, 9.2, 7.52), 1.12, 2.61),
    "L-21": ((2156, 10353, 2586, 5714), (1.78, 12.4, 8.6, 7.52), 1.38, 1.59),
    "L-22": ((2156, 11072, 2586, 5714), (1.78, 13.4, 7.8, 7.52), 1.28, 1.86),
    "L-1b": ((990, 9285, 2281, 2892), (0.82, 9.3, 6.8, 3.8), 1.84, 0.61),
    "L-2b": ((990, 9840, 2281, 2892), (0.82, 10.6, 6.8, 3.8), 1.56, 0.91),
    "L-21b": ((990, 7382, 1958, 2892), (0.82, 8.8, 6.4, 3.8), 1.72, 0.67),
    "L-22b": ((990, 8324, 1958, 2892), (0.82, 10.1, 5.8, 3.8), 1.66, 0.74),
}
STAGEWISE_PRIOR = {
    "TCAD'24": ((6575, 14735, 3058, 6320), (24.5, 20.5, 12.0, 25.5), 1.47, 3.82),
    "TCAS-II'22": ((8079, 22772, 13273, 5855), (16.2, 43.5, 26.0, 14.0), 0.67, 22.2),
}

# (latency_ms, power_W, energy_mJ_per_frame) — Table IX, Tiny-YOLOv3 @ Pynq-Z2
PROTOTYPE = {
    "L-1": (108, 0.44, 47.5), "L-2": (128, 0.53, 67.8), "L-21": (104, 0.42, 43.8),
    "L-22": (116, 0.48, 55.6), "L-1b": (82, 0.31, 25.4), "L-2b": (95, 0.36, 34.2),
    "L-21b": (78, 0.29, 22.6), "L-22b": (86, 0.33, 28.4),
}
PROTOTYPE_PRIOR = {
    "Design-A/VC707": (186, 2.24, 416.6), "Jetson Nano": (226, 1.34, 302.8),
    "STM32N6": (195, 0.90, 175.5), "Raspberry Pi": (555, 2.70, 1498.5),
    "Design-B/VC707": (772, 1.54, 1188.9), "Portenta H7": (460, 2.05, 943.0),
    "Nicla Vision": (520, 2.88, 1497.6),
}

_TP_PER_GHZ = {8: 40.0, 16: 18.95, 32: 4.21}
_KNOBS = {8: (2, 3, 4, 5), 16: (4, 6, 8, 10), 32: (8, 12, 16, 20)}


def throughput_gops(freq_ghz: float, width: int) -> float:
    return _TP_PER_GHZ[width] * freq_ghz


def perf_metrics(variant: str):
    """Table IV row from the ASIC record (freq/power/area identities)."""
    _, _, _, _, area, freq, power = ASIC[variant]
    out = {"freq_ghz": freq, "power_mw": power, "area_mm2": area}
    for w in (8, 16, 32):
        tp = throughput_gops(freq, w)
        out[f"tp_p{w}_gops"] = tp
        out[f"ee_p{w}_tops_w"] = tp / power
        out[f"cd_p{w}_tops_mm2"] = tp / area / 10.0 / 1000.0
    return out


def _features(width: int, variant: str, simd: bool):
    n_lo, n_hi, m_lo, m_hi = _KNOBS[width]
    bounded = variant.endswith("b")
    base = variant[:-1] if bounded else variant
    n, m = {"R4BM": (0, None), "L-1": (n_lo, None), "L-2": (n_hi, None),
            "L-21": (n_hi, m_lo), "L-22": (n_hi, m_hi)}[base if base in
            ("R4BM", "L-1", "L-2", "L-21", "L-22") else "L-2"]
    W = width - 1 - {8: 0, 16: 1, 32: 2}[width]
    m_eff = W if m is None else m
    exact = base == "R4BM"
    return np.array([1.0, width, n * m_eff if not exact else W * W,
                     m_eff if not exact else W, float(bounded), float(exact),
                     float(simd)])


_fit_cache: dict[int, np.ndarray] = {}


def _fit(col: int) -> np.ndarray:
    if col in _fit_cache:
        return _fit_cache[col]
    X, y = [], []
    for (simd, width), rows in FPGA.items():
        for var, vals in rows.items():
            X.append(_features(width, var, simd != "scalar"))
            y.append(vals[col])
    coef, *_ = np.linalg.lstsq(np.asarray(X), np.asarray(y), rcond=None)
    _fit_cache[col] = coef
    return coef


def predict_fpga(width: int, variant: str, simd: bool = False):
    """Structural-regression prediction (LUTs, FFs, delay, power, EDP)."""
    f = _features(width, variant, simd)
    luts, ffs, delay, power = (float(f @ _fit(c)) for c in range(4))
    edp = power * delay * delay * 1e-3
    return {"luts": luts, "ffs": ffs, "delay_ns": delay, "power_mw": power,
            "edp_ajs": edp}


def headline_claims():
    """The abstract's claims, recomputed from the embedded tables.
    41.4%/76.1%/71.9% resolve to the scalar 32-bit L-1b row of Table II;
    the 10x EDP to scalar-32 L-21 vs R4BM."""
    lut_red = 1 - FPGA[("scalar", 32)]["L-1b"][0] / FPGA[("scalar", 32)]["R4BM"][0]
    delay_red = 1 - FPGA[("scalar", 32)]["L-1b"][2] / FPGA[("scalar", 32)]["R4BM"][2]
    power_red = 1 - FPGA[("scalar", 32)]["L-1b"][3] / FPGA[("scalar", 32)]["R4BM"][3]
    edp_ratio = FPGA[("scalar", 32)]["R4BM"][4] / FPGA[("scalar", 32)]["L-21"][4]
    area_red = 1 - ASIC["L-21b"][4] / ASIC["Exact"][4]
    asic_power_red = 1 - ASIC["L-21b"][6] / ASIC["Exact"][6]
    return {
        "lut_reduction_best": lut_red,          # paper: up to 41.4% (NCE level)
        "delay_reduction_best": delay_red,      # paper: up to 76.1%
        "power_reduction_best": power_red,      # paper: up to 71.9%
        "edp_ratio_32b": edp_ratio,             # paper: up to 10x
        "asic_area_reduction": area_red,        # paper: up to 75%
        "asic_power_reduction": asic_power_red, # paper: up to 80%
        "max_freq_ghz": ASIC["L-1b"][5],        # paper: 1.84 GHz
        "min_power_mw": ASIC["L-21b"][6],       # paper: 19.8 mW
    }
