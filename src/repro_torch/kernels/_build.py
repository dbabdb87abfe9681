"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source is compiled on first use into its own shared
library with a plain C interface under ``build/repro_torch_kernels/`` at the
repository root.  The
library name carries a hash of the sources, so an edited kernel is rebuilt
and a stale one is never loaded.  :func:`build_all` starts one ``nvcc`` per
source, all together, and waits for them.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``; no
``--use_fast_math`` (it changes expf, tanhf, division and denormals).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("posit_encode", "posit_decode", "posit_core_codec", "logmac",
           "logmac_pieces", "paged_decode")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
# REPRO_TORCH_NVCC_VERBOSE=1 adds -Xptxas -v and prints each kernel's
# registers, shared memory and spills
_VERBOSE = os.environ.get("REPRO_TORCH_NVCC_VERBOSE") == "1"
if _VERBOSE:
    _NVCC_FLAGS = _NVCC_FLAGS + ["-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every missing library in parallel; returns seconds per
    source built by this call.  The build holds an exclusive lock on the
    build directory (``fcntl.flock``, released by the system if the
    process dies), so ranks that start cold together build once: the
    ones that waited find the libraries there."""
    if all(_lib_path(n).exists() for n in names):
        return {}
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_missing(names, out_dir)


def _build_missing(names, out_dir: Path) -> dict[str, float]:
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *_NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    took = {}
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{n}.cu:\n{log.decode(errors='replace')}")
        else:
            if _VERBOSE:
                print(f"[nvcc {n}.cu]\n{log.decode(errors='replace')}",
                      flush=True)
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu``'s library, bound once with
    ``argtypes`` and an int (cudaError_t) result."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else (a plain-version call on a CPU tensor does not count); a
# wrapper call counts one launch however many kernels it starts.
# ``WIDTH_LAUNCHES`` splits the same launches by posit word width.
# ``logmac`` counts every logmac launch, and ``logmac_small``,
# ``logmac_mma``, ``logmac_pieces`` and ``logmac_tile`` the same launches
# by the kernel that ran (``kernels/logmac.py: _plan``).  ``posit_store``,
# ``posit_load``, ``posit_quantize``, ``posit_quantize_prescaled`` and
# ``posit_sentinels`` are the core codec's entries
# (``csrc/posit_core_codec.cu``).
LAUNCHES = {"posit_encode": 0, "posit_encode_prescaled": 0,
            "posit_decode": 0, "posit_store": 0, "posit_load": 0,
            "posit_quantize": 0, "posit_quantize_prescaled": 0,
            "posit_sentinels": 0, "logmac": 0, "logmac_small": 0,
            "logmac_mma": 0, "logmac_pieces": 0, "logmac_tile": 0,
            "paged_flash_decode": 0}
WIDTH_LAUNCHES: dict[str, dict[int, int]] = {k: {} for k in LAUNCHES}


def count_launch(name: str, width: int) -> None:
    LAUNCHES[name] += 1
    by_width = WIDTH_LAUNCHES[name]
    by_width[width] = by_width.get(width, 0) + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        WIDTH_LAUNCHES[k].clear()


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
