"""Crash-safe checkpoints of a tree of tensors and arrays.

Counterpart of ``repro.distributed.checkpoint`` with its on-disk layout,
so either package restores the other's checkpoints:

    ckpt_dir/
      step_00000100/
        MANIFEST.json      tree structure, paths, shapes, dtypes, crc32s,
                           step, time, extra
        arrays/<idx>.npy   one file per leaf
      LATEST               text file naming the last *complete* step dir

Write protocol (crash-safe): write into ``step_X.tmp``, fsync files, write
MANIFEST last, then atomic-rename to ``step_X`` and update LATEST.  A
partial directory is ignored by restore: ``LATEST`` only advances after the
rename, so a crash mid-write falls back to the previous checkpoint.

Trees are dicts, lists and tuples of leaves (tensors, arrays, scalars);
``None`` is an empty subtree.  Leaves are ordered and named as JAX flattens
a pytree: dict keys sorted, sequence items in order, paths in
``jax.tree_util.keystr`` form (``['cache']['k']``, ``[0]``).

Dtypes, as the reference writes them:

* a torch bfloat16 leaf is written as its 16-bit patterns under a ``<V2``
  header with ``bfloat16`` in the manifest (what ``np.save`` makes of an
  ``ml_dtypes`` bfloat16 array);
* a torch int16 or int32 leaf holds posit words, the port's storage of
  uint16/uint32 words (``core.posit.STORAGE_DTYPES``), and is written as
  uint16/uint32;
* CUDA tensors go through ``.cpu()``.

``restore`` builds each torch leaf with the target leaf's dtype (the bits
reinterpreted where only the signedness differs) on the target's device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
import zlib

import numpy as np
import torch

# posit-word storage dtypes of the port -> the unsigned dtype on disk
_WORDS_ON_DISK = {torch.int16: np.uint16, torch.int32: np.uint32}
_NP_OF_TORCH = {torch.int16: np.int16, torch.int32: np.int32,
                torch.uint8: np.uint8, torch.int8: np.int8,
                torch.int64: np.int64}


def _flatten(tree, path: str = ""):
    """[(keystr path, leaf)] in JAX's flatten order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def path_keys(path: str) -> list:
    """The dict keys, attribute names and sequence indices of a keystr
    path: ``"['layers'][0]"`` -> ``['layers', 0]``; a dataclass field, as
    in the reference's ``TrainState`` (``".params['embed']"``), gives its
    name."""
    return [a or k if i == "" else int(i)
            for a, k, i in re.findall(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]",
                                      path)]


def nest(flat: dict) -> dict:
    """``{keystr path: leaf}`` (what :func:`restore_numpy` returns) as
    nested dicts, sequence indices as int keys."""
    tree: dict = {}
    for path, leaf in flat.items():
        keys = path_keys(path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _treedef(tree) -> str:
    """The body of JAX's ``str(treedef)``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "None" if tree is None else "*"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``
    (an iterator)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return None if like is None else next(leaves)


def _to_disk(leaf) -> tuple[np.ndarray, str, str | None]:
    """(array to write, manifest dtype, header descr override)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits, "bfloat16", "<V2"
        if t.dtype in _WORDS_ON_DISK:
            arr = t.numpy().view(_WORDS_ON_DISK[t.dtype])
        else:
            arr = t.numpy()
        return arr, str(arr.dtype), None
    arr = np.asarray(leaf)
    return arr, str(arr.dtype), None


def _write_npy(f, arr: np.ndarray, descr: str | None):
    if descr is None:
        np.save(f, arr)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": descr, "fortran_order": False, "shape": arr.shape})
    f.write(np.ascontiguousarray(arr).tobytes())


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra: dict | None = None) -> str:
    """Write a checkpoint; returns the final directory path."""
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    arrays = os.path.join(tmp, "arrays")
    os.makedirs(arrays, exist_ok=True)

    manifest = {
        "step": step,
        "time": time.time(),
        "treedef": f"PyTreeDef({_treedef(tree)})",
        "paths": [p for p, _ in flat],
        "leaves": [],
        "extra": extra or {},
    }
    for i, (path, leaf) in enumerate(flat):
        arr, dtype, descr = _to_disk(leaf)
        fn = os.path.join(arrays, f"{i}.npy")
        with open(fn, "wb") as f:
            _write_npy(f, arr, descr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({
            "idx": i, "path": path, "shape": list(arr.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        })
    mf = os.path.join(tmp, "MANIFEST.json")
    with open(mf, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    """Step of the last complete checkpoint, or None."""
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    mdir = os.path.join(ckpt_dir, name)
    if not os.path.exists(os.path.join(mdir, "MANIFEST.json")):
        return None  # torn write — treat as absent
    return int(name.split("_")[1])


def _manifest(ckpt_dir: str, step: int | None):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return json.load(f), d, step


def leaf_paths(ckpt_dir: str, step: int | None = None) -> list[str]:
    """A checkpoint's leaf paths, in order, without touching the arrays."""
    manifest, _, _ = _manifest(ckpt_dir, step)
    return manifest["paths"]


def read_extra(ckpt_dir: str, step: int | None = None):
    """A checkpoint's ``extra`` metadata without touching the arrays, so
    callers can check structural compatibility before ``restore``.
    Returns (extra, step)."""
    manifest, _, step = _manifest(ckpt_dir, step)
    return manifest["extra"], step


def _load_leaf(d: str, rec: dict, verify: bool) -> np.ndarray:
    """The leaf's array as on disk; a void (extension dtype) leaf as the
    unsigned integers of its width."""
    arr = np.load(os.path.join(d, "arrays", f"{rec['idx']}.npy"))
    if arr.dtype.kind == "V":
        arr = arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
    if verify:
        crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
        if crc != rec["crc32"]:
            raise IOError(f"crc mismatch on leaf {rec['path']}")
    return arr


def _bf16_as_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 patterns widened exactly to float32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _to_torch(arr: np.ndarray, dtype_name: str, like: torch.Tensor):
    """``arr`` as a tensor of ``like``'s dtype on ``like``'s device."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif (like.dtype in _NP_OF_TORCH and arr.dtype.kind in "iu"
          and arr.dtype.itemsize == like.element_size()):
        t = torch.from_numpy(arr.view(_NP_OF_TORCH[like.dtype]).copy())
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def restore(ckpt_dir: str, target_tree, *, shardings=None,
            step: int | None = None, verify: bool = True):
    """Restore into the structure of ``target_tree`` (global shapes).
    Torch leaves come back with the target leaf's dtype on its device;
    other leaves as the arrays on disk.

    ``shardings``: a tree of ``target_tree``'s structure of (mesh, spec)
    pairs (``distributed.sharding``); each leaf then comes back as this
    rank's block under its spec (``sharding.local_shard`` at the mesh's
    ``coord``), whatever mesh wrote the checkpoint: the elastic restore
    onto another mesh shape.  Returns (tree, step, extra)."""
    from . import sharding as SH
    manifest, d, step = _manifest(ckpt_dir, step)
    flat = _flatten(target_tree)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target has "
            f"{len(flat)} — structure mismatch")
    placed = (SH.shardings_in_order(target_tree, shardings)
              if shardings is not None else [None] * len(flat))
    out = []
    for rec, (_, tgt), sh in zip(manifest["leaves"], flat, placed):
        arr = _load_leaf(d, rec, verify)
        shape = (tuple(tgt.shape) if isinstance(tgt, torch.Tensor)
                 else np.shape(tgt))
        if arr.shape != shape:
            raise ValueError(
                f"shape mismatch on {rec['path']}: ckpt {arr.shape} vs "
                f"target {shape}")
        if sh is not None:
            arr = np.ascontiguousarray(SH.local_shard(arr, sh[1], sh[0]))
        out.append(_to_torch(arr, rec["dtype"], tgt)
                   if isinstance(tgt, torch.Tensor) else arr)
    return _unflatten(target_tree, iter(out)), step, manifest["extra"]


def restore_numpy(ckpt_dir: str, step: int | None = None,
                  verify: bool = True) -> dict[str, np.ndarray]:
    """Every leaf of a checkpoint, by its keystr path, with no target tree:
    how the port reads a checkpoint the JAX package wrote.  bfloat16 leaves
    come back widened exactly to float32 (this reader needs no
    ``ml_dtypes``)."""
    manifest, d, _ = _manifest(ckpt_dir, step)
    out = {}
    for rec in manifest["leaves"]:
        arr = _load_leaf(d, rec, verify)
        out[rec["path"]] = (_bf16_as_f32(arr) if rec["dtype"] == "bfloat16"
                            else arr)
    return out
