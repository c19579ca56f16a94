"""Preemption-safe checkpoints of trees of tensors.

Layout: ``<dir>/step_<N>/`` with one ``leaf_<i>.npy`` per leaf, in flatten
order (sorted dict keys, then list, tuple and ``NamedTuple`` fields in
order), plus ``manifest.json`` (``step``, ``n_leaves``, ``sig``: a hash of
the tree's structure).  Writes go to ``.tmp_step_<N>``, which is renamed
into place: a killed writer never corrupts the latest checkpoint.
``keep`` bounds disk use; restore checks the structure and leaf count
against the tree it is asked to fill.

A bfloat16 leaf is written as raw 2-byte void elements under the header
the reference writes for its ml_dtypes bfloat16 arrays (``'descr':
'<V2'``; numpy has no bfloat16), and viewed back as bfloat16 on restore,
bit for bit.  A
checkpoint is restored by the package that wrote it: ``sig`` describes
the port's own trees.

Checkpoints are mesh-agnostic: a tree of DTensors (state over a device
mesh) is saved as its whole tensors, gathered on every rank; rank 0
writes and every rank waits at a barrier, so the files are those a
one-device save of the same state writes.  Restore reads whole tensors;
the caller places them on its own mesh.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from repro_torch.models.common import (tree_leaves, tree_structure,
                                       tree_unflatten)

# dtypes numpy lacks: (stored as, the integer of the same width in torch
# and in numpy)
_RAW = {torch.bfloat16: (np.dtype("V2"), torch.int16, np.int16)}


def _tree_signature(tree) -> str:
    return hashlib.sha1(tree_structure(tree).encode()).hexdigest()[:16]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _RAW:
            raw, as_int, _ = _RAW[t.dtype]
            return t.view(as_int).numpy().view(raw)
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like, where: str):
    """``arr`` as ``like``'s kind: a tensor of its dtype on its device, or
    the array itself for a leaf that is not a tensor."""
    if not isinstance(like, torch.Tensor):
        return arr
    if like.dtype in _RAW:
        raw, _, np_int = _RAW[like.dtype]
        if arr.dtype != raw:
            raise ValueError(f"{where}: stored as {arr.dtype}, expected "
                             f"{like.dtype}")
        t = torch.from_numpy(arr.view(np_int)).view(like.dtype)
    else:
        t = torch.from_numpy(arr)
        if t.dtype != like.dtype:
            raise ValueError(f"{where}: stored as {t.dtype}, expected "
                             f"{like.dtype}")
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{where}: stored shape {tuple(t.shape)}, expected "
                         f"{tuple(like.shape)}")
    return t.to(like.device)


def _save_npy(path: pathlib.Path, leaf) -> None:
    arr = _to_numpy(leaf)
    if arr.dtype.kind != "V":
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<" + arr.dtype.str[1:]
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _whole(leaves):
    """(leaves with each DTensor gathered whole, whether any was one)."""
    from torch.distributed.tensor import DTensor
    sharded = any(isinstance(a, DTensor) for a in leaves)
    return [a.full_tensor() if isinstance(a, DTensor) else a
            for a in leaves], sharded


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    d = pathlib.Path(directory)
    leaves, sharded = _whole(tree_leaves(tree))
    final = d / f"step_{step}"
    if sharded and torch.distributed.get_rank() != 0:
        torch.distributed.barrier()        # rank 0 writes
        return str(final)
    try:
        return _write(d, step, tree, leaves, keep)
    finally:
        if sharded:
            torch.distributed.barrier()


def _write(d: pathlib.Path, step: int, tree, leaves, keep: int) -> str:
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".tmp_step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "n_leaves": len(leaves),
                "sig": _tree_signature(tree)}
    for i, leaf in enumerate(leaves):
        _save_npy(tmp / f"leaf_{i}.npy", leaf)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = d / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish
    # GC old checkpoints
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    for s in steps[:-keep]:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)
    return str(final)


def latest_step(directory: str) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like``: each tensor leaf in
    its dtype on its device (values ignored), any other leaf as the
    stored numpy array."""
    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    src = d / f"step_{step}"
    manifest = json.loads((src / "manifest.json").read_text())
    leaves = tree_leaves(tree_like)
    if manifest["sig"] != _tree_signature(tree_like):
        raise ValueError("checkpoint tree structure mismatch")
    if manifest["n_leaves"] != len(leaves):
        raise ValueError("checkpoint leaf count mismatch")
    out = [_from_numpy(np.load(src / f"leaf_{i}.npy"), like, f"leaf {i}")
           for i, like in enumerate(leaves)]
    return tree_unflatten(tree_like, out), step
