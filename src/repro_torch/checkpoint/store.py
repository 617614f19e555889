"""Sharded, atomic, async checkpointing (no external deps: npz + JSON).

Counterpart of ``repro.checkpoint.store``, with the same fault-tolerance
contract:

  * **atomic** — writes go to ``step_XXXXXXXX.tmp<host>/`` and are renamed
    into place (``os.replace``) only after the shard file and the manifest
    are fsync'd; a crash mid-write can never produce a checkpoint that
    ``latest_step`` would pick.
  * **sharded** — each host saves only the leaves it owns (leaf ``i`` on
    host ``i % n_hosts``); the manifest records the full logical shapes.
  * **async** — ``save_async`` copies the tensors to host memory on the
    caller's thread and does serialization and I/O on a background thread,
    keeping checkpointing off the training critical path.

The manifest is JSON (``manifest.json``) where the reference writes
msgpack, and bfloat16 leaves are stored as their ``uint16`` bit patterns
with the real dtype named in the manifest, so the store needs neither
``msgpack`` nor ``ml_dtypes``.  The port therefore does not read the
reference's checkpoints, nor the reference the port's.  Leaves are
ordered and named by ``core.tree.leaves_with_paths`` (JAX's order: dict
keys sorted; paths in the style of ``jax.tree_util.keystr``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import tree as T

__all__ = ["save", "save_async", "restore", "latest_step", "all_steps",
           "wait_for_async"]

_MANIFEST = "manifest.json"
_PENDING: List[threading.Thread] = []
# one write at a time: two saves of one step (a cadence save at the loop's
# last step, then its final save) share the step's .tmp directory
_WRITE_LOCK = threading.Lock()


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def save(root: str, step: int, tree, *, host_index: int = 0,
         n_hosts: int = 1) -> str:
    """Synchronous atomic save of a tree of tensors and numpy arrays.
    Returns the final directory."""
    with _WRITE_LOCK:
        return _save(root, step, tree, host_index, n_hosts)


def _save(root: str, step: int, tree, host_index: int, n_hosts: int) -> str:
    leaves = T.leaves_with_paths(tree)
    final = _step_dir(root, step)
    tmp = final + f".tmp{host_index}"
    os.makedirs(tmp, exist_ok=True)

    manifest: Dict[str, Any] = {"step": step, "n_hosts": n_hosts,
                                "leaves": []}
    arrays: Dict[str, np.ndarray] = {}
    for i, (name, leaf) in enumerate(leaves):
        key = f"leaf_{i:05d}"
        owner = i % n_hosts  # host-striping
        manifest["leaves"].append({
            "name": name, "key": key, "shape": list(leaf.shape),
            "dtype": _dtype_name(leaf), "owner": owner,
        })
        if owner == host_index:
            arrays[key] = _host_array(leaf)

    shard = os.path.join(tmp, f"shard_{host_index:04d}.npz")
    np.savez(shard, **arrays)
    with open(shard, "rb+") as f:
        os.fsync(f.fileno())
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    # single-host path: rename into place
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_async(root: str, step: int, tree, **kw) -> threading.Thread:
    """Copy to host memory now (a copy, never a view of a tensor that the
    next step updates in place); write on a background thread."""
    def snapshot(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True)
        return np.array(leaf, copy=True)

    host_tree = T.map_leaves(snapshot, tree)
    t = threading.Thread(target=save, args=(root, step, host_tree), kwargs=kw,
                         daemon=False)
    t.start()
    _PENDING.append(t)
    return t


def wait_for_async() -> None:
    while _PENDING:
        _PENDING.pop().join()


def _leaf_back(arr: np.ndarray, dtype: str, like):
    """A stored array as the leaf ``like`` stands for: a tensor of the
    manifest's dtype on ``like``'s device, or a numpy array."""
    if not isinstance(like, torch.Tensor):
        return arr
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(like.device)
    return torch.from_numpy(arr).to(like.device)


def restore(root: str, step: int, like) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors or numpy
    arrays): tensor leaves come back as tensors on the device of ``like``'s
    leaf, numpy leaves as numpy arrays."""
    final = _step_dir(root, step)
    with open(os.path.join(final, _MANIFEST), "rb") as f:
        manifest = json.loads(f.read())

    shards = {}
    for fname in sorted(os.listdir(final)):
        if fname.startswith("shard_") and fname.endswith(".npz"):
            with np.load(os.path.join(final, fname)) as z:
                shards.update({k: z[k] for k in z.files})

    leaves_like = T.leaves(like)
    metas = manifest["leaves"]
    if len(metas) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(metas)} leaves, target structure has "
            f"{len(leaves_like)} — structure change requires migration")
    out = []
    for meta, ref_leaf in zip(metas, leaves_like):
        arr = shards[meta["key"]]
        if list(arr.shape) != list(ref_leaf.shape):
            raise ValueError(f"leaf {meta['name']}: shape {arr.shape} != "
                             f"{tuple(ref_leaf.shape)}")
        out.append(_leaf_back(arr, meta["dtype"], ref_leaf))
    return T.unflatten(like, out)


def all_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and "." not in d:
            try:
                steps.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = all_steps(root)
    return steps[-1] if steps else None
