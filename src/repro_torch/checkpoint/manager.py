"""Checkpointing: atomic, async, keep-k, restore onto a device.

The JAX package's ``checkpoint/manager.py`` with tensors in place of
arrays, and the same files: ``<dir>/step_<N>/{manifest.json, arrays.npz}``,
the leaves stored as ``leaf_<i>`` in ``jax.tree_util``'s flattening order
(dicts by sorted key, tuples and ``NamedTuple`` s such as
:class:`~repro_torch.optim.OptState` by position, ``None`` holding no
leaf), so a checkpoint written by either package restores in the other.
A save writes into ``.tmp_step_<N>`` and then renames it (a crashed save
is never taken for a checkpoint).  A bfloat16 leaf is stored as the JAX
package's ``np.savez`` stores one (2-byte void elements of the same bits),
and read back bit for bit.  Saves run
on one background writer behind a bounded queue; ``save_async`` copies the
state to host memory before queueing it, so the caller may go on updating
its tensors in place; ``wait()`` drains the queue.  ``restore`` rebuilds
the structure of ``like`` and puts each leaf on ``like``'s leaf's device
and dtype (or on ``device``)."""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..models.layers import tree_leaves, tree_unflatten

Pytree = Any


def _treedef(tree: Pytree) -> str:
    """A description of the structure in the manifest (not read back)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_treedef(x) for x in tree) + "])")
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_treedef(x) for x in tree) + ")"
    return "*"


def _to_host(x: Any) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().to("cpu", copy=True)    # never a view of the caller's
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _host(state: Pytree) -> Tuple[List[np.ndarray], str]:
    arrays = [_to_host(x) for x in tree_leaves(state)]
    return arrays, f"PyTreeDef({_treedef(state)})"


def _write(path: str, step: int, arrays: List[np.ndarray], treedef: str,
           extra: Optional[Dict[str, Any]]) -> str:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = os.path.join(path, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {"step": step, "n_leaves": len(arrays), "treedef": treedef,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(path: str, step: int, state: Pytree,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint dir."""
    arrays, treedef = _host(state)
    return _write(path, step, arrays, treedef, extra)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, ref: Any, device: DeviceLike) -> Any:
    if not isinstance(ref, torch.Tensor):
        return arr
    if ref.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and \
            arr.dtype.kind == "V":       # as stored, or numpy's bfloat16
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))   # keeps a 0-d leaf 0-d
    return t.to(device=ref.device if device is None else device,
                dtype=ref.dtype)


def restore(path: str, like: Pytree, step: Optional[int] = None,
            device: DeviceLike = None) -> Tuple[int, Pytree, Dict[str, Any]]:
    """Restore into the structure of ``like``: each leaf takes the dtype of
    ``like``'s leaf and its device (or ``device``)."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    refs = tree_leaves(like)
    if len(refs) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint/model mismatch: {manifest['n_leaves']} "
                         f"leaves stored, {len(refs)} expected")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        loaded = [_tensor(data[f"leaf_{i}"], ref, device)
                  for i, ref in enumerate(refs)]
    return step, tree_unflatten(like, loaded), manifest["extra"]


class CheckpointManager:
    """Async writer with bounded queue + keep-last-k garbage collection."""

    def __init__(self, path: str, keep: int = 3, queue_depth: int = 2):
        self.path = path
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    def _writer(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, arrays, treedef, extra = item
            try:
                _write(self.path, step, arrays, treedef, extra)
                self._gc()
            except Exception as e:       # surfaced via .wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.path)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def save_async(self, step: int, state: Pytree,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        # snapshot to host first: the caller updates its tensors in place
        arrays, treedef = _host(state)
        self._q.put((step, arrays, treedef, extra))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10.0)
