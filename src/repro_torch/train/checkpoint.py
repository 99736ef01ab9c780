"""Checkpointing: atomic, async-capable, keep-N; the twin of
``repro/train/checkpoint.py`` on torch tensors.

Format, the reference's: one ``state.npz`` (leaf path -> array) and a
``manifest.json`` under ``step_%08d``. A leaf's path is its keys joined by
``/``: a mapping's key (a parameter name's ``.``-joined parts count as
keys, so ``{"params": {"body.l0.ffn.wg": t}}`` and the reference's nested
``{"params": {"body": {"l0": {"ffn": {"wg": a}}}}}`` both give
``params/body/l0/ffn/wg``), a list's index, and a named tuple's field as
``.field`` (``opt/.step``, ``opt/.m/body/l0/ffn/wg``), as
``jax.tree_util``'s paths print. numpy has no bfloat16, so a bf16 leaf is
stored as its raw uint16 view with the dtype in the key (``...::bfloat16``),
as the reference stores it. Each package restores the other's checkpoints.

Saving copies every leaf to the host first, synchronously (a training step
may write the parameters in place the moment ``save`` returns); the file is
then written by a background thread and published by a rename. Restore
puts each leaf on its ``like`` leaf's device (or ``device``).

Sharded state (DTensor leaves, a model on a mesh): every rank calls
``save``, each DTensor is gathered whole (an all-gather per leaf, in the
same order on every rank), and rank 0 alone writes, in the same format, so
the file does not depend on the mesh. ``restore`` reads the whole leaf on
every rank and keeps the slice that ``like``'s leaf has, on its mesh and
placements: a state saved on one mesh restores on another (or on one
device).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..device import DeviceLike
from ..models.parallel import distribute_like, gather_full



def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[Tuple[str, ...], Any]]]:
    """``[(path parts, child), ...]`` of a node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(tuple(str(k).split(".")), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(("." + f,), getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [((str(i),), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, path: Tuple[str, ...] = ()):
    kids = _children(tree)
    if kids is None:
        yield "/".join(path), tree
        return
    for parts, child in kids:
        yield from _leaves(child, path + parts)


def _writes(tree) -> bool:
    """Whether this process writes ``tree``: always, unless the state is
    sharded and this is not rank 0."""
    sharded = any(isinstance(leaf, DTensor) for _, leaf in _leaves(tree))
    return not sharded or dist.get_rank() == 0


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array (a copy) and its key's dtype suffix."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "::bfloat16"
        return t.numpy(), ""
    return np.array(leaf), ""


def _flatten(tree, keep: bool = True) -> Dict[str, np.ndarray]:
    """``{key: array}`` of ``tree``'s leaves, each DTensor gathered whole (a
    collective); with ``keep`` False nothing is copied to the host."""
    flat = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = gather_full(leaf)
        if keep:
            arr, suffix = _to_host(leaf)
            flat[key + suffix] = arr
    return flat


def _decode(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(arr)
    if dtype_name != "bfloat16":
        raise ValueError(f"a checkpoint leaf of dtype {dtype_name}: only bfloat16 is tagged")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def _unflatten(like, flat: Dict[str, Tuple[np.ndarray, Optional[str]]], device: DeviceLike,
               path: Tuple[str, ...] = ()):
    kids = _children(like)
    if kids is None:
        key = "/".join(path)
        arr, dtype_name = flat[key]
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} != "
                             f"{tuple(np.shape(like))}")
        if not torch.is_tensor(like):
            return arr
        dev = like.device if device is None else torch.device(device)
        t = _decode(arr, dtype_name).to(dev)
        return distribute_like(t, like) if isinstance(like, DTensor) else t
    out = [_unflatten(child, flat, device, path + parts) for parts, child in kids]
    if isinstance(like, dict):
        return dict(zip(like, out))
    if _is_namedtuple(like):
        return type(like)(*out)
    return type(like)(out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Write ``state`` as ``step``. Sharded state: every rank calls it
        and rank 0 writes (``blocking`` then returns when the file is
        published and every rank has passed a barrier)."""
        writes = _writes(state)
        flat = _flatten(state, writes)  # device->host copy happens here, synchronously
        if not writes:
            if blocking:
                dist.barrier()
            return

        def _write():
            tmp = tempfile.mkdtemp(dir=self.dir)
            try:
                npz_path = os.path.join(tmp, "state.npz")
                np.savez(npz_path, **flat)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump({"step": step, "time": time.time(),
                               "n_leaves": len(flat)}, f)
                final = os.path.join(self.dir, f"step_{step:08d}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic publish
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
            self._gc()

        self.wait()
        if self.async_save and not blocking:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            if any(isinstance(leaf, DTensor) for _, leaf in _leaves(state)):
                dist.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "manifest.json")
            ):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device: DeviceLike = None) -> Any:
        """The state saved at ``step``, in ``like``'s structure (dicts,
        named tuples, lists; tensors of the saved dtype on each ``like``
        tensor's device, or ``device``; a DTensor ``like`` leaf gives a
        DTensor on its mesh and placements)."""
        path = os.path.join(self.dir, f"step_{step:08d}", "state.npz")
        flat = {}
        with np.load(path) as z:
            for k in z.files:
                key, _, dtype_name = k.partition("::")
                flat[key] = (z[k], dtype_name or None)
        return _unflatten(like, flat, device)

    def restore_latest(self, like: Any, device: DeviceLike = None) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device)
