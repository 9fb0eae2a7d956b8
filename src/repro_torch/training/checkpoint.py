"""Checkpointing: tree snapshots with atomic manifests, in the on-disk format
of ``repro.training.checkpoint`` (a checkpoint written by either package
restores bit for bit in the other).

Fault-tolerance contract, as the reference's:
  * save() writes leaves to <dir>/step_N.tmp/ then atomically renames to
    <dir>/step_N/ and updates LATEST only after a complete write, so a killed
    writer never leaves a half-checkpoint that restore() would load.
  * async mode runs the serialization on a background thread (training
    continues); join() blocks until durable. The leaves are copied to the
    host before save() returns, so training may update them in place.
  * restore() returns (tree, step) from the newest complete checkpoint.

Leaves are stored as .npy files named by their tree path as JAX names it
(dict keys, ``.field`` for a NamedTuple field, list indices, joined by
``__``), dtype-preserved (bf16 as a uint16 view), with ``manifest.json``
holding each leaf's dtype and shape.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16_TAG = "bfloat16"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_path(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in JAX's order: dict keys sorted, NamedTuple fields
    and list items in order. A path entry is a dict key, ``"." + field``
    (JAX's ``GetAttrKey`` as a string) or a list index."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten_with_path(tree[k], (*path, k))]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields
                for pl in _flatten_with_path(getattr(tree, f), (*path, "." + f))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree) for pl in _flatten_with_path(x, (*path, i))]
    return [(path, tree)]


def _unflatten_like(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def _path_key(path) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _save_leaf(d: str, key: str, t: torch.Tensor) -> Dict[str, Any]:
    meta = {"dtype": _dtype_name(t), "shape": list(t.shape)}
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).numpy().view(np.uint16)
        meta["stored"] = "uint16"
    else:
        a = t.numpy()
    np.save(os.path.join(d, key + ".npy"), a, allow_pickle=False)
    return meta


def _load_leaf(d: str, key: str, meta: Dict[str, Any], device) -> torch.Tensor:
    a = np.load(os.path.join(d, key + ".npy"), allow_pickle=False)
    if meta.get("stored") == "uint16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, async_: bool = False) -> None:
        # a host copy of every leaf first, so the caller may go on updating them
        host = [(p, v.detach().to("cpu", copy=True)) for p, v in _flatten_with_path(tree)]

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}}
            for path, val in host:
                key = _path_key(path)
                manifest["leaves"][key] = _save_leaf(tmp, key, val)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "LATEST.tmp"), os.path.join(self.dir, "LATEST"))
            self._gc()

        if async_:
            self.join()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        self.join()
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.dir, f"step_{s}", "manifest.json")):
                return s
        # fall back to scanning complete checkpoints
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure of ``like`` (a tree of tensors); each
        leaf lands on the device of ``like``'s leaf, in the stored dtype."""
        self.join()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for path, ref in _flatten_with_path(like):
            key = _path_key(path)
            leaves.append(_load_leaf(d, key, manifest["leaves"][key], ref.device))
        return _unflatten_like(like, leaves), step

    # -------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        for s in sorted(steps)[: -self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
