"""Fault-tolerant checkpointing: atomic and async (the counterpart of
``repro.checkpoint.manager``).

- Atomic: written to ``<dir>/tmp.<step>``, then renamed to
  ``step_<step>``: a crash mid-save never corrupts the latest checkpoint.
- Async: the copy to host memory is synchronous (a copy even of a CPU
  tensor), the file write runs on one background thread (one save in
  flight at a time).
- ``keep_last`` removes all but the newest checkpoints.

Format: the JAX package's, one ``arrays.npz`` of flattened key paths
("params/blocks/0/attn/wq", "opt/m/3", "opt/m/3/q") plus ``meta.json``,
so each package restores the other's fp32 trees. numpy has no bfloat16:
a bf16 tensor is stored as float32 (exact: every bf16 value is a float32)
and cast back to the template's dtype on restore. ``restore`` loads into a
template's structure, each tensor on its template leaf's device and in its
dtype; given a tree of logical ``Axes`` and a ``DeviceMesh`` (elastic
restore, onto any mesh), each leaf comes back a DTensor with the
placements its axes resolve to (distributed/api.py).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.api import distribute, named_sharding, tree_map2


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat: dict, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint has no array {key!r}")
    a = flat[key]
    if a.shape != tuple(template.shape):
        raise ValueError(f"{key}: shape {a.shape} in the checkpoint, "
                         f"{tuple(template.shape)} in the template")
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=template.device, dtype=template.dtype)


def _host(t) -> np.ndarray:
    """A host copy of ``t`` that owns its memory. ``t.cpu().numpy()`` of a
    CPU tensor would share it, and the loop updates parameters and moments
    in place while the write thread runs: the file would mix two steps."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save ----

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot to host memory now; write to disk (a)synchronously."""
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        self.wait()  # one in-flight save at a time
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, flat: dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "keys": sorted(flat)}, f)
        if os.path.exists(final):
            shutil.rmtree(tmp, ignore_errors=True)
            return
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore ----

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d{10})", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, axes: Any = None,
                mesh=None) -> Any:
        """Load checkpoint ``step`` into the structure of ``template``: each
        leaf on the template leaf's device, in its dtype, its shape
        checked. With ``axes`` (a matching tree of ``Axes`` leaves) and
        ``mesh``, each leaf comes back a DTensor on ``mesh`` sharded as its
        axes resolve (elastic restore: every rank reads the file and keeps
        its own slice)."""
        path = os.path.join(self.dir, f"step_{step:010d}", "arrays.npz")
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        host = _unflatten_into(template, flat)
        if mesh is None or axes is None:
            return host
        return tree_map2(
            lambda t, ax: distribute(t, named_sharding(t.shape, ax.names,
                                                       mesh)), host, axes)
