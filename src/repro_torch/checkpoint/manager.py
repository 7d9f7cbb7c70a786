"""Fault-tolerant checkpointing: the counterpart of
``repro.checkpoint.manager``, in the reference's layout.

* atomic: writes to ``<dir>/tmp.<step>`` then ``os.replace`` into
  ``<dir>/step_<step:010d>``, so a preemption mid-write never corrupts
  the latest checkpoint,
* self-describing: a flat ``{path: array}`` ``arrays.npz`` (paths
  ``/``-joined, e.g. ``params/layers/attn/wq``, ``opt/step``,
  ``opt/mu/embed``) and a JSON ``manifest.json`` with the step, the
  sorted keys and any ``meta``,
* keep-last-k garbage collection.

The layout is the reference's, so each package restores the other's
checkpoints.  Leaves are saved as host numpy arrays (numpy has no
bfloat16: checkpoint float32 master weights, as the reference does), and
``restore`` puts each one back as a tensor of its template leaf's dtype
on its device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a/b/c": host array}`` of a nested dict of tensors, the
    reference's key paths."""
    if not isinstance(tree, dict):
        return {prefix: tree.detach().cpu().numpy()}
    flat: Dict[str, np.ndarray] = {}
    for key in sorted(tree):
        flat.update(flatten(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return flat


def _unflatten_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {prefix}: {arr.shape} vs {tuple(template.shape)}")
    return torch.as_tensor(arr).to(device=template.device, dtype=template.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any], meta: Optional[dict] = None):
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = flatten(state)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "keys": sorted(flat), **(meta or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"))

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, template: Dict[str, Any], step: Optional[int] = None
                ) -> Tuple[int, Dict[str, Any]]:
        """(step, the state): ``template``'s nested dict of tensors with
        each leaf read from the checkpoint at ``step`` (default: the
        latest), in that leaf's dtype and on its device.  Raises
        ``FileNotFoundError`` when there is none and ``ValueError`` on a
        shape that differs from the template's."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            flat = {k: npz[k] for k in npz.files}
        return step, _unflatten_into(template, flat)
