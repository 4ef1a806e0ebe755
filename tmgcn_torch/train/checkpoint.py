"""Checkpoint / resume for training state (port of
tmgcn_tpu.train.checkpoint).

The reference never persists model state (SURVEY.md §5: a crashed run is
lost). A run's directory holds one ``torch.save`` file per saved epoch,
``ckpt_<epoch>.pt``, each a dict of (params, opt_state, results, buffers)
in which every leaf is a tensor (the results rows as float64), so it
loads under ``torch.load(weights_only=True)``. The newest is the one of
the highest epoch, and the ``max_to_keep`` newest are kept. A save is
written under a temporary name and moved into place with ``os.replace``:
a crash mid-save leaves the previous checkpoint readable, and the
temporary file is never taken for a checkpoint.

Under a device mesh (``group``, the run's process group) the parameters,
optimizer state and rows are the same on every rank: the group's rank 0
alone writes, every rank waits at a barrier after each save, and every rank
restores the same newest file.

The format is the port's own: it neither reads nor writes the JAX
package's Orbax directories, and ``opt_state`` is the port's optimizer
state (``train.loop._Optimizer.state_dict``), not an optax tree.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

_NAME = re.compile(r"ckpt_(\d+)\.pt")


def _to_cpu(tree):
    """Detached CPU tensors of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu()


def _structure(tree):
    """The nesting of a dict of tensors: its keys, level by level."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _cast(template, tree):
    """``tree``'s values on ``template``'s dtypes and devices."""
    if isinstance(template, dict):
        return {k: _cast(v, tree[k]) for k, v in template.items()}
    return tree.to(device=template.device, dtype=template.dtype)


class RunCheckpointer:
    """Save and restore one run's training state under a directory.

    ``group``: the process group of a sharded run (``torch.distributed``),
    or None for a run of one process."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3, group=None):
        self._dir = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self.group = group
        self.writes = group is None or dist.get_rank(group) == 0
        if self.writes:
            self._dir.mkdir(parents=True, exist_ok=True)

    def _epochs(self) -> list[int]:
        if not self._dir.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def _path(self, epoch: int) -> Path:
        return self._dir / f"ckpt_{epoch}.pt"

    def save(self, epoch: int, params: dict, opt_state: dict, results: np.ndarray,
             buffers: dict | None = None) -> None:
        """Write epoch ``epoch``'s state, then drop all but the
        ``max_to_keep`` newest. ``buffers``: the frozen model buffers (e.g.
        WD-GCN's untrained U), so inference restores a whole model without
        replaying the run's draws. Under a mesh rank 0 writes and every
        rank returns after it has."""
        if self.writes:
            self._write(epoch, params, opt_state, results, buffers)
        if self.group is not None:
            dist.barrier(group=self.group)

    def _write(self, epoch: int, params: dict, opt_state: dict, results: np.ndarray,
               buffers: dict | None) -> None:
        state = {
            "epoch": epoch,
            "params": _to_cpu(params),
            "opt_state": _to_cpu(opt_state),
            "results": torch.from_numpy(np.array(results, dtype=np.float64)),
            "buffers": _to_cpu(buffers if buffers is not None else {}),
        }
        tmp = self._dir / f".ckpt_{epoch}.pt.tmp"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(epoch))
        for old in self._epochs()[: -self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def latest_epoch(self) -> int | None:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore(self, map_location: str | torch.device = "cpu") -> tuple[int, dict] | None:
        """(epoch, state) of the newest checkpoint, or None if there is
        none. state: {"params", "opt_state", "results" (float64 tensor),
        "buffers"}, tensors on ``map_location``."""
        step = self.latest_epoch()
        if step is None:
            return None
        state = torch.load(self._path(step), weights_only=True, map_location=map_location)
        return step, state

    def restore_inference(self, params_template: dict,
                          buffers_template: dict) -> tuple[int, dict, dict] | None:
        """(epoch, params, buffers) of the newest checkpoint for inference,
        cast onto the templates' dtypes and devices; no optimizer state.
        A checkpoint whose buffers' nesting differs from the template's
        (one saved without buffers) gives back ``buffers_template``."""
        restored = self.restore()
        if restored is None:
            return None
        step, state = restored
        params = _cast(params_template, state["params"])
        saved = state.get("buffers") or {}
        buffers = (_cast(buffers_template, saved)
                   if _structure(saved) == _structure(buffers_template) else buffers_template)
        return step, params, buffers

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX package's
        interface."""
