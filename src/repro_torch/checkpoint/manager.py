"""Checkpointing: atomic, async-capable save and restore of a train state.

The JAX package's ``checkpoint/manager.py`` in PyTorch, with its on-disk
layout: ``step_NNNNNNNN/arrays.npz`` (flat ``a/b/0/c`` paths -> arrays) and
``manifest.json`` (step, time, extra, path -> shape / dtype).

  * Saves are atomic (write to a unique ``step_N.tmp*`` then rename): a
    crash mid-save never corrupts the latest checkpoint, and leftover tmp
    directories are invisible.
  * ``save_async`` copies every tensor to host memory synchronously (the
    train loop stalls for the device-to-host copy only) and writes on a
    background thread.
  * Keeps the most recent ``keep`` checkpoints (plus any step in
    ``keep_steps``), pruned oldest-first.
  * ``restore(template)`` puts each leaf on the template leaf's device and
    dtype (and ``requires_grad``).

bfloat16 has no numpy dtype here: such leaves are stored as their uint16
bit patterns and the manifest records ``bfloat16``.  Resharding on restore
waits for the multi-GPU tooling.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import named_leaves, tree_map

__all__ = ["CheckpointManager"]


def _to_host(t: torch.Tensor):
    """(numpy array, dtype name): an owned host copy of ``t``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, keep_steps=()):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.keep_steps = set(keep_steps)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1].split(".")[0])
            for p in self.dir.glob("step_*")
            if ".tmp" not in p.name
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state, *, extra: Optional[dict] = None):
        """Blocking atomic save."""
        self.wait()  # don't race an in-flight async save of the same step
        self._write(step, self._snapshot(state), extra or {})

    def save_async(self, step: int, state, *, extra: Optional[dict] = None):
        """Snapshot synchronously, write in the background."""
        self.wait()  # one in-flight save at a time
        host = self._snapshot(state)  # device->host happens here
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True
        )
        self._thread.start()

    @staticmethod
    def _snapshot(state) -> dict:
        return {k: _to_host(v) for k, v in named_leaves(state)}

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    _uniq = itertools.count()

    def _write(self, step: int, host: dict, extra: dict):
        # Unique staging dir: concurrent writers of the same step (sync +
        # async) must never share a tmp path; the final rename is atomic.
        tmp = self.dir / f"step_{step:08d}.tmp{os.getpid()}_{next(self._uniq)}"
        final = self._step_dir(step)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in host.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra,
            "arrays": {k: {"shape": list(a.shape), "dtype": dt} for k, (a, dt) in host.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            if s not in self.keep_steps:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, template, step: Optional[int] = None):
        """Restore into the structure of ``template`` (a tree of tensors).

        Returns ``(state, step)``: each leaf on its template leaf's device,
        in its dtype, with its ``requires_grad``.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        dtypes = {k: v["dtype"] for k, v in self.manifest(step)["arrays"].items()}
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}

        def put(t, key):
            arr = flat[key]
            if dtypes[key] == "bfloat16":
                x = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                x = torch.from_numpy(np.array(arr, copy=True))
            return x.to(device=t.device, dtype=t.dtype).requires_grad_(t.requires_grad)

        keys = (key for key, _ in named_leaves(template))
        return tree_map(lambda t: put(t, next(keys)), template), step

    def manifest(self, step: int) -> dict:
        return json.loads((self._step_dir(step) / "manifest.json").read_text())

