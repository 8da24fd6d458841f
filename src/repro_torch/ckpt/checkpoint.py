"""Checkpoint and restore, the port of ``repro.ckpt.checkpoint``, in its
on-disk format: a directory that either package writes, the other loads.

Layout (one directory per step):
    step_000123/
      manifest.json   — leaf names, shapes, dtypes, content hashes, step,
                        data cursor
      <prefix>__<a__b>.npy — one array per tree leaf

Leaves are named by their tree paths in ``jax.tree_util`` order
(``params/tables/t0/table``, ``opt/mu/...``, ``opt/step``), files hashed
(sha256 of their bytes, first 16 hex digits) and checked on load.  A save
is published by an atomic rename, so a crashed save never corrupts the
latest checkpoint, and (step, data cursor) travel with it so a restarted
job continues from the exact batch.  :class:`CheckpointManager` copies
the trees to the host and writes them on a worker thread, keeping the
newest ``keep``.

Leaves are written as numpy arrays.  numpy has no bfloat16 without the
``ml_dtypes`` package, which the port does not use, so a bf16 leaf raises
``TypeError``: training keeps f32 masters, and its checkpoints hold f32
and int32 leaves only.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import flatten_with_path, path_name, tree_map, unflatten


def _host(leaf: Any) -> np.ndarray:
    """A host copy of a tensor leaf (arrays pass as they are)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                "a bfloat16 leaf has no numpy dtype without ml_dtypes; "
                "checkpoints hold f32 masters")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {path_name(p): _host(leaf) for p, leaf in flatten_with_path(tree)}


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _steps(directory: str):
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_")]


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    data_cursor: int = 0,
    extra: Optional[Dict] = None,
) -> str:
    """Atomic checkpoint write; returns the published path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory)
    manifest = {
        "step": int(step),
        "data_cursor": int(data_cursor),
        "extra": extra or {},
        "leaves": {},
    }
    for prefix, tree in (("params", params), ("opt", opt_state)):
        if tree is None:
            continue
        for name, arr in _flatten(tree).items():
            fname = f"{prefix}__{name.replace('/', '__')}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][f"{prefix}/{name}"] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha": _sha(os.path.join(tmp, fname)),
            }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def load_checkpoint(
    directory: str,
    params_template: Any,
    opt_template: Any = None,
    step: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[Any, Any, int, int]:
    """Restore ``(params, opt_state, step, data_cursor)`` as tensors on
    ``device`` (None: the card), in the templates' structures; the latest
    step unless ``step`` is given.  A hash or shape that does not match
    the manifest raises ``AssertionError``, as in the reference."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(directory)
    assert step is not None, f"no checkpoint found in {directory}"
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def restore(prefix, template):
        if template is None:
            return None
        out = []
        for pth, _ in flatten_with_path(template):
            name = path_name(pth)
            meta = manifest["leaves"][f"{prefix}/{name}"]
            fpath = os.path.join(path, meta["file"])
            assert _sha(fpath) == meta["sha"], f"hash mismatch for {name}"
            arr = np.load(fpath)
            assert list(arr.shape) == meta["shape"]
            out.append(torch.from_numpy(arr).to(dev))
        return unflatten(template, out)

    params = restore("params", params_template)
    opt = restore("opt", opt_template)
    return params, opt, manifest["step"], manifest["data_cursor"]


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async (threaded)
    saves.  A save copies the trees to the host before it returns, so the
    caller may update its tensors in place while the thread writes."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join the running save, and raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, params: Any, opt_state: Any = None,
             data_cursor: int = 0) -> None:
        host_params = tree_map(_host, params)
        host_opt = tree_map(_host, opt_state) if opt_state is not None else None

        def work():
            try:
                save_checkpoint(
                    self.directory, step, host_params, host_opt, data_cursor
                )
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def _gc(self):
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )
