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

Leaves are written as ``.npy`` files.  numpy has no bfloat16 without the
``ml_dtypes`` package, which the port does not use, so a bf16 leaf is
written as its uint16 bits under the header that ``ml_dtypes`` gives the
reference's file (``'descr': '<V2'``, manifest dtype ``bfloat16``): the
same bytes and hash.  A ``V2`` leaf whose manifest says ``bfloat16`` loads
back as ``torch.bfloat16``, bit for bit.

On a mesh (leaves that are DTensors, :mod:`repro_torch.distributed.sharding`)
every rank gathers each leaf and rank 0 writes it, so the files equal an
unsharded save's; a load given ``shardings`` places each leaf it reads on
the current mesh, whatever mesh wrote it (elastic restore).
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
from repro_torch.distributed.sharding import full_tensor, is_sharded, place
from repro_torch.tree import flatten_with_path, path_name, tree_map, unflatten

BF16 = "bfloat16"
BF16_DESCR = "<V2"   # what ml_dtypes' bfloat16 writes into a .npy header


class BF16Bits:
    """A bf16 leaf on the host: its uint16 bit patterns."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits
        self.shape = bits.shape
        self.dtype = BF16


def _host(leaf: Any):
    """A host copy of a leaf: a numpy array, or :class:`BF16Bits` for a
    bf16 tensor (arrays and bits pass as they are).  A DTensor is
    gathered first, on every rank."""
    leaf = full_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return BF16Bits(t.view(torch.int16).numpy().view(np.uint16))
        return t.numpy()
    if isinstance(leaf, BF16Bits):
        return leaf
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, Any]:
    return {path_name(p): _host(leaf) for p, leaf in flatten_with_path(tree)}


def _write(path: str, arr) -> None:
    """``np.save``'s bytes; a bf16 leaf under the reference's header."""
    if not isinstance(arr, BF16Bits):
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": BF16_DESCR, "fortran_order": False,
            "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr.bits, dtype="<u2").tobytes())


def _read(path: str, dtype: str) -> torch.Tensor:
    """A leaf's file as a CPU tensor: a ``V2`` leaf whose manifest dtype
    is bfloat16 as ``torch.bfloat16``, bit for bit."""
    arr = np.load(path)
    if dtype == BF16 and arr.dtype == np.dtype("V2"):
        bits = np.ascontiguousarray(arr).view("<u2").astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
    """Atomic checkpoint write; returns the published path.  Trees of
    DTensors are gathered on every rank of their mesh, and only rank 0
    writes (the others return the path it publishes)."""
    if _mesh_rank(params, opt_state) > 0:
        _flatten(params)
        if opt_state is not None:
            _flatten(opt_state)
        return os.path.join(directory, f"step_{step:08d}")
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
            _write(os.path.join(tmp, fname), arr)
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


def _mesh_rank(*trees) -> int:
    """This process's rank in the mesh of the trees' DTensors (0 where
    they hold none)."""
    for tree in trees:
        for _, leaf in flatten_with_path(tree):
            if is_sharded(leaf):
                return leaf.device_mesh.get_rank()
    return 0


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
    shardings: Any = None,
    opt_shardings: Any = None,
) -> Tuple[Any, Any, int, int]:
    """Restore ``(params, opt_state, step, data_cursor)`` as tensors on
    ``device`` (None: the card), in the templates' structures; the latest
    step unless ``step`` is given.  A hash or shape that does not match
    the manifest raises ``AssertionError``, as in the reference.

    ``shardings`` and ``opt_shardings`` (trees of
    :class:`~repro_torch.distributed.sharding.NamedSharding` matching the
    templates) restore elastically onto the current mesh, as the
    reference's do: each rank reads every file and keeps its own shard as
    a DTensor, whatever mesh wrote the checkpoint."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(directory)
    assert step is not None, f"no checkpoint found in {directory}"
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def restore(prefix, template, shard_tree):
        if template is None:
            return None
        flat = flatten_with_path(template)
        shards = ([s for _, s in flatten_with_path(shard_tree)]
                  if shard_tree is not None else [None] * len(flat))
        out = []
        for (pth, _), shard in zip(flat, shards):
            name = path_name(pth)
            meta = manifest["leaves"][f"{prefix}/{name}"]
            fpath = os.path.join(path, meta["file"])
            assert _sha(fpath) == meta["sha"], f"hash mismatch for {name}"
            t = _read(fpath, meta["dtype"])
            assert list(t.shape) == meta["shape"]
            t = t.to(dev)
            out.append(t if shard is None else place(t, shard))
        return unflatten(template, out)

    params = restore("params", params_template, shardings)
    opt = restore("opt", opt_template, opt_shardings)
    return params, opt, manifest["step"], manifest["data_cursor"]


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async (threaded)
    saves.  A save copies the trees to the host before it returns, so the
    caller may update its tensors in place while the thread writes; on a
    mesh every rank gathers and rank 0 writes."""

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
        rank = _mesh_rank(params, opt_state)
        host_params = tree_map(_host, params)
        host_opt = tree_map(_host, opt_state) if opt_state is not None else None
        if rank > 0:   # gathered with rank 0, which writes
            return

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
