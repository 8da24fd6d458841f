"""Build the port's CUDA sources at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` (all started
together) for ``sm_90a`` and linked into one shared library with a plain
C interface, under ``build/kernels/`` at the repository root, named by a
hash of the sources and flags: a checkout builds once, and an edited
source builds anew.  Nothing is compiled when a module is imported.

Each C entry point takes raw device pointers, sizes and a CUDA stream,
launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; :class:`CudaKernel` raises when that is not 0 and
counts the launches that succeeded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/`` into the shared library (if not built yet) and
    return its path.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report of registers, shared memory and spills."""
    srcs = sources()
    lib = BUILD_DIR / f"librepro_torch_kernels-{_digest(srcs)}.so"
    if lib.exists() and not verbose:
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(srcs, objs)
        ]
        failed = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            if verbose and out:
                print(out, end="")
            if p.returncode != 0:
                failed.append(f"{s.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class CudaKernel:
    """One C entry point of the kernel library and its launch count.

    ``argtypes`` lists the entry point's arguments before the trailing
    stream; ``launches`` counts the launches that returned no error and
    ``largest`` keeps the sizes of the largest of them."""

    def __init__(self, symbol: str, argtypes: Iterable, source: str,
                 replaces: str):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = source        # repository path of the CUDA source
        self.replaces = replaces    # file:line of the TPU kernel it ports
        self.launches = 0
        self.largest: Optional[Tuple[int, ...]] = None
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, sizes: Tuple[int, ...],
               *args) -> None:
        """Launch on ``device``'s current stream; raise on a CUDA error.
        ``sizes`` are the operand lengths, kept for the largest launch."""
        fn = self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            msg = library().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
        if self.largest is None or sum(sizes) > sum(self.largest):
            self.largest = tuple(sizes)


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Validate a (1-d) kernel operand before its pointer is taken."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} lies on unsupported device {t.device}")
