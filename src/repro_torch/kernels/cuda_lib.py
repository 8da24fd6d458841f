"""Build the port's CUDA sources at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` (all started
together) for ``sm_90a`` and linked into one shared library with a plain
C interface, under ``build/kernels/`` at the repository root, named by a
hash of the sources, the headers they include (``csrc/*.cuh``, never
given to ``nvcc`` themselves) and the flags: a checkout builds once, and
an edited source or header builds anew.  Nothing is compiled when a
module is imported.

Each C entry point takes raw device pointers, sizes and a CUDA stream,
launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; :class:`CudaKernel` raises when that is not 0 and
counts the launches that succeeded.

Every wrapper passes :meth:`CudaKernel.charged` before it takes a
pointer: the one place where a traced step's launch is charged to an
active dry run (``launch.dryrun``) instead of launched.  Operands with
data never take it; a fake operand (no data) outside a dry run raises.
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
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import dry_run, is_fake

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
    """The files ``nvcc`` compiles, one object each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    """The headers the sources include: hashed, not compiled."""
    return sorted(CSRC.glob("*.cuh"))


def _digest(files: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in files:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/`` into the shared library (if not built yet) and
    return its path.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report of registers, shared memory and spills."""
    srcs = sources()
    lib = BUILD_DIR / \
        f"librepro_torch_kernels-{_digest(srcs + headers())}.so"
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


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream.  PyTorch's own
    raw getter (the one its compiled kernels launch with) skips building a
    ``torch.cuda.Stream`` object on every launch."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


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
        # file:line of the TPU kernel it ports, or "none: <why>"
        self.replaces = replaces
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

    def charged(self, operands: Sequence[Optional[torch.Tensor]],
                cost: Callable[[], object]) -> bool:
        """The dry run's chokepoint, which every wrapper passes before it
        takes a pointer.  False where no operand is fake: the caller
        launches.  Where one is (a ``meta`` tensor or a ``FakeTensor``)
        and a dry run is active, the launch is charged to it (this
        kernel's name and ``cost()``, a ``costs.Cost``) and True comes
        back: the caller returns the outputs it allocated, unwritten.
        ``launches`` does not count a charge.  A fake operand outside a
        dry run raises: a real run never skips its kernel here."""
        if not any(is_fake(t) for t in operands):
            return False
        run = dry_run()
        if run is None:
            raise RuntimeError(
                f"{self.symbol}: a tensor with no data reached the kernel's "
                "launch outside a dry run (launch.dryrun)")
        run.charge(self.symbol, cost())
        return True

    def launch(self, device: torch.device, sizes: Tuple[int, ...],
               *args, stream: Optional[int] = None) -> None:
        """Launch on ``device``'s current stream (or on ``stream``, a
        handle of it the caller holds); raise on a CUDA error.  ``sizes``
        are the operand lengths, kept for the largest launch.  The device
        is made current only when it is not already."""
        if device.index not in (None, torch.cuda.current_device()):
            with torch.cuda.device(device):
                return self.launch(device, sizes, *args, stream=stream)
        fn = self._bind()
        if stream is None:
            stream = stream_handle(device)
        err = fn(*args, stream)
        if err != 0:
            msg = library().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
        if self.largest is None or sum(sizes) > sum(self.largest):
            self.largest = tuple(sizes)


def check_device(t: torch.Tensor, name: str) -> None:
    """The card, the CPU, or (inside a dry run only) the ``meta`` device
    that stands for the card."""
    if t.device.type in ("cuda", "cpu"):
        return
    if t.device.type == "meta" and dry_run() is not None:
        return
    raise ValueError(f"{name} lies on unsupported device {t.device}")


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
    check_device(t, name)


def require_no_grad(kernel: str, *operands: torch.Tensor,
                    hint: str = "call it under torch.no_grad()") -> None:
    """Raise where autograd would record a kernel call that has no
    backward: the output of a ``ctypes`` launch has no ``grad_fn``, so a
    loss through it would leave the operands' gradients silently unset.
    ``hint`` says what to call instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an operand "
            f"requires grad; {hint}, or pass CPU tensors, whose plain "
            "version differentiates")


# dtype codes of the float kernels' C entry points
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_float_operand(t: torch.Tensor, name: str, ndim: int) -> None:
    """Validate an ``ndim``-d f32 or bf16 kernel operand whose last dim
    is contiguous (other strides are the caller's to check)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype not in FLOAT_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along its last dim")
    check_device(t, name)
