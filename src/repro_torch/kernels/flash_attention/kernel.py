"""Flash attention: the wrapper of its two CUDA kernels.

Online-softmax attention over (B, H, S, D) queries and (B, Hkv, S, D) keys
and values, causal or not; query head ``h`` reads KV head ``h // (H //
Hkv)`` (GQA without expanding K/V).  m, l and the accumulator are f32 and
the output has the input dtype, as in the Pallas ``flash_attention_kernel``
that both CUDA kernels port; each source says how and what bounds it.  Any
S: the kernels mask the ragged edge themselves, so there is no ``S % bq``
condition.

Two routes, chosen by :func:`flash_route` from the dtype and D alone:

  * bf16 at D 64 or 128 -> ``FLASH_ATTENTION_WGMMA``
    (``csrc/flash_attention_wgmma.cu``): TMA-fed ``wgmma`` on the tensor
    cores.  TMA reads its operands, so each of q, k and v must pass
    :func:`tma_problem` (16-byte aligned base, strides of 16 bytes, D
    contiguous); one that does not raises.
  * everything else (f32 at any D; bf16 at D 8, 16, 32) ->
    ``FLASH_ATTENTION`` (``csrc/flash_attention.cu``): split-TF32
    ``wgmma`` on the tensor cores (each f32 product as hi lo + lo hi + hi
    hi of tf32 halves, ``csrc/tf32.cuh``), its tiles staged by its own
    threads, so any strides with a contiguous D are read in place and
    nothing is copied.

It is a choice between two hand-written kernels, each with its own launch
count, never a retry: a CUDA error from either raises.  Either writes each
row's base-2 log-sum-exp beside the output when asked (``return_lse``).

Under autograd, :func:`flash_attention_differentiable` is one
``torch.autograd.Function``.  Its forward is :func:`flash_attention` with
the log-sum-exp, and it saves q, k, v, the output and the log-sum-exp.
Its backward on CUDA tensors is the hand kernel of
``csrc/flash_attention_bwd.cu`` (:func:`run_backward`), on the route that
:func:`flash_backward_route` picks; on CPU tensors it is
``ref.flash_attention_backward_plain``.  The reference takes this
gradient with ``jax.grad`` of its jnp attention and has no kernel for it.
The bare wrapper has no backward and refuses operands that require grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.costs import flash_backward_cost, flash_cost
from repro_torch.kernels.cuda_lib import (
    FLOAT_CODES,
    CudaKernel,
    check_float_operand,
    require_no_grad,
)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_plain,
    flash_attention_plain,
)

FLASH_ATTENTION = CudaKernel(
    "flash_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
    + [ctypes.c_int, ctypes.c_float],
    source="src/repro_torch/csrc/flash_attention.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:73",
)

FLASH_ATTENTION_WGMMA = CudaKernel(
    "flash_attention_wgmma",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
    + [ctypes.c_int, ctypes.c_float],
    source="src/repro_torch/csrc/flash_attention_wgmma.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:73",
)

# The backward's two routes.  Each C call launches the row pass, dK/dV and
# dQ, and counts once.  They replace the forward's TPU kernel's gradient:
# the reference takes it with jax.grad and has no kernel for it.
FLASH_ATTENTION_BACKWARD_WGMMA = CudaKernel(
    "flash_attention_backward_wgmma",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 24
    + [ctypes.c_int, ctypes.c_float],
    source="src/repro_torch/csrc/flash_attention_bwd.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:73",
)

FLASH_ATTENTION_BACKWARD = CudaKernel(
    "flash_attention_backward",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 24
    + [ctypes.c_int, ctypes.c_float],
    source="src/repro_torch/csrc/flash_attention_bwd.cu",
    replaces="src/repro/kernels/flash_attention/kernel.py:73",
)

HEAD_DIMS = (8, 16, 32, 64, 128)
# what the bare wrapper's grad guard says to call instead
NO_GRAD_HINT = ("differentiate through flash_attention_differentiable, whose "
                "backward is the hand kernel of csrc/flash_attention_bwd.cu")
WGMMA_HEAD_DIMS = (64, 128)
TMA_ALIGN = 16       # bytes: TMA's base and stride unit
TMA_MAX_STRIDE = 1 << 40
# the wgmma backward's row pass writes lse and delta in rows of S rounded up
# to its kernels' 128-row tiles
BACKWARD_ROW_PAD = 128


def flash_route(dtype: torch.dtype, head_dim: int) -> CudaKernel:
    """The kernel a CUDA call of ``dtype`` and head dim ``head_dim`` takes:
    the bf16 wgmma kernel for bf16 at D 64 or 128, the split-TF32 one
    otherwise."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return FLASH_ATTENTION_WGMMA
    return FLASH_ATTENTION


def flash_backward_route(dtype: torch.dtype, head_dim: int) -> CudaKernel:
    """The backward kernel a CUDA call of ``dtype`` and head dim
    ``head_dim`` takes: the TMA-fed ``wgmma`` route for bf16 at D 64 or
    128 (both fit the consumers' registers: streamed tiles of 64 rows at
    D 64, 32 at D 128), the split-TF32 ``wgmma`` route otherwise (its
    tiles staged by its own threads, as the forward's f32 route does)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return FLASH_ATTENTION_BACKWARD_WGMMA
    return FLASH_ATTENTION_BACKWARD


def tma_problem(t: torch.Tensor) -> Optional[str]:
    """Why a (B, heads, S, D) operand cannot be read through a TMA tensor
    map, or None when it can: its base must be 16-byte aligned, its last
    dim contiguous, and the (batch, head, seq) strides of the dims longer
    than 1 multiples of 16 bytes below 2^40 (a dim of size 1 is never
    stepped, so its stride is free)."""
    esize = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        return f"base address {t.data_ptr():#x} is not {TMA_ALIGN}-byte aligned"
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return "last dim is not contiguous"
    for dim in range(3):
        n, stride = t.shape[dim], t.stride(dim) * esize
        if n > 1 and (stride % TMA_ALIGN or not 0 < stride < TMA_MAX_STRIDE):
            return (f"dim {dim} stride of {stride} bytes is not a positive "
                    f"multiple of {TMA_ALIGN} below 2^40")
    return None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, return_lse: bool = False):
    """(B, H, S, D) attention output in ``q.dtype`` (and, with
    ``return_lse``, each row's base-2 log-sum-exp, f32 (B, H, S)).

    ``q`` is (B, H, S, D); ``k`` and ``v`` are (B, Hkv, S, D) with ``H %
    Hkv == 0``, all of one dtype (f32 or bf16) on one device, each with a
    contiguous last dim (other strides are free, but for the wgmma route's
    16-byte conditions).  CUDA tensors go through the kernel that
    :func:`flash_route` names, which has no backward: under grad mode an
    operand that requires grad raises (differentiate through
    :func:`flash_attention_differentiable`).  CPU tensors go through
    :func:`flash_attention_plain`, which differentiates."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_float_operand(t, name, 4)
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    Hkv = k.shape[1]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, return_lse)
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    require_no_grad("flash_attention", q, k, v, hint=NO_GRAD_HINT)
    return run_kernel(flash_route(q.dtype, D), q, k, v, causal, return_lse)


def run_kernel(kernel: CudaKernel, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, causal: bool = True, return_lse: bool = False):
    """Launch ``kernel`` (either route) on CUDA operands that
    :func:`flash_attention` has validated, and return its output (and,
    with ``return_lse``, the log-sum-exp it wrote).  The wrapper calls it
    with :func:`flash_route`'s choice; the card's checks call it to time
    the split-TF32 kernel on bf16 operands too."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or kernel.charged(
            (q, k, v), lambda: flash_cost(B, H, Hkv, S, D, q.dtype, causal)):
        return (out, lse) if return_lse else out
    if kernel is FLASH_ATTENTION_WGMMA:
        if q.dtype != torch.bfloat16 or D not in WGMMA_HEAD_DIMS:
            raise ValueError(f"the wgmma kernel takes bf16 at D in "
                             f"{WGMMA_HEAD_DIMS}, not {q.dtype} at D {D}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            problem = tma_problem(t)
            if problem:
                raise ValueError(f"{name} cannot be read by TMA: {problem}")
        dtype_code = ()    # bf16 only
    else:
        dtype_code = (FLOAT_CODES[q.dtype],)
    kernel.launch(
        q.device, (B, H, Hkv, S, D),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *dtype_code, B, H, Hkv, S, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), 1.0 / math.sqrt(D),
    )
    return (out, lse) if return_lse else out


def run_backward(kernel: CudaKernel, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                 grad_out: torch.Tensor, causal: bool = True):
    """``(dq, dk, dv)`` of flash attention from CUDA operands that
    :func:`flash_attention` took, its output ``out`` and log-sum-exp
    ``lse``, through ``kernel`` (either backward route): one launch of
    the C entry point, which runs the row pass, dK/dV and dQ.  The
    gradients are allocated in the operands' layouts and written whole.
    ``grad_out`` is copied only where the route cannot read it in place
    (a strided last dim, or the bf16 wgmma route's 16-byte conditions,
    which q, k, v and ``out`` must meet or raise; the split-TF32 route
    stages its own tiles and asks no alignment).  Scratch: delta (and
    lse's padded copy on the wgmma route; each query head's f32 share of
    dk and dv on the split-TF32 route under GQA, 2 B H S D floats)."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if grad_out.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} and out "
                         f"{tuple(out.shape)} must be q's {tuple(q.shape)}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be f32 contiguous {(B, H, S)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    wgmma = kernel is FLASH_ATTENTION_BACKWARD_WGMMA
    if wgmma:
        if q.dtype != torch.bfloat16 or D not in WGMMA_HEAD_DIMS:
            raise ValueError(f"the wgmma backward takes bf16 at D in "
                             f"{WGMMA_HEAD_DIMS}, not {q.dtype} at D {D}")
        dtype_code = ()    # bf16 only
        # lse's padded copy, then delta
        scratch = 2 * B * H * (-(-S // BACKWARD_ROW_PAD) * BACKWARD_ROW_PAD)
    else:
        if grad_out.shape[-1] > 1 and grad_out.stride(-1) != 1:
            grad_out = grad_out.contiguous()
        dtype_code = (FLOAT_CODES[q.dtype],)
        # delta, then (GQA) each query head's f32 share of dk and of dv,
        # which the kernel sums over the group in head order
        scratch = B * H * S * (1 + (2 * D if H != Hkv else 0))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty(scratch, dtype=torch.float32, device=q.device)
    if kernel.charged((q, k, v, out, lse, grad_out),
                      lambda: flash_backward_cost(B, H, Hkv, S, D, q.dtype,
                                                  causal)):
        return dq, dk, dv
    if wgmma:
        if tma_problem(grad_out):
            grad_out = grad_out.clone(memory_format=torch.contiguous_format)
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            problem = tma_problem(t)
            if problem:
                raise ValueError(f"the wgmma backward cannot read {name}: "
                                 f"{problem}")
    kernel.launch(
        q.device, (B, H, Hkv, S, D),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        grad_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *dtype_code, B, H, Hkv, S, D,
        *(s for t in (q, k, v, out, grad_out, dq, dk, dv)
          for s in t.stride()[:3]),
        int(causal), 1.0 / math.sqrt(D),
    )
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention under autograd.  The reference differentiates its
    jnp attention (``repro.models.attention``) with ``jax.grad``; here the
    forward kernel saves its output and log-sum-exp, and the backward is
    the hand kernel on CUDA tensors (or raises) and the plain backward on
    CPU tensors, both taking delta from the saved output.  The training
    path recomputes each block, so the saved tensors live through one
    block's backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention(q, k, v, causal, return_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, grad_out, ctx.causal, out=out)
        else:
            dq, dk, dv = run_backward(
                flash_backward_route(q.dtype, q.shape[-1]), q, k, v, out,
                lse, grad_out, ctx.causal)
        return dq, dk, dv, None


def flash_attention_differentiable(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   causal: bool = True) -> torch.Tensor:
    """:func:`flash_attention` (same operands, same output) with a
    backward: the hand kernel (:func:`run_backward`) on CUDA tensors,
    ``flash_attention_backward_plain`` on CPU tensors."""
    return _FlashAttention.apply(q, k, v, causal)
