"""The flash-attention backward kernel's routes and arithmetic, on the CPU.

The CUDA kernels (``csrc/flash_attention_bwd.cu``) run only on the card.
Here: a tile-by-tile PyTorch emulation of the wgmma route's arithmetic
(128-row blocks in halves of 64 that a warpgroup owns, streamed query
tiles of 64 rows at D 64 and 32 at D 128 in dK/dV, key tiles of 64 in
dQ, tiles wholly past the diagonal skipped,
P recomputed in base 2 from the saved log-sum-exp, delta from the saved
output, P and dS split into bf16 hi + lo, each tile's share summed from
zero and added in f32, the dK/dV sum over a KV head's query heads) held to
``chip_smoke.elementwise_check`` against ``flash_attention_backward_plain``;
the same emulation with P and dS rounded once fails the check.  Also the
plain forward's log-sum-exp against the reference's scores, the backward
route rule, each ``CudaKernel``'s argtypes against its ``extern "C"``
signature, and ``chip_smoke``'s backward check on two wrong backwards.
"""

import importlib.util
import math
import re
from pathlib import Path

import ctypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.kernels.flash_attention.kernel import (
    FLASH_ATTENTION,
    FLASH_ATTENTION_BACKWARD,
    FLASH_ATTENTION_BACKWARD_WGMMA,
    FLASH_ATTENTION_WGMMA,
    flash_attention_differentiable,
    flash_backward_route,
)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_plain,
    flash_attention_plain,
)
from torch_threads import one_torch_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
OWN = 128               # rows a block owns: keys in dK/dV, queries in dQ
HALF = 64               # rows a consumer warpgroup owns
LOG2E = 1.4426950408889634


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16)


def _inputs(B, H, Hkv, S, D, seed, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    q, k, v, do = (_bf16(rng, B, h, S, D).to(dtype)
                   for h in (H, Hkv, Hkv, H))
    return q, k, v, do


# ------------------------------------------- the kernel's arithmetic --
def _parts(x, split):
    """The bf16 operands a product takes for the f32 ``x``: hi and lo,
    or (``split=False``) ``x`` rounded once."""
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)


def emulate_backward(q, k, v, out, lse, do, causal=True, split=True,
                     single=()):
    """The wgmma route's arithmetic in PyTorch, tile by tile and in the
    order its warpgroups run: delta from the saved output; dK/dV per
    128-key block, each half of 64 keys over the group's query heads in
    turn and, for each, the query tiles (N rows: 64 at D 64, 32 at D 128)
    from the block's first key on, a tile wholly above the half's keys
    skipped; dQ per 128-query block, each half of 64 over the key tiles of
    64 rows up to the block's diagonal, a tile wholly after the half's
    queries skipped; P = exp2(s c - lse) with c = log2(e) / sqrt(D), rows
    past S (lse +inf, delta 0) and keys after a query masked; each tile's
    share of dV, dK or dQ summed from zero in f32 over bf16 operands (P
    and dS as hi + lo, or rounded once with ``split=False``, or the one
    of them named in ``single``), then added to the running sum in f32; dk
    and dq scaled by 1/sqrt(D) at the end and each output rounded once to
    bf16.  A half's tiles (and a group's query heads) go through one
    batched product; only the running sums walk them in order."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    N = 64 if D == 64 else 32     # rows of a streamed query tile in dK/dV
    NK = 64                       # rows of a streamed key tile in dQ
    scale = 1.0 / math.sqrt(D)
    c = scale * LOG2E
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * out.float()).sum(-1)

    def tiles(t, n, fill=0.0):
        """(..., S[, D]) as (..., S/n tiles, n[, D]), ``fill`` past S."""
        vec = t.dim() == lse.dim()
        T = -(-S // n)
        shape = (*t.shape[:-1], T * n) if vec else (
            *t.shape[:-2], T * n, t.shape[-1])
        part = torch.full(shape, fill)
        if vec:
            part[..., :S] = t
            return part.unflatten(-1, (T, n))
        part[..., :S, :] = t
        return part.unflatten(-2, (T, n))

    def share(a, b, name):
        """a b from zero over bf16 parts of a (hi + lo, or once)."""
        return sum(part @ b
                   for part in _parts(a, split and name not in single))

    def run(acc, shares):
        """``shares`` (..., tiles, R, D) added to ``acc`` in tile order."""
        for i in range(shares.shape[-3]):
            acc += shares[..., i, :, :]
        return acc

    # query tiles of N rows, a KV head's group on its own axis:
    # (B, Hkv, G, T, N[, D])
    qg, dog = (tiles(t, N).unflatten(1, (Hkv, G)) for t in (qf, dof))
    lg = tiles(lse, N, math.inf).unflatten(1, (Hkv, G))
    dg = tiles(delta, N).unflatten(1, (Hkv, G))
    kh, vh = tiles(kf, HALF), tiles(vf, HALF)
    dk = torch.zeros(B, Hkv, S, D)
    dv = torch.zeros(B, Hkv, S, D)
    for w, kw0 in enumerate(range(0, S, HALF)):
        k0 = kw0 - kw0 % OWN          # the block's first key
        first = k0 if causal else 0
        if causal:                    # tiles wholly above the half skipped
            first = max(first, (kw0 - N) // N * N + N)
        js = slice(first // N, None)
        qt, dot = qg[:, :, :, js], dog[:, :, :, js]
        lc, dc = lg[:, :, :, js], dg[:, :, :, js]
        kt = kh[:, :, w, None, None]             # (B, Hkv, 1, 1, 64, D)
        vt = vh[:, :, w, None, None]
        st = kt @ qt.transpose(-1, -2)           # keys x queries
        dpt = vt @ dot.transpose(-1, -2)
        pt = torch.exp2(st * c - lc[..., None, :])
        if causal:
            keys = torch.arange(kw0, kw0 + HALF)
            cols = torch.arange(first, qg.shape[3] * N).view(-1, N)
            pt = pt.masked_fill(keys[:, None] > cols[:, None, :], 0.0)
        dst = pt * (dpt - dc[..., None, :])
        # the group's heads in turn, each over its tiles in order
        acc_v = run(torch.zeros(B, Hkv, HALF, D),
                    share(pt, dot, "p").flatten(2, 3))
        acc_k = run(torch.zeros(B, Hkv, HALF, D),
                    share(dst, qt, "ds").flatten(2, 3))
        n = min(HALF, S - kw0)
        dk[:, :, kw0:kw0 + n] = acc_k[:, :, :n] * scale
        dv[:, :, kw0:kw0 + n] = acc_v[:, :, :n]

    dq = torch.zeros(B, H, S, D)
    kt_all = tiles(kf.repeat_interleave(G, dim=1), NK)   # (B, H, T, NK, D)
    vt_all = tiles(vf.repeat_interleave(G, dim=1), NK)
    qh, doh = tiles(qf, HALF), tiles(dof, HALF)
    lh, dh = tiles(lse, HALF, math.inf), tiles(delta, HALF)
    for w, qw0 in enumerate(range(0, S, HALF)):
        q0 = qw0 - qw0 % OWN          # the block's first query
        n_kt = -(-(min(S, q0 + OWN) if causal else S) // NK)
        if causal:                    # tiles wholly after the half skipped
            n_kt = min(n_kt, (qw0 + HALF - 1) // NK + 1)
        qt, dot = qh[:, :, w, None], doh[:, :, w, None]  # (B, H, 1, 64, D)
        lr, dr = lh[:, :, w, None], dh[:, :, w, None]
        kt, vt = kt_all[:, :, :n_kt], vt_all[:, :, :n_kt]
        s = qt @ kt.transpose(-1, -2)
        dp = dot @ vt.transpose(-1, -2)
        p = torch.exp2(s * c - lr[..., None])
        rows = torch.arange(qw0, qw0 + HALF)
        keys = torch.arange(n_kt * NK).view(n_kt, 1, NK)
        mask = keys >= S
        if causal:
            mask = mask | (keys > rows[:, None])
        p = p.masked_fill(mask, 0.0)
        ds = p * (dp - dr[..., None])
        acc = run(torch.zeros(B, H, HALF, D), share(ds, kt, "ds"))
        n = min(HALF, S - qw0)
        dq[:, :, qw0:qw0 + n] = acc[:, :, :n] * scale
    return (dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _case(B, H, Hkv, S, D, causal, seed, split=True, single=()):
    """The plain backward (delta from the saved output, as the kernel
    takes it) and the emulation on the same seeded bf16 operands."""
    q, k, v, do = _inputs(B, H, Hkv, S, D, seed)
    out, lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    plain = flash_attention_backward_plain(q, k, v, do, causal, out=out)
    got = emulate_backward(q, k, v, out, lse, do, causal, split, single)
    return _chip_smoke().backward_check(got, plain)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 37, 129, 200])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,Hkv", [(4, 1), (2, 2)], ids=["gqa4", "mha"])
def test_emulation_passes_the_card_check(H, Hkv, D, S, causal):
    """GQA 4:1 and 1:1, D 64 and 128, ragged S, causal and not: the
    emulated kernel's dq, dk and dv each within the card's bf16 limit of
    the plain backward."""
    check = _case(1, H, Hkv, S, D, causal, seed=S + D + H)
    assert check["within_tolerance"], check


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("S", [127, 128, 129, 1000])
def test_emulation_passes_at_the_tile_edges(S, G, D, causal):
    """At the edges of the wgmma route's tiles (S one short of, at and one
    past a 128-row block, and 1,000: a ragged last block and streamed
    tile), over groups of 1, 4 and 8 query heads on two KV heads: the
    emulated kernel's dq, dk and dv within the card's bf16 limit."""
    check = _case(1, 2 * G, 2, S, D, causal, seed=S + 10 * G + D)
    assert check["within_tolerance"], check


@pytest.fixture(scope="module")
def long_case():
    """S 1,024 at granite's head width and group (D 64, 4 query heads
    over 1), causal: the split and the single-rounded emulations' checks."""
    return (_case(1, 4, 1, 1024, 64, True, seed=3),
            _case(1, 4, 1, 1024, 64, True, seed=3, split=False))


def test_split_p_and_ds_pass_at_length(long_case):
    split, _ = long_case
    assert split["within_tolerance"], split
    # not vacuous: the largest error takes a fair share of its limit
    assert max(split[g]["max_err_ratio"] for g in ("dq", "dk", "dv")) > 0.25


def test_single_rounded_p_and_ds_fail_the_card_check(long_case):
    """P and dS rounded once to bf16 err by up to 2^-9 of the sum of
    |terms|, past the limit of gradients near zero: that is why the
    kernel keeps their low halves."""
    split, single = long_case
    assert not single["within_tolerance"], single
    worst = max(single[g]["max_err_ratio"] for g in ("dq", "dk", "dv"))
    assert worst > 2.0, single


@pytest.mark.parametrize("single,worst", [("p", "dv"), ("ds", "dk")])
def test_p_or_ds_alone_rounded_once_fails_the_card_check(single, worst):
    """Neither split can go: with P alone rounded once, dv (its product)
    fails the check at S 1,024; with dS alone, dk and dq do."""
    check = _case(1, 4, 1, 1024, 64, True, seed=3, single=(single,))
    assert not check[worst]["within_tolerance"], check
    assert check[worst]["max_err_ratio"] > 2.0, check
    kept = "dk" if single == "p" else "dv"
    assert check[kept]["within_tolerance"], check


# ------------------------------------------------ the log-sum-exp --
@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_matches_reference_logsumexp(causal):
    """The plain forward's base-2 log-sum-exp against ``jax.nn.logsumexp``
    of the reference oracle's scaled, masked f32 scores (K/V expanded)."""
    B, H, Hkv, S, D = 2, 4, 2, 45, 16
    q, k, v, _ = _inputs(B, H, Hkv, S, D, seed=7, dtype=torch.float32)
    _, lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    qj = jnp.asarray(q.numpy())
    kj = jnp.asarray(k.repeat_interleave(H // Hkv, 1).numpy())
    scores = jnp.einsum("bhsd,bhtd->bhst", qj, kj,
                        preferred_element_type=jnp.float32) / math.sqrt(D)
    if causal:
        mask = jnp.arange(S)[:, None] >= jnp.arange(S)[None, :]
        scores = jnp.where(mask[None, None], scores, -1e30)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)) * LOG2E
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)


def test_function_saves_output_and_lse_and_takes_the_plain_backward():
    """On CPU tensors the ``Function``'s gradient is the plain backward
    with delta from the saved output, which equals autograd of the plain
    forward within f32 rounding."""
    q, k, v, do = _inputs(1, 4, 2, 33, 16, seed=9, dtype=torch.float32)
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention_differentiable(*live, True),
                              live, do)
    out = flash_attention_plain(q, k, v, True)
    plain = flash_attention_backward_plain(q, k, v, do, True, out=out)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref, True), ref, do)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * max(1.0, float(w.abs().max()))


# -------------------------------------------------------- the routes --
@pytest.mark.parametrize("head_dim", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_route_rule(dtype, head_dim):
    """bf16 at D 64 and 128 takes the tensor-core route; f32 at every D
    and bf16 at D 8, 16, 32 the scalar one; choosing launches nothing."""
    want = (FLASH_ATTENTION_BACKWARD_WGMMA
            if dtype == torch.bfloat16 and head_dim in (64, 128)
            else FLASH_ATTENTION_BACKWARD)
    assert flash_backward_route(dtype, head_dim) is want
    assert want.launches == 0
    assert want.replaces == "src/repro/kernels/flash_attention/kernel.py:73"
    assert (ROOT / want.source).is_file()


C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def _c_signature(source: Path, symbol: str) -> list:
    """The parameter types of ``extern "C" int symbol(...)`` in
    ``source``, the trailing stream dropped."""
    text = source.read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", text,
                  re.S)
    assert m, symbol
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
             for p in params]
    assert params[-1] == "void* stream", params[-1]
    return types[:-1]


@pytest.mark.parametrize("kernel", [
    FLASH_ATTENTION, FLASH_ATTENTION_WGMMA, FLASH_ATTENTION_BACKWARD,
    FLASH_ATTENTION_BACKWARD_WGMMA], ids=lambda k: k.symbol)
def test_argtypes_match_the_c_signature(kernel):
    assert kernel.argtypes == _c_signature(ROOT / kernel.source,
                                           kernel.symbol)


# ------------------------------------- chip_smoke's backward check --
def _group_share(q, k, v, out, do, causal, head):
    """dk's share from query ``head`` alone (the others' dO zeroed)."""
    only = torch.zeros_like(do)
    only[:, head] = do[:, head]
    return flash_attention_backward_plain(q, k, v, only, causal,
                                          out=out)[1].float()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_check_flags_a_wrong_backward(dtype):
    """``chip_smoke.backward_check`` passes the plain backward against
    itself and fails dq scaled by 1.05, and dk missing one query head's
    share of its group."""
    cs = _chip_smoke()
    q, k, v, do = _inputs(1, 4, 1, 70, 16, seed=11, dtype=dtype)
    out = flash_attention_plain(q, k, v, True)
    dq, dk, dv = flash_attention_backward_plain(q, k, v, do, True, out=out)
    assert cs.backward_check((dq, dk, dv), (dq, dk, dv))["within_tolerance"]
    bad_q = cs.backward_check(((dq.float() * 1.05).to(dtype), dk, dv),
                              (dq, dk, dv))
    assert not bad_q["within_tolerance"]
    assert not bad_q["dq"]["within_tolerance"]
    assert bad_q["dk"]["within_tolerance"] and bad_q["dv"]["within_tolerance"]
    short = (dk.float() - _group_share(q, k, v, out, do, True, 2)).to(dtype)
    bad_k = cs.backward_check((dq, short, dv), (dq, dk, dv))
    assert not bad_k["within_tolerance"]
    assert not bad_k["dk"]["within_tolerance"]
