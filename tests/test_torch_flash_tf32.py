"""The f32 flash-attention routes' split-TF32 arithmetic, on the CPU.

The CUDA kernels (``csrc/flash_attention.cu`` and the f32 route of
``csrc/flash_attention_bwd.cu``, built on ``csrc/tf32.cuh``) run only on
the card.  Here: a PyTorch emulation of their arithmetic -- each operand
split into tf32 hi + lo by integer operations on the f32 word (to
nearest, ties away from zero), each product taken as hi lo + lo hi + hi
hi, the kernels' tiles (64-key tiles up to D 64 and 32 at D 128 in the
forward; 16-row streamed tiles in the backward), the
forward's online softmax in base 2 and each tile's share added in f32 --
held to the JAX package: the forward to its Pallas kernel (interpret
mode) and oracle, the backward to ``jax.grad`` of its jnp attention, all
within the card's f32 limit (``chip_smoke.F32_TOL``, 2e-5).  One TF32
product alone (hi hi) fails the card's check: that is why the kernels
split.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import attention as ref_attention

from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_plain,
    flash_attention_plain,
)
from torch_threads import one_torch_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
LOG2E = 1.4426950408889634
TOL = 2e-5               # chip_smoke.F32_TOL, the card's f32 limit


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


# ------------------------------------------------ the kernels' arithmetic --
def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 as ``tf32.cuh`` does it: 0x1000 added to the f32
    word, the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def parts(x: torch.Tensor, single: bool = False):
    """(hi, lo) of an f32 operand; lo is 0 for one TF32 product alone."""
    hi = tf32(x)
    return hi, (torch.zeros_like(hi) if single else tf32(x - hi))


def mm3(a: torch.Tensor, b: torch.Tensor, single: bool = False):
    """a @ b as the kernels take it: the lo terms first, then hi hi (a bf16
    operand is exact in tf32, so its lo is 0 and its terms vanish)."""
    ah, al = parts(a, single)
    bh, bl = parts(b, single)
    return (ah @ bl + al @ bh) + ah @ bh


def _c(D):
    """The kernels' exponent scale, log2(e) / sqrt(D), formed in f32."""
    return float(np.float32(1.0 / math.sqrt(D)) * np.float32(LOG2E))


def emulate_forward(q, k, v, causal=True, single=False):
    """``csrc/flash_attention.cu``'s arithmetic: (output, base-2 lse)."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kf = k.float().repeat_interleave(G, 1)
    vf = v.float().repeat_interleave(G, 1)
    qf = q.float()
    c = _c(D)
    bk = 64 if D <= 64 else 32
    m = torch.full((B, H, S), -math.inf)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, D)
    rows = torch.arange(S)
    for k0 in range(0, S, bk):
        keys = torch.arange(k0, min(S, k0 + bk))
        s = mm3(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2), single)
        if causal:
            s = s.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - mx) * c)
        p = torch.exp2(s * c - (mx * c)[..., None])
        l = l * corr + p.sum(-1)
        m = mx
        acc = acc * corr[..., None] + mm3(p, vf[:, :, k0:k0 + bk], single)
    denom = l.clamp_min(1e-30)
    return (acc / denom[..., None]).to(q.dtype), m * c + torch.log2(denom)


def emulate_backward(q, k, v, out, lse, do, causal=True, single=False):
    """``csrc/flash_attention_bwd.cu``'s f32 route: (dq, dk, dv).  Each
    query head's dK/dV share walks its query tiles, and the group's
    shares are summed in head order; dQ walks the key tiles; each tile's
    share is added in f32."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    c = _c(D)
    scale = float(np.float32(1.0 / math.sqrt(D)))
    n = 16
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * out.float()).sum(-1)
    pos = torch.arange(S)
    ke = kf.repeat_interleave(G, 1)
    ve = vf.repeat_interleave(G, 1)
    # the whole tiles of n rows in one batched product and a ragged last
    # tile in another: [(first row, tiles, rows a tile)]
    full = S // n * n
    chunks = [(r0, (S - r0) // m, m) for r0, m in ((0, n), (full, S - full))
              if S - r0 >= m > 0]

    def tiles(t, r0, T, m):
        """Rows r0 .. r0 + T m of (B, H, S[, D]) as (B, H, T, m[, D])."""
        return t[:, :, r0:r0 + T * m].unflatten(2, (T, m))

    dv_t, dk_t, dq_t = [], [], []
    for r0, T, m in chunks:
        # a KV head's query tiles, its group's heads on their own axis
        qt, dot, lt, dt = (tiles(t, r0, T, m).unflatten(1, (Hkv, G))
                           for t in (qf, dof, lse, delta))
        cols = torch.arange(r0, r0 + T * m).view(T, 1, m)
        kx, vx = kf[:, :, None, None], vf[:, :, None, None]
        p = torch.exp2(mm3(kx, qt.transpose(-1, -2), single) * c
                       - lt[..., None, :])
        if causal:
            p = p.masked_fill(pos[:, None] > cols, 0.0)
        dp = mm3(vx, dot.transpose(-1, -2), single)
        ds = p * (dp - dt[..., None, :])
        dv_t.append(mm3(p, dot, single))          # (B, Hkv, G, T, S, D)
        dk_t.append(mm3(ds, qt, single))
        # dQ's key tiles, each query head over its KV head's keys
        kt, vt = tiles(ke, r0, T, m), tiles(ve, r0, T, m)
        p = torch.exp2(mm3(qf[:, :, None], kt.transpose(-1, -2), single)
                       * c - lse[:, :, None, :, None])
        if causal:
            p = p.masked_fill(cols > pos[:, None], 0.0)
        dp = mm3(dof[:, :, None], vt.transpose(-1, -2), single)
        ds = p * (dp - delta[:, :, None, :, None])
        dq_t.append(mm3(ds, kt, single))          # (B, H, T, S, D)
    dv_t, dk_t = torch.cat(dv_t, 3), torch.cat(dk_t, 3)
    dq_t = torch.cat(dq_t, 2)
    # each tile's share added in f32, in the kernels' order
    dk = torch.zeros(B, Hkv, S, D)
    dv = torch.zeros(B, Hkv, S, D)
    for g in range(G):      # each head's share, summed in head order
        dkg = torch.zeros(B, Hkv, S, D)
        dvg = torch.zeros(B, Hkv, S, D)
        for i in range(dv_t.shape[3]):
            dvg = dvg + dv_t[:, :, g, i]
            dkg = dkg + dk_t[:, :, g, i]
        dk = dk + dkg * scale
        dv = dv + dvg
    dq = torch.zeros(B, H, S, D)
    for i in range(dq_t.shape[2]):
        dq = dq + dq_t[:, :, i]
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _inputs(B, H, Hkv, S, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, h, S, D).astype(np.float32))
                 for h in (H, Hkv, Hkv, H))


def _expanded(t, G):
    return jnp.asarray(t.repeat_interleave(G, 1).numpy())


# --------------------------------------------------------------- tf32 --
def test_tf32_is_round_to_nearest_ties_away_on_the_word():
    """The bit rounding is float64 rounding to 11 significant bits, ties
    away from zero, on normal values (and keeps bf16 values exact, so a
    bf16 operand's lo is 0)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.randint(-20, 20, 4096)).astype(
        np.float32)
    ties = np.float32(1.0 + 2.0 ** -11) * np.float32([1, -1, 3, -5])
    x = np.concatenate([x, ties])
    e = np.floor(np.log2(np.abs(x.astype(np.float64))))
    ulp = 2.0 ** (e - 10)
    want = np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp
    got = tf32(torch.from_numpy(x)).double().numpy()
    np.testing.assert_array_equal(got, want)
    b = torch.from_numpy(x).to(torch.bfloat16).float()
    assert torch.equal(tf32(b), b)
    hi, lo = parts(torch.from_numpy(x))
    assert (hi + lo - torch.from_numpy(x)).abs().le(
        2.0 ** -21 * torch.from_numpy(x).abs()).all()


def test_emulated_tiles_are_the_sources():
    """The emulation's tile sizes are those the CUDA sources name."""
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert re.search(r"kBK = D <= 64 \? 64 : 32;", fwd)
    assert re.search(r"kN = 16;", bwd)
    assert "0x1000u) & 0xFFFFE000u" in (CSRC / "tf32.cuh").read_text()


# ------------------------------------------------------ forward, backward --
SIZES, GROUPS = (1, 37, 129, 200), (1, 4)
CASES = [(D, S, G, causal) for D in (8, 16, 64) for S in SIZES
         for G in GROUPS for causal in (True, False)]


def _case_inputs(D, S, G):
    return _inputs(1, 2 * G, 2, S, D, seed=S + 7 * D + G)


@pytest.fixture(scope="module")
def jax_refs():
    """For every case, the JAX package's oracle output and ``jax.grad``
    (a vjp) of its jnp attention in (B, S, H, D) layout, all from one
    jitted program."""

    def all_refs(problems):
        res = []
        for (q, k, v, do), (_, _, G, causal) in zip(problems, CASES):
            fwd = flash_attention_ref(
                q.transpose(0, 2, 1, 3),
                jnp.repeat(k, G, 2).transpose(0, 2, 1, 3),
                jnp.repeat(v, G, 2).transpose(0, 2, 1, 3), causal=causal)
            _, vjp = jax.vjp(lambda a, b, c, causal=causal:
                             ref_attention.attention(a, b, c, causal=causal),
                             q, k, v)
            res.append((fwd, vjp(do)))
        return res

    problems = [tuple(jnp.asarray(t.transpose(1, 2).numpy())
                      for t in _case_inputs(D, S, G))
                for D, S, G, _ in CASES]
    return {case: (np.asarray(fwd), [np.asarray(g) for g in grads])
            for case, (fwd, grads) in zip(CASES, jax.jit(all_refs)(problems))}


@pytest.mark.parametrize("D,S,G,causal", CASES)
def test_forward_emulation_matches_the_oracle(D, S, G, causal, jax_refs):
    """D 8, 16, 64; S 1, 37, 129, 200; 1 and 4 query heads a KV head;
    causal and not: the emulated kernel's output within 2e-5 of the JAX
    package's oracle, and within the card's checks (output and lse) of
    the plain version."""
    q, k, v, _ = _case_inputs(D, S, G)
    got, lse = emulate_forward(q, k, v, causal)
    want = jax_refs[(D, S, G, causal)][0]
    assert np.abs(want - got.numpy()).max() <= TOL
    plain, plain_lse = flash_attention_plain(q, k, v, causal, True)
    assert CS.attention_check(got, plain)["within_tolerance"]
    assert CS.lse_check(lse, plain_lse)["within_tolerance"]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_emulation_matches_the_pallas_kernel(causal):
    """S 256, 2 query heads over 1, D 64: the emulation against the JAX
    package's Pallas kernel in interpret mode (K/V expanded: it has no
    GQA), within 2e-5."""
    q, k, v, _ = _inputs(1, 2, 1, 256, 64, seed=11)
    got, _ = emulate_forward(q, k, v, causal)
    want = ref_flash(jnp.asarray(q.numpy()), _expanded(k, 2),
                     _expanded(v, 2), causal=causal)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= TOL


@pytest.mark.parametrize("D,S,G,causal", CASES)
def test_backward_emulation_matches_jax_grad(D, S, G, causal, jax_refs):
    """The same cases: the emulated dq, dk, dv (from the emulated
    forward's output and lse) within 2e-5 of ``jax.grad`` of the JAX
    package's jnp attention, and within the card's check of the plain
    backward."""
    q, k, v, do = _case_inputs(D, S, G)
    out, lse = emulate_forward(q, k, v, causal)
    got = emulate_backward(q, k, v, out, lse, do, causal)
    for r, g in zip(jax_refs[(D, S, G, causal)][1], got):
        assert np.abs(r - g.transpose(1, 2).numpy()).max() <= TOL
    plain = flash_attention_backward_plain(q, k, v, do, causal, out=out)
    assert CS.backward_check(got, plain)["within_tolerance"]


# ------------------------------------------------ why the split is there --
def test_one_tf32_product_fails_the_card_check():
    """With hi hi alone (one TF32 product, about three decimal digits),
    the forward's output and the backward's gradients miss the card's
    f32 limit many times over, where the split passes it."""
    q, k, v, do = _inputs(1, 4, 1, 200, 64, seed=5)
    plain, _ = flash_attention_plain(q, k, v, True, True)
    split, lse = emulate_forward(q, k, v)
    single, _ = emulate_forward(q, k, v, single=True)
    assert CS.attention_check(split, plain)["within_tolerance"]
    assert CS.attention_check(single, plain)["max_err_ratio"] > 5.0
    grads = flash_attention_backward_plain(q, k, v, do, True, out=split)
    check = CS.backward_check(
        emulate_backward(q, k, v, split, lse, do), grads)
    assert check["within_tolerance"], check
    check = CS.backward_check(
        emulate_backward(q, k, v, split, lse, do, single=True), grads)
    assert min(check[g]["max_err_ratio"] for g in CS.GRADS) > 5.0, check
