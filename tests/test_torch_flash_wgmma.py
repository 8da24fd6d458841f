"""The wgmma flash-attention route, on the CPU.

The CUDA kernel (``csrc/flash_attention_wgmma.cu``) runs only on the card.
Here: the rule that picks it, the TMA conditions its operands must meet,
and a tile-by-tile PyTorch emulation of its arithmetic (128 x 128 tiles,
online softmax in base 2, bf16 operands, P split into bf16 hi + lo, f32
accumulation) held to ``chip_smoke.elementwise_check`` against the plain
version and to the JAX package's Pallas kernel (interpret mode) and
oracle.  The same emulation with P rounded once to bf16 fails the check:
that is why the kernel keeps P's low half.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_flash_oracle

from repro_torch.configs.granite_3_2b import CONFIG as GRANITE
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM
from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN
from repro_torch.kernels.flash_attention.kernel import (
    FLASH_ATTENTION,
    FLASH_ATTENTION_WGMMA,
    flash_route,
    run_kernel,
    tma_problem,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.models import attention as port_att
from torch_threads import one_torch_thread  # noqa: F401,E402

TILE = 128              # the kernel's q and kv tile
BF16_TOL = 2e-2         # the reference's bf16 kernel tolerance
LOG2E = 1.4426950408889634


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the route --
@pytest.mark.parametrize("head_dim", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_rule(dtype, head_dim):
    """bf16 at D 64 and 128 takes the wgmma kernel; f32 at every D and bf16
    at D 8, 16, 32 the scalar one."""
    want = (FLASH_ATTENTION_WGMMA
            if dtype == torch.bfloat16 and head_dim in (64, 128)
            else FLASH_ATTENTION)
    assert flash_route(dtype, head_dim) is want
    assert want.launches == 0   # choosing launches nothing


def test_the_routes_are_two_kernels_with_their_own_counts():
    assert FLASH_ATTENTION_WGMMA is not FLASH_ATTENTION
    assert FLASH_ATTENTION_WGMMA.symbol == "flash_attention_wgmma"
    assert FLASH_ATTENTION_WGMMA.replaces == FLASH_ATTENTION.replaces
    assert (Path(__file__).resolve().parents[1]
            / FLASH_ATTENTION_WGMMA.source).is_file()


# ------------------------------------------------------- TMA conditions --
def _views_of_attention(cfg, B=2, S=5):
    """The (B, H, S, D) views ``models.attention.attention`` hands the
    kernel wrapper (through its ``autograd.Function``), from (B, S, heads
    * D) projections as the transformer makes them."""
    seen = {}

    def capture(q, k, v, causal=True):
        seen.update(q=q, k=k, v=v)
        return q

    def proj(heads):
        return torch.zeros(B, S, heads * cfg.d_head, dtype=torch.bfloat16
                           ).reshape(B, S, heads, cfg.d_head)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_att, "flash_attention_differentiable", capture)
    try:
        port_att.attention(proj(cfg.n_heads), proj(cfg.n_kv_heads),
                           proj(cfg.n_kv_heads))
    finally:
        mp.undo()
    return seen


@pytest.mark.parametrize("cfg", [GRANITE, MINICPM, QWEN],
                         ids=lambda c: c.name)
def test_tma_accepts_the_views_attention_builds(cfg):
    views = _views_of_attention(cfg)
    for name, t in views.items():
        assert t.shape[1:] == (
            cfg.n_heads if name == "q" else cfg.n_kv_heads, 5, cfg.d_head)
        assert not t.is_contiguous()            # read in place, not copied
        assert tma_problem(t) is None, (name, tma_problem(t))
    assert flash_route(views["q"].dtype, cfg.d_head) is FLASH_ATTENTION_WGMMA


def test_tma_rejects_a_misaligned_base_and_an_odd_stride():
    flat = torch.zeros(2 * 4 * 8 * 64 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 4 * 8 * 64].view(2, 4, 8, 64)
    assert "aligned" in tma_problem(shifted)
    odd = torch.zeros(2, 4, 8, 65, dtype=torch.bfloat16)[..., :64]
    assert "stride" in tma_problem(odd)
    assert tma_problem(odd.transpose(2, 3)) == "last dim is not contiguous"
    # a dim of size 1 is never stepped, so its stride does not matter
    one = torch.zeros(1, 4, 8, 65, dtype=torch.bfloat16)[:, :, :1, :64]
    assert tma_problem(one) is None


def test_wgmma_route_raises_on_operands_it_cannot_read():
    """No silent copy and no fall back: an operand that fails TMA's
    conditions, or a dtype or D the kernel does not take, raises before
    anything is launched."""
    good = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    odd = torch.zeros(1, 2, 8, 72, dtype=torch.bfloat16)[..., 1:65]
    with pytest.raises(ValueError, match="k cannot be read by TMA"):
        run_kernel(FLASH_ATTENTION_WGMMA, good, odd, good)
    with pytest.raises(ValueError, match="wgmma kernel takes bf16"):
        run_kernel(FLASH_ATTENTION_WGMMA, good.float(), good.float(),
                   good.float())
    assert FLASH_ATTENTION_WGMMA.launches == 0


# ------------------------------------------- the kernel's arithmetic --
def emulate(q, k, v, causal=True, split=True):
    """The wgmma kernel's arithmetic in PyTorch: per (b, h) and 128-row q
    tile, 128-row kv tiles (those above the diagonal skipped), f32 scores
    of bf16 operands, keys past S or the diagonal masked to -inf, an
    online softmax in base 2 (``exp2(s * c - m * c)``, c = log2(e) /
    sqrt(D)), P split into bf16 hi and lo (or, with ``split=False``,
    rounded once), both multiplied into one f32 accumulator, l summed from
    the unrounded P and floored at 1e-30, the output rounded to bf16."""
    B, H, S, D = q.shape
    group = H // k.shape[1]
    c = LOG2E / math.sqrt(D)
    out = torch.empty(B, H, S, D)
    for b in range(B):
        for h in range(H):
            qh, kh, vh = (q[b, h].float(), k[b, h // group].float(),
                          v[b, h // group].float())
            for q0 in range(0, S, TILE):
                rows = torch.arange(q0, q0 + TILE)
                qt = torch.zeros(TILE, D)
                qt[:min(TILE, S - q0)] = qh[q0:q0 + TILE]
                m = torch.full((TILE,), -math.inf)
                l = torch.zeros(TILE)
                acc = torch.zeros(TILE, D)
                n_tiles = q0 // TILE + 1 if causal else -(-S // TILE)
                for t in range(n_tiles):
                    k0 = t * TILE
                    kt = torch.zeros(TILE, D)
                    vt = torch.zeros(TILE, D)
                    kt[:min(TILE, S - k0)] = kh[k0:k0 + TILE]
                    vt[:min(TILE, S - k0)] = vh[k0:k0 + TILE]
                    s = qt @ kt.T
                    keys = torch.arange(k0, k0 + TILE)
                    mask = keys[None, :] >= S
                    if causal:
                        mask = mask | (keys[None, :] > rows[:, None])
                    s = s.masked_fill(mask, -math.inf)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    corr = torch.exp2((m - m_new) * c)
                    p = torch.exp2(s * c - (m_new * c)[:, None])
                    l = l * corr + p.sum(dim=1)
                    hi = p.to(torch.bfloat16).float()
                    acc = acc * corr[:, None] + hi @ vt
                    if split:
                        lo = (p - hi).to(torch.bfloat16).float()
                        acc = acc + lo @ vt
                    m = m_new
                o = acc / torch.clamp(l, min=1e-30)[:, None]
                out[b, h, q0:q0 + TILE] = o[:min(TILE, S - q0)]
    return out.to(torch.bfloat16)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16)


def _serve_inputs(S, H=4, Hkv=1, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return _bf16(rng, 1, H, S, D), _bf16(rng, 1, Hkv, S, D), \
        _bf16(rng, 1, Hkv, S, D)


@pytest.fixture(scope="module")
def serve_case():
    """bf16 at the serve prefill's S 1,012 (4 heads over 1, D 64, causal):
    the plain version's output and the split and single-P emulations'."""
    q, k, v = _serve_inputs(1012)
    plain = flash_attention_plain(q, k, v, True)
    return plain, emulate(q, k, v), emulate(q, k, v, split=False)


def test_emulation_passes_the_card_check_at_serve_length(serve_case):
    plain, split, _ = serve_case
    check = _chip_smoke().attention_check(split, plain)
    assert check["within_tolerance"], check
    assert check["max_err_ratio"] > 0.5     # the check is not vacuous


def test_single_rounded_p_fails_the_card_check(serve_case):
    """P rounded once to bf16 before P V errs by up to 2^-9 of
    sum |p v| / l, far past the limit of outputs near zero (28.2 times the
    limit on these inputs, against 0.950 with the split P)."""
    plain, split, single = serve_case
    cs = _chip_smoke()
    ratio = cs.attention_check(single, plain)["max_err_ratio"]
    assert ratio > 10.0, ratio
    assert cs.attention_check(split, plain)["max_err_ratio"] <= 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_emulation_matches_the_pallas_kernel_and_oracle(causal):
    """S 1,024, 2 query heads over 1 KV head, D 64: the emulation against
    the JAX package's Pallas kernel (interpret mode; K/V expanded, as it
    has no GQA) and its oracle, within the reference's bf16 tolerance."""
    q, k, v = _serve_inputs(1024, H=2, Hkv=1, seed=1)
    got = emulate(q, k, v, causal).float().numpy()
    qj, kj, vj = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k.repeat_interleave(2, 1),
                            v.repeat_interleave(2, 1)))
    for ref in (ref_flash(qj, kj, vj, causal=causal, bq=128, bk=128),
                ref_flash_oracle(qj, kj, vj, causal=causal)):
        err = np.abs(np.asarray(ref.astype(jnp.float32)) - got).max()
        assert err < BF16_TOL, err


@pytest.mark.parametrize("S,causal", [(1, True), (37, True), (129, True),
                                      (200, False)])
def test_emulation_masks_the_ragged_edge(S, causal):
    """The S the card's checks add: one row, a partial tile, one row past
    a tile, and a non-causal ragged S."""
    q, k, v = _serve_inputs(S, H=2, Hkv=1, seed=S)
    plain = flash_attention_plain(q, k, v, causal)
    check = _chip_smoke().attention_check(emulate(q, k, v, causal), plain)
    assert check["within_tolerance"], check
