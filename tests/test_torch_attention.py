"""The port's attention kernels and layers against the JAX package, on the
CPU.

The same numpy inputs, made from a seed, go through the reference (the
Pallas kernels in interpret mode, their jnp oracles, ``models.attention``
and ``nn.layers``) and through the port (the plain PyTorch versions its
kernel wrappers take for CPU tensors).  Tolerances are the reference's
kernel tests': 2e-5 in f32 and 2e-2 in bf16, where the two sides round
bf16 at different places (the port's kernels keep ``p @ v`` in f32 and
round once).
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
from repro.kernels.paged_attention.ops import paged_attention as ref_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as ref_paged_oracle
from repro.models import attention as ref_att
from repro.nn import layers as ref_layers

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.kernel import FLASH_ATTENTION
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
from repro_torch.kernels.paged_attention.kernel import PAGED_ATTENTION
from repro_torch.models import attention as port_att
from repro_torch.nn import layers as port_layers
from torch_threads import one_torch_thread  # noqa: F401,E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounded once, by JAX, and carried across as f32)."""
    jd, td, _ = DTYPES[dtype]
    j = jnp.asarray(x, jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j.astype(jnp.float32))
                        - t.float().numpy()).max())


# ------------------------------------------------------------------ flash --
@pytest.mark.parametrize(
    "B,H,S,D,bq,bk,causal",
    [
        (1, 1, 64, 32, 32, 32, True),
        (2, 3, 128, 64, 64, 32, True),
        (1, 2, 256, 128, 128, 128, True),
        (2, 1, 128, 16, 128, 64, True),
        (1, 2, 128, 32, 64, 64, False),
        (2, 2, 100, 16, 100, 100, True),    # no tile multiple for the port
        (1, 2, 100, 16, 100, 100, False),
    ],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_matches_reference(B, H, S, D, bq, bk, causal, dtype):
    rng = np.random.RandomState(B * 1000 + S + D)
    tol = DTYPES[dtype][2]
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.randn(B, H, S, D), dtype) for _ in range(3))
    got = flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == (B, H, S, D)
    assert torch.equal(got, flash_attention_plain(qt, kt, vt, causal))
    assert _err(ref_flash(qj, kj, vj, causal=causal, bq=bq, bk=bk), got) < tol
    assert _err(ref_flash_oracle(qj, kj, vj, causal=causal), got) < tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_gqa_reads_kv_head_of_group(dtype):
    """K/V with fewer heads: head h reads KV head h // G, as the reference's
    expand_kv lays them out."""
    rng = np.random.RandomState(11)
    B, H, Hkv, S, D = 2, 8, 2, 72, 16
    (qj, qt) = _pair(rng.randn(B, H, S, D), dtype)
    (kj, kt), (vj, vt) = (_pair(rng.randn(B, Hkv, S, D), dtype)
                          for _ in range(2))
    want = ref_flash_oracle(qj, jnp.repeat(kj, H // Hkv, axis=1),
                            jnp.repeat(vj, H // Hkv, axis=1))
    assert _err(want, flash_attention(qt, kt, vt)) < DTYPES[dtype][2]


def test_flash_takes_strided_views():
    """(B, S, H, D) tensors seen as (B, H, S, D) views, as the model
    passes them."""
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(2, 40, 4, 16).astype(np.float32))
               for _ in range(3))
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2))
    want = flash_attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)))
    assert torch.allclose(got, want, atol=1e-6)


def test_flash_rejects_bad_operands():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q)


# ------------------------------------------------------------------ paged --
def _paged_case(rng, B, H, D, page, n_pages, max_pages, dtype, table=None,
                lens=None):
    (qj, qt) = _pair(rng.randn(B, H, D), dtype)
    (kj, kt), (vj, vt) = (_pair(rng.randn(n_pages, page, D), dtype)
                          for _ in range(2))
    bt = (rng.choice(n_pages, size=(B, max_pages)) if table is None
          else table).astype(np.int32)
    ln = (rng.randint(1, max_pages * page + 1, size=B) if lens is None
          else lens).astype(np.int32)
    ref_args = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln))
    port_args = (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(ln))
    return ref_args, port_args


def _check_paged(ref_args, port_args, dtype):
    tol = DTYPES[dtype][2]
    got = paged_attention(*port_args)
    assert got.dtype == port_args[0].dtype
    assert torch.equal(got, paged_attention_plain(*port_args))
    assert _err(ref_paged(*ref_args), got) < tol
    assert _err(ref_paged_oracle(*ref_args), got) < tol


@pytest.mark.parametrize(
    "B,H,D,page,n_pages,max_pages",
    [(2, 4, 32, 16, 12, 4), (3, 8, 64, 8, 30, 7), (1, 2, 128, 32, 6, 3)],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_plain_matches_reference(B, H, D, page, n_pages, max_pages,
                                       dtype):
    rng = np.random.RandomState(B * 100 + D)
    _check_paged(*_paged_case(rng, B, H, D, page, n_pages, max_pages, dtype),
                 dtype)


@pytest.mark.parametrize("max_pages", [2, 5, 9])
def test_paged_chain_limit_semantics(max_pages):
    """max_pages bounds the indirections per read — the CH chain-limit
    invariant carried onto the device (paper 5.7.3)."""
    rng = np.random.RandomState(max_pages)
    B, H, D, page = 2, 2, 32, 16
    table = np.arange(B * max_pages).reshape(B, max_pages)
    lens = np.full((B,), max_pages * page)
    _check_paged(*_paged_case(rng, B, H, D, page, B * max_pages, max_pages,
                              "f32", table=table, lens=lens), "f32")


def test_paged_empty_row_reads_nothing():
    """A row of length 0: the Pallas kernel skips every page and writes
    zeros; so do the port's kernel and its plain version."""
    rng = np.random.RandomState(50)
    ref_args, port_args = _paged_case(rng, 3, 2, 16, 8, 10, 4, "f32",
                                      lens=np.array([0, 5, 32]))
    got = paged_attention(*port_args)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert _err(ref_paged(*ref_args), got) < 2e-5


def test_paged_rejects_bad_operands():
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(6, 8, 16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError):
        paged_attention(q, pool, pool, table.long(),
                        torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        paged_attention(q, pool, pool, table, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        paged_attention(q, torch.zeros(6, 8, 8), torch.zeros(6, 8, 8), table,
                        torch.ones(2, dtype=torch.int32))


# ------------------------------------------------------- model attention --
@pytest.mark.parametrize("s_max", [48, 40])   # 40: pool pages of gcd(40, 16)
@pytest.mark.parametrize("n_kv", [1, 2, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_through_slot_pool(n_kv, dtype, s_max):
    """GQA (G = 8 // n_kv, G = 4 at n_kv = 2) with ragged lengths: the
    reference's decode_attention against the port's, which views the
    cache as a page pool and makes one paged-kernel call."""
    rng = np.random.RandomState(20 + n_kv + s_max)
    B, H, D = 3, 8, 16
    (qj, qt) = _pair(rng.randn(B, 1, H, D), dtype)
    (kj, kt), (vj, vt) = (_pair(rng.randn(B, s_max, n_kv, D), dtype)
                          for _ in range(2))
    lens = np.array([1, 17, s_max], np.int32)
    want = ref_att.decode_attention(qj, kj, vj, jnp.asarray(lens))
    got = port_att.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert got.shape == (B, 1, H, D) and got.dtype == qt.dtype
    assert _err(want, got) < DTYPES[dtype][2]


@pytest.mark.parametrize("n_kv", [2, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_attention_and_mha(n_kv, dtype):
    """The reference's ``attention`` (``mha`` below its threshold) against
    the port's flash-backed ``attention`` and its plain ``mha``."""
    rng = np.random.RandomState(30 + n_kv)
    B, S, H, D = 2, 37, 8, 16
    (qj, qt) = _pair(rng.randn(B, S, H, D), dtype)
    (kj, kt), (vj, vt) = (_pair(rng.randn(B, S, n_kv, D), dtype)
                          for _ in range(2))
    want = ref_att.attention(qj, kj, vj, causal=True)
    tol = DTYPES[dtype][2]
    assert _err(want, port_att.attention(qt, kt, vt, causal=True)) < tol
    assert _err(ref_att.mha(qj, kj, vj), port_att.mha(qt, kt, vt)) < tol
    assert _err(ref_att.expand_kv(kj, H), port_att.expand_kv(kt, H)) == 0.0


# ---------------------------------------------------------------- layers --
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.RandomState(40)
    (xj, xt) = _pair(rng.randn(2, 5, 4, 16), dtype)
    gj = jnp.asarray(rng.rand(16) + 0.5, jnp.float32)
    gt = torch.from_numpy(np.array(gj))
    got = port_layers.rms_norm(gt, xt)
    assert got.dtype == xt.dtype
    assert _err(ref_layers.rms_norm(gj, xj), got) < DTYPES[dtype][2]
    pos = rng.randint(0, 500, (2, 5))
    got = port_layers.rope(xt, torch.from_numpy(pos), 10_000.0)
    assert got.dtype == xt.dtype
    assert _err(ref_layers.rope(xj, jnp.asarray(pos), 10_000.0), got) \
        < DTYPES[dtype][2]


def test_initialisers_follow_the_generator():
    gen = torch.Generator().manual_seed(3)
    p = port_layers.dense_init(gen, 64, 32, bias=True)
    assert p["w"].shape == (64, 32) and p["b"].shape == (32,)
    assert abs(float(p["w"].std()) - 1 / 8) < 0.02
    again = port_layers.dense_init(torch.Generator().manual_seed(3), 64, 32)
    assert torch.equal(p["w"], again["w"])
    emb = port_layers.embedding_init(gen, 100, 8)["table"]
    assert emb.shape == (100, 8) and abs(float(emb.std()) - 0.02) < 0.005


# ------------------------------------------------- the card's tolerance --
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_check_passes_reordering_and_catches_a_dropped_tail(dtype):
    """``chip_smoke.attention_check`` at a decode shape of 4,096 tokens a
    row, where outputs are about 0.02 in size: the plain version against
    the same function summed in another order (float64) passes; against a
    kernel that skips the last 16 tokens of each row it fails, though that
    fault stays within a fixed 2e-2."""
    check = _chip_smoke().attention_check
    gen = torch.Generator().manual_seed(0)
    R, G, D, page, P = 4, 4, 64, 16, 256
    q = torch.randn(R, G, D, generator=gen).to(dtype)
    kp, vp = (torch.randn(R * P, page, D, generator=gen).to(dtype)
              for _ in range(2))
    table = torch.randperm(R * P, generator=gen).to(torch.int32).reshape(R, P)
    lens = torch.full((R,), P * page, dtype=torch.int32)
    plain = paged_attention_plain(q, kp, vp, table, lens)
    k = kp[table.long()].reshape(R, P * page, D).double()
    v = vp[table.long()].reshape(R, P * page, D).double()
    s = torch.einsum("bhd,btd->bht", q.double(), k) / math.sqrt(D)
    reordered = (torch.softmax(s, -1) @ v).to(dtype)
    dropped = (torch.softmax(s[..., :-16], -1) @ v[:, :-16]).to(dtype)
    assert check(reordered, plain)["within_tolerance"]
    assert not check(dropped, plain)["within_tolerance"]
    assert float((dropped.float() - plain.float()).abs().max()) < 2e-2


# ----------------------------------------------------------------- build --
def test_attention_kernels_registered_for_the_build():
    names = {s.name for s in cuda_lib.sources()}
    assert {"flash_attention.cu", "paged_attention.cu"} <= names
    assert FLASH_ATTENTION.replaces == "src/repro/kernels/flash_attention/kernel.py:73"
    assert PAGED_ATTENTION.replaces == "src/repro/kernels/paged_attention/kernel.py:75"
    for k in (FLASH_ATTENTION, PAGED_ATTENTION):
        assert (cuda_lib.REPO_ROOT / k.source).exists()
