"""The port's embedding-bag kernel module against the JAX package, on the
CPU, where the wrapper takes its plain PyTorch version.

Same numpy inputs go through the reference's Pallas kernel (interpret
mode), its jnp oracle and the port.  Against the Pallas kernel the
tolerances are the reference's own (``tests/test_kernels.py``): f32
within 1e-5, bf16 within 5e-2.  The oracle in bf16 rounds every weighted
row and every partial sum to bf16, which at K = 100 moves the result by
more than 5e-2; the port (like the Pallas kernel) sums in f32 and rounds
once.  So the oracle runs in f32 over the same (bf16-valued) table, and
each bf16 element is held within one bf16 rounding of it,
``2^-8 * (|got| + |want|) + 1e-5``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.embedding_bag import embedding_bag_fixed as ref_bag
from repro.kernels.embedding_bag import embedding_bag_fixed_ref
from repro.sparse.embedding import embedding_lookup as ref_lookup

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.embedding_bag import (
    embedding_bag_fixed,
    embedding_bag_fixed_plain,
)
from repro_torch.kernels.embedding_bag.kernel import EMBEDDING_BAG
from repro_torch.sparse.embedding import embedding_lookup

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(V, D, B, K, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(V, D).astype(np.float32),
            rng.randint(0, V, (B, K)).astype(np.int32),
            rng.rand(B, K).astype(np.float32))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("V,D,B,K", [(64, 32, 4, 3), (256, 128, 16, 8),
                                     (1000, 64, 7, 1), (1000, 18, 4, 100),
                                     (50, 50, 3, 5)])
def test_plain_matches_reference(V, D, B, K, dtype):
    jd, td, tol = DTYPES[dtype]
    table, ids, w = _inputs(V, D, B, K)
    tj = jnp.asarray(table, jd)
    tt = torch.from_numpy(table).to(td)
    got = embedding_bag_fixed(tt, torch.from_numpy(ids), torch.from_numpy(w))
    assert got.shape == (B, D) and got.dtype == td
    pallas = ref_bag(tj, jnp.asarray(ids), jnp.asarray(w))
    assert np.abs(_f32(got) - _f32(pallas)).max() < tol
    g = _f32(got)
    o = _f32(embedding_bag_fixed_ref(tj.astype(jnp.float32), jnp.asarray(ids),
                                     jnp.asarray(w)))
    limit = tol if dtype == "f32" else 2.0 ** -8 * (np.abs(g) + np.abs(o)) + 1e-5
    assert np.all(np.abs(g - o) <= limit)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mean_mode_matches_reference_oracle(dtype):
    jd, td, tol = DTYPES[dtype]
    table, ids, w = _inputs(300, 24, 9, 6, seed=1)
    w[0] = 0.0   # an all-zero row divides by the 1e-9 floor
    got = embedding_bag_fixed_plain(torch.from_numpy(table).to(td),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(w), mode="mean")
    want = embedding_bag_fixed_ref(jnp.asarray(table, jd), jnp.asarray(ids),
                                   jnp.asarray(w), mode="mean")
    assert np.abs(_f32(got) - _f32(want)).max() < tol
    assert np.all(_f32(got)[0] == 0.0)
    with pytest.raises(ValueError):
        embedding_bag_fixed_plain(torch.from_numpy(table),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(w), mode="max")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_single_id_bags_equal_lookup(dtype):
    """K = 1 and weight 1 is the row itself, bit for bit: the port's bag
    equals the port's ``embedding_lookup`` and the reference's (over the
    f32 table, cast to the dtype), and the reference's Pallas bag."""
    jd, td, _ = DTYPES[dtype]
    table, ids, _ = _inputs(500, 128, 64, 1, seed=2)
    table_t = torch.from_numpy(table).to(td)
    ones = torch.ones(64, 1)
    got = embedding_bag_fixed(table_t, torch.from_numpy(ids), ones)
    assert torch.equal(got, embedding_lookup(table_t, torch.from_numpy(ids[:, 0]), td))
    ref = ref_lookup(jnp.asarray(table), jnp.asarray(ids[:, 0]), jd)
    assert np.array_equal(_f32(got), _f32(ref))
    pallas = ref_bag(jnp.asarray(table, jd), jnp.asarray(ids),
                     jnp.ones((64, 1), jnp.float32))
    assert np.array_equal(_f32(got), _f32(pallas))


def test_wrapper_rejects_bad_operands():
    table, ids, w = (torch.from_numpy(a) for a in _inputs(20, 8, 3, 2))
    ok = embedding_bag_fixed(table, ids, w)
    assert ok.shape == (3, 8)
    with pytest.raises(TypeError):
        embedding_bag_fixed(table.half(), ids, w)
    with pytest.raises(TypeError):
        embedding_bag_fixed(table, ids.long(), w)
    with pytest.raises(TypeError):
        embedding_bag_fixed(table, ids, w.double())
    with pytest.raises(ValueError):
        embedding_bag_fixed(table[None], ids, w)
    with pytest.raises(ValueError):
        embedding_bag_fixed(table, ids[:, 0], w[:, 0])
    with pytest.raises(ValueError):
        embedding_bag_fixed(table, ids, w[:, :1])
    with pytest.raises(ValueError):
        embedding_bag_fixed(table.t().contiguous().t(), ids, w)
    with pytest.raises(ValueError, match="several devices"):
        embedding_bag_fixed(table, ids.to("meta"), w)


# ------------------------------------------------- the card's tolerance --
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_bag_check_passes_reordering_and_catches_a_neighbouring_row(dtype):
    """``chip_smoke.bag_check`` at DLRM's width and kernel_bench's K: the
    plain version against the same sums taken in float64 in reverse
    order passes; against a kernel that read, in one bag, the row next to
    one of its ids it fails."""
    check = _chip_smoke().bag_check
    gen = torch.Generator().manual_seed(0)
    V, D, B, K = 5000, 128, 256, 8
    table = (torch.randn(V, D, generator=gen) * 0.02).to(dtype)
    ids = torch.randint(0, V - 1, (B, K), generator=gen, dtype=torch.int32)
    w = torch.rand(B, K, generator=gen)
    plain = embedding_bag_fixed_plain(table, ids, w)
    rows = table[ids.long()].double() * w[..., None].double()
    reordered = rows.flip(1).sum(1).to(dtype)
    shifted = ids.clone()
    shifted[17, 3] += 1
    neighbour = embedding_bag_fixed_plain(table, shifted, w)
    assert check(reordered, plain)["within_tolerance"]
    assert not check(neighbour, plain)["within_tolerance"]


def test_embedding_bag_kernel_registered_for_the_build():
    assert "embedding_bag.cu" in {s.name for s in cuda_lib.sources()}
    assert EMBEDDING_BAG.replaces == "src/repro/kernels/embedding_bag/kernel.py:40"
    assert (cuda_lib.REPO_ROOT / EMBEDDING_BAG.source).exists()
    assert EMBEDDING_BAG.launches == 0   # the CPU never launches it
