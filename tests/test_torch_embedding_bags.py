"""The port's grouped embedding bag (``embedding_bags``, one launch for
many tables, and DLRM's forward through it) on the CPU, where the
wrapper takes its plain version.

The grouped plain version is held bit for bit to the per-table plain
version (dtypes, K, shared and per-table weights, both id rules with
out-of-range ids, strided slots, output dtypes), each table to the
reference's Pallas kernel in interpret mode (the reference's tolerances,
``tests/test_kernels.py``: f32 within 1e-5, bf16 within 5e-2), and
``dlrm_forward``'s scores and gradients to the per-table forward of the
earlier design (``chip_smoke.dlrm_forward_per_table``) bit for bit and
to the reference's ``dlrm_forward`` within 1e-5 in f32.  A numpy
emulation of ``csrc/embedding_bag.cu``'s map of blocks, lanes, bags and
steps shows every (table, bag, chunk) written once with its slots added
in order, and the ``CudaKernel``'s argtypes are held to the C signature.
"""

import ctypes
import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_bundle as ref_bundle
from repro.kernels.embedding_bag import embedding_bag_fixed as ref_bag
from repro.models import recsys as ref_rs

from repro_torch.configs.registry import get_serving, get_training
from repro_torch.convert import recsys_params_from_jax
from repro_torch.kernels.embedding_bag import (
    embedding_bag_fixed,
    embedding_bag_fixed_plain,
    embedding_bags,
    embedding_bags_plain,
)
from repro_torch.kernels.embedding_bag.kernel import EMBEDDING_BAG, MAX_TABLES
from repro_torch.models import recsys as port_rs
from repro_torch.tree import flatten_with_path, leaves, path_name, tree_map
from torch_threads import one_torch_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / EMBEDDING_BAG.source
ROWS = (50, 7, 300)   # three tables of different lengths
TDTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tables(dtype, D=16, rows=ROWS, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(V, D).astype(np.float32)).to(dtype)
            for V in rows]


def _ids(B, K, rows=ROWS, seed=1, bad=False) -> torch.Tensor:
    """(T, B, K) int32 ids, with every 7th id of each table replaced in
    turn by V, -1, -V, -V-1 and 2^31-1 where ``bad``."""
    rng = np.random.RandomState(seed)
    ids = np.stack([rng.randint(0, V, (B, K)) for V in rows]).astype(np.int64)
    if bad:
        for t, V in enumerate(rows):
            flat = ids[t].reshape(-1)
            for i, pos in enumerate(range(0, flat.size, 7)):
                flat[pos] = (V, -1, -V, -V - 1, 2**31 - 1)[i % 5]
    return torch.from_numpy(ids.astype(np.int32))


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bits but for NaN's own, NaN in the same places."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    return (got.dtype == want.dtype and torch.equal(nan_g, nan_w)
            and torch.equal(torch.where(nan_g, 0, got),
                            torch.where(nan_w, 0, want)))


# ------------------------------------------------- grouped vs per table --
@pytest.mark.parametrize("rule", ["clip", "fill"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_table"])
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grouped_equals_per_table_plain(dtype, K, shared, rule):
    """Slot t of one grouped call is ``embedding_bag_fixed_plain`` of
    table t, bit for bit, NaN in the same places; out-of-range ids
    among them under either rule."""
    tables = _tables(TDTYPES[dtype])
    B, T = 40, len(tables)
    ids = _ids(B, K, bad=True)
    rng = np.random.RandomState(2)
    w = (torch.from_numpy(rng.rand(1, B, K).astype(np.float32)).expand(T, B, K)
         if shared else torch.from_numpy(rng.rand(T, B, K).astype(np.float32)))
    got = embedding_bags(tables, ids, w, rule)
    assert got.shape == (B, T, 16) and got.dtype == TDTYPES[dtype]
    for t in range(T):
        want = embedding_bag_fixed_plain(tables[t], ids[t], w[t], id_rule=rule)
        assert _same(got[:, t], want), t
    assert bool(torch.isnan(got).any()) == (rule == "fill")


@pytest.mark.parametrize("table_dt,out_dt", [("bf16", "f32"), ("f32", "bf16"),
                                             ("bf16", "bf16")])
def test_strided_slots_and_output_dtype(table_dt, out_dt):
    """Ids a transposed (B, T) matrix (no copy), weight 1 shared by a
    stride of 0, bags written into slots 1..T of a (B, T + 1, D) result
    in another dtype than the tables': each slot equals the one-table
    bag cast to that dtype, bit for bit, and slot 0 is ``head`` converted;
    the plain version given ``out`` leaves the slot before untouched."""
    tables = _tables(TDTYPES[table_dt])
    B, T, D = 33, len(tables), 16
    sparse = _ids(B, 1, bad=True)[..., 0].t().contiguous()      # (B, T)
    ids = sparse.t()[..., None]
    assert ids.stride() == (1, T, 1)
    w = torch.ones((1, 1, 1)).expand(T, B, 1)
    head = torch.randn(B, D, generator=torch.Generator().manual_seed(3))
    od = TDTYPES[out_dt]
    got = embedding_bags(tables, ids, w, "fill", dtype=od, head=head)
    assert got.shape == (B, T + 1, D) and got.dtype == od
    assert torch.equal(got[:, 0], head.to(od))
    for t in range(T):
        want = embedding_bag_fixed(tables[t], ids[t], w[t], id_rule="fill")
        assert _same(got[:, t + 1], want.to(od)), t
    buf = torch.full((B, T + 1, D), 7.0, dtype=od)
    embedding_bags_plain(tables, ids, w, "fill", out=buf[:, 1:])
    assert torch.equal(buf[:, 0], torch.full((B, D), 7.0, dtype=od))
    assert _same(buf, torch.cat([buf[:, :1], got[:, 1:]], 1))
    assert EMBEDDING_BAG.launches == 0   # the CPU never launches the kernel


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_each_table_matches_the_pallas_kernel(dtype):
    """Each slot of a grouped call against the reference's Pallas
    ``embedding_bag_kernel`` (interpret mode) on that table: V 64, D 16,
    B 8, T 3, K 4 (its clip rule)."""
    jd, tol = {"f32": (jnp.float32, 1e-5), "bf16": (jnp.bfloat16, 5e-2)}[dtype]
    rows = (64, 64, 64)
    rng = np.random.RandomState(4)
    tables = [rng.randn(64, 16).astype(np.float32) for _ in rows]
    ids = _ids(8, 4, rows=rows, seed=5)
    w = rng.rand(3, 8, 4).astype(np.float32)
    got = embedding_bags([torch.from_numpy(t).to(TDTYPES[dtype])
                          for t in tables], ids, torch.from_numpy(w))
    for t in range(3):
        want = ref_bag(jnp.asarray(tables[t], jd), jnp.asarray(ids[t].numpy()),
                       jnp.asarray(w[t]))
        err = np.abs(got[:, t].float().numpy()
                     - np.asarray(jnp.asarray(want, jnp.float32))).max()
        assert err < tol, (t, err)


def test_wrapper_rejects_bad_operands():
    tables = _tables(torch.float32)
    ids = _ids(5, 2)
    w = torch.ones(3, 5, 2)
    assert embedding_bags(tables, ids, w).shape == (5, 3, 16)
    with pytest.raises(ValueError, match="tables a launch"):
        embedding_bags([tables[0]] * (MAX_TABLES + 1),
                       ids[:1].expand(MAX_TABLES + 1, 5, 2),
                       w[:1].expand(MAX_TABLES + 1, 5, 2))
    with pytest.raises(ValueError, match="tables\\[1\\]"):
        embedding_bags([tables[0], tables[1].bfloat16(), tables[2]], ids, w)
    with pytest.raises(ValueError, match="tables\\[2\\]"):
        embedding_bags(tables[:2] + [tables[2][:, :8]], ids, w)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bags(tables[:2] + [tables[2].t().contiguous().t()], ids, w)
    with pytest.raises(TypeError):
        embedding_bags(tables, ids.long(), w)
    with pytest.raises(TypeError):
        embedding_bags(tables, ids, w.double())
    with pytest.raises(ValueError):
        embedding_bags(tables, ids[:2], w[:2])
    with pytest.raises(ValueError):
        embedding_bags(tables, ids, w[:, :, :1])
    with pytest.raises(ValueError, match="head"):
        embedding_bags(tables, ids, w, head=torch.zeros(5, 8))
    with pytest.raises(TypeError):
        embedding_bags(tables, ids, w, dtype=torch.float16)
    with pytest.raises(ValueError, match="id_rule"):
        embedding_bags(tables, ids, w, "wrap")
    with pytest.raises(ValueError, match="several devices"):
        embedding_bags(tables, ids.to("meta"), w)
    with pytest.raises(ValueError, match="no gradient of its weights"):
        embedding_bags(tables, ids, w.clone().requires_grad_(True))


# ------------------------------------------------------------------ DLRM --
def _dlrm(masters: bool, dtype: torch.dtype):
    tr = get_training("dlrm-mlperf", reduced=True)
    cfg = dataclasses.replace(tr.config, dtype=dtype)
    params = tr.init(cfg, torch.Generator().manual_seed(0), masters=masters)
    cs = _chip_smoke()
    batch = cs.train_batch(cfg, 48, 6, torch.device("cpu"))
    return cfg, params, batch, cs


@pytest.mark.parametrize("masters,dtype", [
    (True, torch.bfloat16), (False, torch.bfloat16), (False, torch.float32)],
    ids=["f32_masters_bf16", "bf16", "f32"])
def test_dlrm_forward_and_gradients_equal_the_per_table_forward(masters,
                                                                dtype):
    """REDUCED DLRM: the scores and the gradients of every parameter
    (tables, both MLPs) through the grouped ``Function`` equal, bit for
    bit, those through one per-table ``Function`` a table and the stack
    of the earlier design, in the three layouts the port runs: f32
    masters under a bf16 forward (training), and tables held in the
    config's dtype (serving), bf16 and f32."""
    cfg, params, batch, cs = _dlrm(masters, dtype)
    runs = []
    for forward in (port_rs.dlrm_forward, cs.dlrm_forward_per_table):
        p = tree_map(lambda v: v.detach().requires_grad_(True), params)
        names = [path_name(n) for n, _ in flatten_with_path(p)]
        scores = forward(cfg, p, batch)
        loss = port_rs.bce_logits(scores, batch["label"])
        grads = torch.autograd.grad(loss, leaves(p))
        runs.append((scores.detach(), dict(zip(names, grads))))
    (s_new, g_new), (s_old, g_old) = runs
    assert torch.equal(s_new, s_old)
    assert g_new.keys() == g_old.keys()
    for name in g_new:
        assert torch.equal(g_new[name], g_old[name]), name
    assert all(bool(g.any()) for n, g in g_new.items() if "tables" in n)


def test_dlrm_forward_matches_reference_in_f32():
    """The grouped forward's scores against the reference's
    ``dlrm_forward`` on the same weights and batch, within 1e-5
    (``tests/test_torch_recsys.py``'s f32 tolerance)."""
    rb = ref_bundle("dlrm-mlperf", reduced=True)
    rcfg = dataclasses.replace(rb.config, dtype=jnp.float32)
    rparams = rb.init(jax.random.PRNGKey(0))
    sv = get_serving("dlrm-mlperf", reduced=True)
    pcfg = dataclasses.replace(sv.config, dtype=torch.float32)
    pparams = recsys_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    rng = np.random.RandomState(9)
    dense = rng.rand(24, rcfg.n_dense).astype(np.float32)
    sparse = np.stack([rng.randint(0, r, 24) for r in rcfg.table_rows],
                      1).astype(np.int32)
    want = jax.jit(ref_rs.dlrm_forward, static_argnums=0)(
        rcfg, rparams, {"dense": jnp.asarray(dense),
                        "sparse": jnp.asarray(sparse)})
    got = port_rs.dlrm_forward(pcfg, pparams, {
        "dense": torch.from_numpy(dense), "sparse": torch.from_numpy(sparse)})
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


# ------------------------------------------- the kernel's map, emulated --
def _constants() -> dict:
    """The source's block size and table limit, and its rule for the row
    loads a lane issues at once: ``(vb >= wide) ? wide_rows : rows``."""
    text = SOURCE.read_text()
    out = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
           for name in ("kThreads", "kMaxTables")}
    m = re.search(r"rows_a_step\(int vb\) \{\s*return vb >= (\d+) \? (\d+) : "
                  r"(\d+);\s*\}", text)
    wide, wide_rows, rows = map(int, m.groups())
    out["rows"] = lambda vb: wide_rows if vb >= wide else rows
    return out


def _load_bytes(D: int, tsize: int, osize: int, out_strides) -> int:
    """``by_width``: the widest row load the row width (tables aligned,
    as the allocator gives them) and the output's strides allow."""
    row, out = D * tsize, 0
    for st in out_strides:
        out |= st * osize
    for vb in (16, 8, 4, 2):
        store = vb * osize // tsize
        if vb >= tsize and row % vb == 0 and out % min(store, 16) == 0:
            return vb
    raise AssertionError("no load width")


def _emulate(T: int, B: int, K: int, D: int, tsize: int, osize: int,
             out_strides) -> tuple:
    """The kernel's launch and walk in numpy: how many times each
    (table, bag, chunk) is stored, and the (bag, slot) items in the order
    a lane group's rounds and steps add them."""
    c = _constants()
    vb = _load_bytes(D, tsize, osize, out_strides)
    threads, rows = c["kThreads"], c["rows"](vb)
    warps = threads // 32
    vec = vb // tsize
    chunks = D // vec
    G = min(chunks, 32)
    P = 32 // G
    R = G if G < rows else G - G % rows   # items a round
    nb = R if K == 0 else (R // K if K <= R else 1)
    blocks = -(-B // (warps * P * nb)) * T
    bid = np.repeat(np.arange(blocks), threads)
    tid = np.tile(np.arange(threads), blocks)
    lane = tid % 32
    s = lane // G
    t = bid % T
    first = (bid // T * warps + tid // 32) * P * nb + s
    busy = lane < P * G
    left = np.where(first < B, (B - first + P - 1) // P, 0)
    bags = np.minimum(left, nb)               # the group's bags below B
    # rounds of R items (one id a lane), steps of kRows rows; a bag is
    # stored at its last slot, its sum restarted at its first
    order, items = [], nb * K
    for i0 in range(0, items, R):
        n = min(R, items - i0)
        j, k = divmod(i0, K)
        for u0 in range(0, n, rows):
            for u in range(rows):
                if u0 + u < n:
                    order.append((j, k))
                k += 1
                if k == K:
                    k, j = 0, j + 1
    stored = range(nb) if K == 0 else [j for j, k in order if k == K - 1]
    writes = np.zeros((T, B, chunks), np.int64)
    for c0 in range(0, chunks, G):
        chunk = lane - s * G + c0
        ok = busy & (chunk < chunks)
        for j in stored:
            m = ok & (j < bags)
            np.add.at(writes, (t[m], (first + j * P)[m], chunk[m]), 1)
    return writes, order, {"G": G, "P": P, "nb": nb, "chunks": chunks}


@pytest.mark.parametrize("T,B,K,D,tsize,osize,busy", [
    (26, 1000, 1, 18, 2, 4, 27),     # D 18 bf16 into the f32 interaction
    (26, 1000, 1, 18, 4, 4, 27),     # D 18 f32: 8-byte loads
    (26, 1000, 1, 128, 2, 4, 32),    # DLRM serving: bf16 into f32
    (26, 1000, 1, 128, 4, 2, 32),    # DLRM training: f32 masters into bf16
    (3, 517, 100, 18, 2, 2, 27),     # DIN's K in one step of 8 a time
    (3, 300, 3, 128, 4, 4, 32),      # K 3: two bags a lane group
    (2, 70, 5, 200, 4, 4, 32),       # 50 chunks: a second round of lanes
    (2, 40, 0, 128, 2, 2, 32),       # K 0: zero bags, stored once
])
def test_kernel_map_writes_each_bag_chunk_once_in_order(T, B, K, D, tsize,
                                                        osize, busy):
    """Every (table, bag, chunk) of the output is stored exactly once,
    for B not a multiple of the bags a block holds, and each lane
    group's items walk bag by bag with slots k = 0..K-1 in order (the
    sum's order the plain version takes); D 18 in bf16 keeps 27 of 32
    lanes busy (3 bags of 9 chunks)."""
    out_strides = (D, (T + 1) * D)       # slots 1..T of (B, T + 1, D)
    writes, order, geo = _emulate(T, B, K, D, tsize, osize, out_strides)
    assert (writes == 1).all()
    assert order == [(j, k) for j in range(geo["nb"]) for k in range(K)]
    assert geo["P"] * min(geo["G"], geo["chunks"]) == busy
    c = _constants()
    assert B % (c["kThreads"] // 32 * geo["P"] * geo["nb"]) != 0
    assert c["kMaxTables"] == MAX_TABLES


# ------------------------------------------------- the C interface --
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong}


def test_argtypes_match_the_c_signature():
    text = SOURCE.read_text()
    m = re.search(r'extern "C" int ' + EMBEDDING_BAG.symbol +
                  r"\((.*?)\)\s*\{", text, re.S)
    assert m and text.count('extern "C"') == 1   # one grouped C entry
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
             for p in params]
    assert params[-1] == "void* stream"
    assert EMBEDDING_BAG.argtypes == types[:-1]


# ---------------------------------------- the card's bound, counted --
def test_bag_bytes_count_each_distinct_row_once():
    """``chip_smoke.bag_bytes``: a row read by several bags counts once
    a table; under fill an id that reads a NaN row reads none; ids, the
    weights and the output as given."""
    cs = _chip_smoke()
    tables = [torch.zeros(10, 4), torch.zeros(3, 4, dtype=torch.bfloat16)]
    ids = torch.tensor([[[1], [1], [2], [12]], [[0], [0], [-1], [5]]],
                       dtype=torch.int32)                       # (2, 4, 1)
    # clip: t0 reads rows 1, 2, 9; t1 rows 0, 2 (-1 wraps, 5 clamps)
    assert cs.bag_bytes(tables, ids, "clip", 4, 100) == \
        3 * 16 + 2 * 8 + 8 * 4 + 4 + 100
    # fill: 12 and 5 read no row; -1 wraps to 2
    assert cs.bag_bytes(tables, ids, "fill", 0, 0) == 2 * 16 + 2 * 8 + 8 * 4
