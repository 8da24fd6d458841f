"""The paged kernel's split-KV design, on the CPU.

``paged_split`` picks the pages a block covers from static shapes; the
CUDA kernel (``csrc/paged_attention.cu``) computes each split's softmax
state (m, l, acc) in f32 and the last block of a row combines them in
split order.  That arithmetic is emulated here in f32 and held against
the plain version (the card's element-wise check) and against the
reference's Pallas kernel (interpret mode) and oracle, on the same inputs
made from a seed with numpy, at the tolerances of
``tests/test_torch_attention.py``.

The log-sum-exp the kernel writes on request: the plain version's against
``torch.logsumexp`` of the masked scores, the kernel's arithmetic
against it, the value of a row of length 0; and the merge of a cache's
sequence blocks by it (``tensor_parallel.merge_attention_blocks``, and
``merge_attention_partials`` over a one-rank gloo group) against the
whole cache."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention.ops import paged_attention as ref_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as ref_oracle

from repro_torch.distributed.tensor_parallel import merge_attention_blocks
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
from repro_torch.kernels.paged_attention.kernel import (
    BLOCKS_PER_SM,
    MAX_SPLIT_PAGES,
    MIN_SPLIT_TOKENS,
    SMS,
    head_group,
    paged_split,
)
from repro_torch.kernels.paged_attention.ref import LSE_EMPTY
from repro_torch.models.attention import slot_decode_attention, slot_page
from torch_threads import one_torch_thread  # noqa: F401,E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(x: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    j = jnp.asarray(x, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j.astype(jnp.float32))
                        - t.float().numpy()).max())


# ------------------------------------------------------------ split rule --
def test_split_rule_at_serve_and_deployment_shapes():
    """granite-3-2b's decode launch: 16 slots x 8 KV heads = 128 rows of
    4 query heads over 256 pages of 16 tokens (the serve phase's and the
    deployment check's static shapes are the same)."""
    pages = paged_split(128, 4, 256, 16)
    splits = -(-256 // pages)
    blocks = 128 * -(-4 // head_group(4)) * splits
    assert pages * 16 >= MIN_SPLIT_TOKENS
    assert blocks >= 4 * SMS          # several blocks resident on each SM
    assert blocks <= 2 * BLOCKS_PER_SM * SMS
    assert (pages, splits) == (16, 16)


@pytest.mark.parametrize("B,H,max_pages,page", [
    (2 * 8, 4, 4, 16),      # reduced granite: 2 slots, S_max 64
    (3 * 2, 4, 3, 16),      # a reduced config with 2 KV heads
    (1, 32, 512, 16),       # one slot of 8,192 tokens, 32 heads over one
    (4, 1, 1, 16),          # one page a row
    (64, 8, 2048, 1),       # pages of one token (gcd of S_max and 16)
])
def test_split_rule_at_reduced_shapes(B, H, max_pages, page):
    pages = paged_split(B, H, max_pages, page)
    assert 1 <= pages <= min(max_pages, MAX_SPLIT_PAGES)
    assert pages == max_pages or pages * page >= MIN_SPLIT_TOKENS
    if max_pages * page <= MIN_SPLIT_TOKENS:
        assert pages == max_pages    # a short row is one split
    assert head_group(H) in (1, 2, 4, 8) and head_group(H) >= min(H, 8)


# -------------------------------------------------- split and combine --
def _emulate(q, kp, vp, table, lengths, pages):
    """The kernel's arithmetic in f32: per split of ``pages`` pages the
    state (m, l, acc) over its tokens below the length; a row of one
    split divides; several are merged into a running state in split
    order, as the last block merges them; an empty row yields zeros."""
    B, H, D = q.shape
    page, max_pages = kp.shape[1], table.shape[1]
    out = torch.zeros(B, H, D, dtype=torch.float32)
    span = pages * page
    for b in range(B):
        n = max(0, min(int(lengths[b]), max_pages * page))
        active = -(-n // span)
        states = []
        for s in range(active):
            t = torch.arange(s * span, min(n, (s + 1) * span))
            ids = table[b, t // page].long()
            k = kp[ids, t % page].float()
            v = vp[ids, t % page].float()
            sc = (q[b].float() @ k.T) * (1.0 / math.sqrt(D))
            m = sc.max(dim=1).values
            p = torch.exp(sc - m[:, None])
            states.append((m, p.sum(dim=1), p @ v))
        if active == 1:
            m, l, acc = states[0]
            out[b] = acc / l.clamp_min(1e-30)[:, None]
        elif active > 1:
            mx = torch.full((H,), -1e30)
            num = torch.zeros(H, D)
            den = torch.zeros(H)
            for m, l, acc in states:       # merged in split order
                mn = torch.maximum(mx, m)
                a, w = torch.exp(mx - mn), torch.exp(m - mn)
                den = den * a + l * w
                num = num * a[:, None] + acc * w[:, None]
                mx = mn
            out[b] = num / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _case(rng, B, H, D, page, max_pages, lens, dtype, table=None):
    n_pages = B * max_pages
    (qj, qt) = _pair(rng.randn(B, H, D), dtype)
    (kj, kt), (vj, vt) = (_pair(rng.randn(n_pages, page, D), dtype)
                          for _ in range(2))
    bt = (rng.permutation(n_pages).reshape(B, max_pages) if table is None
          else table).astype(np.int32)
    ln = np.asarray(lens, np.int32)
    ref_args = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln))
    port_args = (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(ln))
    return ref_args, port_args


def _check(ref_args, port_args, dtype, pages):
    got = _emulate(*port_args, pages)
    plain = paged_attention_plain(*port_args)
    assert torch.equal(paged_attention(*port_args), plain)
    check = _chip_smoke().attention_check(got, plain)
    assert check["within_tolerance"], check
    tol = DTYPES[dtype][2]
    assert _err(ref_paged(*ref_args), got) < tol
    # the jnp oracle averages a row of length 0; both kernels write zeros
    rows = np.flatnonzero(np.asarray(ref_args[4]) > 0)
    assert _err(ref_oracle(*ref_args)[rows], got[rows]) < tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 4, 8, 32])
def test_split_combine_edges(G, dtype):
    """Rows of length 1, at a page edge, at a split edge and one past it,
    at two split edges, full, empty, and rows whose later splits lie
    wholly past the length; ``max_pages`` (40) is no multiple of the
    split (16 pages)."""
    B, D, page, max_pages = 9, 16, 8, 40
    pages = paged_split(B, G, max_pages, page)
    span = pages * page
    assert max_pages % pages and -(-max_pages // pages) == 3
    lens = [1, page, 3 * page, span, span + 1, 2 * span, max_pages * page,
            0, span - 1]
    rng = np.random.RandomState(G * 10 + len(dtype))
    _check(*_case(rng, B, G, D, page, max_pages, lens, dtype), dtype, pages)


@pytest.mark.parametrize("max_pages", [2, 5, 9, 17])
def test_split_combine_chain_limit(max_pages):
    """The chain-limit case of the reference's tests (each row's pages in
    order, full lengths), at table widths of one and of several splits."""
    rng = np.random.RandomState(max_pages)
    B, H, D, page = 2, 2, 32, 16
    table = np.arange(B * max_pages).reshape(B, max_pages)
    pages = paged_split(B, H, max_pages, page)
    _check(*_case(rng, B, H, D, page, max_pages, [max_pages * page] * B,
                  "f32", table=table), "f32", pages)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_combine_ragged_lengths(dtype):
    """Random lengths over a 64-page table of pages of 4 tokens (2 splits
    of 32 pages), D 64 as granite-3-2b's heads."""
    rng = np.random.RandomState(77)
    B, H, D, page, max_pages = 4, 4, 64, 4, 64
    pages = paged_split(B, H, max_pages, page)
    lens = rng.randint(1, max_pages * page + 1, B)
    _check(*_case(rng, B, H, D, page, max_pages, lens, dtype), dtype, pages)


# ------------------------------------------------------------ log-sum-exp --
def _emulate_lse(q, kp, vp, table, lengths, pages):
    """The kernel's log-sum-exp in f32: each split's running max (scores
    in log2 units) and sum, merged in split order, then ln 2 * (m +
    log2 l); LSE_EMPTY for a row of length 0."""
    B, H, D = q.shape
    page, max_pages = kp.shape[1], table.shape[1]
    out = torch.full((B, H), LSE_EMPTY, dtype=torch.float32)
    span = pages * page
    log2e = 1.4426950408889634
    for b in range(B):
        n = max(0, min(int(lengths[b]), max_pages * page))
        mx = torch.full((H,), -1e30)
        den = torch.zeros(H)
        for s in range(-(-n // span)):
            t = torch.arange(s * span, min(n, (s + 1) * span))
            k = kp[table[b, t // page].long(), t % page].float()
            sc = (q[b].float() @ k.T) * (1.0 / math.sqrt(D) * log2e)
            m = sc.max(dim=1).values
            mn = torch.maximum(mx, m)
            den = den * torch.exp2(mx - mn) + torch.exp2(
                sc - mn[:, None]).sum(dim=1)
            mx = mn
        if n:
            out[b] = math.log(2.0) * (mx + torch.log2(den))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(G, dtype):
    """The plain version's log-sum-exp against ``torch.logsumexp`` of
    each row's scaled scores over its valid tokens (gathered through the
    table here), and the kernel's split-and-merge arithmetic against it,
    within 1e-5 (the card's f32 limit), at the split's edges; a row of
    length 0 takes ``LSE_EMPTY`` exactly; the output is the same with
    the log-sum-exp asked for and without, through the wrapper too."""
    B, D, page, max_pages = 9, 16, 8, 40
    pages = paged_split(B, G, max_pages, page)
    span = pages * page
    lens = [1, page, 3 * page, span, span + 1, 2 * span, max_pages * page,
            0, span - 1]
    rng = np.random.RandomState(G * 100 + len(dtype))
    _, args = _case(rng, B, G, D, page, max_pages, lens, dtype)
    q, kp, vp, table, ln = args
    out, lse = paged_attention_plain(*args, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, G)
    assert torch.equal(out, paged_attention_plain(*args))
    got_out, got_lse = paged_attention(*args, return_lse=True)
    assert torch.equal(got_out, out) and torch.equal(got_lse, lse)
    for b in range(B):
        n = min(lens[b], max_pages * page)
        if n == 0:
            assert torch.equal(lse[b], torch.full((G,), LSE_EMPTY))
            assert not out[b].any()
            continue
        t = torch.arange(n)
        k = kp[table[b, t // page].long(), t % page].float()
        want = torch.logsumexp(q[b].float() @ k.T / math.sqrt(D), dim=-1)
        assert float((lse[b] - want).abs().max()) <= 1e-5, b
    emulated = _emulate_lse(*args, pages)
    assert float((emulated - lse).abs().max()) <= 1e-5


def test_chip_smoke_lse_check_catches_a_wrong_row():
    """``chip_smoke.paged_lse_check`` passes the plain version's
    log-sum-exp against itself, and fails it with one row's value 1e-4
    off, or with a row of length 0 away from ``LSE_EMPTY``."""
    check = _chip_smoke().paged_lse_check
    B, G, D, page, max_pages = 4, 4, 16, 8, 4
    rng = np.random.RandomState(11)
    _, args = _case(rng, B, G, D, page, max_pages, [0, 5, 32, 17], "f32")
    lens = args[4]
    _, lse = paged_attention_plain(*args, return_lse=True)
    good = check(lse, lse, lens)
    assert good["within_tolerance"] and good["empty_rows"] == 1
    off = lse.clone()
    off[2, 1] += 1e-4
    assert not check(off, lse, lens)["within_tolerance"]
    moved = lse.clone()
    moved[0] = 0.0
    assert not check(moved, lse, lens)["within_tolerance"]


def _head_major(rng, B, n_kv, S, D):
    return torch.from_numpy(rng.randn(B, n_kv, S, D).astype(np.float32))


@pytest.mark.parametrize("blocks", [2, 4])
def test_sequence_blocks_merge_to_the_whole_cache(blocks):
    """A head-major cache of 64 positions cut into 2 and 4 blocks of its
    sequence, each attended by ``slot_decode_attention`` with its
    log-sum-exp over the tokens it holds, and merged by
    ``merge_attention_blocks``: the whole cache's output within 1e-6 in
    f32, for rows empty, of one token, on a block's edge from both
    sides, and full; a row of no token merges to zeros."""
    B, n_kv, G, S, D, page = 8, 2, 4, 64, 16, 8
    s_loc = S // blocks
    rng = np.random.RandomState(blocks)
    kc, vc = _head_major(rng, B, n_kv, S, D), _head_major(rng, B, n_kv, S, D)
    q = torch.from_numpy(rng.randn(B, 1, n_kv * G, D).astype(np.float32))
    lens = torch.tensor([0, 1, s_loc - 1, s_loc, s_loc + 1, S - 1, S, 37],
                        dtype=torch.int32)
    whole = slot_decode_attention(q, kc, vc, lens, page)
    parts = [slot_decode_attention(
        q, kc[:, :, r * s_loc:(r + 1) * s_loc].contiguous(),
        vc[:, :, r * s_loc:(r + 1) * s_loc].contiguous(),
        (lens - r * s_loc).clamp(0, s_loc), slot_page(s_loc, page),
        return_lse=True) for r in range(blocks)]
    merged = merge_attention_blocks(torch.stack([o[:, 0] for o, _ in parts]),
                                    torch.stack([lse for _, lse in parts]))
    assert float((merged - whole[:, 0]).abs().max()) <= 1e-6
    assert not merged[0].any()


def test_an_empty_block_weighs_nothing_in_the_merge():
    """``LSE_EMPTY`` beside a block that holds tokens: its weight is 0
    and the merge is that block's output exactly."""
    rng = np.random.RandomState(3)
    o = torch.from_numpy(rng.randn(2, 3, 4, 8).astype(np.float32))
    lse = torch.from_numpy(rng.randn(2, 3, 4).astype(np.float32))
    o[1] = 0.0
    lse[1] = LSE_EMPTY
    assert torch.equal(merge_attention_blocks(o, lse), o[0])


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist

    from repro_torch.distributed.tensor_parallel import ModelGroup

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield ModelGroup(dist.group.WORLD, 1, 0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("heads", [False, True])
def test_the_merge_over_one_rank_is_its_block(one_rank, heads):
    """``merge_attention_partials`` over a ``model`` axis of one rank: the
    block's output in f32 bit for bit (weight exp(0) = 1), in two
    counted collectives, reduce-scattered or all-reduced."""
    from repro_torch.distributed.tensor_parallel import (
        MODEL_COLLECTIVES,
        merge_attention_partials,
    )

    rng = np.random.RandomState(5)
    o = torch.from_numpy(rng.randn(3, 4, 8).astype(np.float32)).to(
        torch.bfloat16)
    lse = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
    MODEL_COLLECTIVES.reset()
    got = merge_attention_partials(o, lse, one_rank, heads=heads)
    assert MODEL_COLLECTIVES.count == 2
    assert got.dtype == torch.float32 and torch.equal(got, o.float())


# --------------------------------------------- chip_smoke's profiler time --
@pytest.mark.parametrize("lost", [0, 1, "alone"])
def test_profiler_ms_takes_no_reading_from_a_profile_missing_launches(
        monkeypatch, lost):
    """``chip_smoke.profiler_ms`` divides a session's kernel time by its
    calls only where the session captured ``reps`` times one call's
    launches (a stubbed profile: 2 launches a call, 0.5 ms each); with
    one launch lost it reads None and reports both counts, and where
    every lone call's session holds no launch it reads None after three
    of them and takes no session over ``reps`` calls."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs.torch.cuda, "synchronize", lambda: None)
    calls = []          # one entry a call of the profiled function
    sessions = []

    def fake_profile(fn, match=None, top=10):
        before = len(calls)
        fn()
        n = 2 * (len(calls) - before)
        if lost == "alone":
            n = 0 if n == 2 else n
        elif sessions:
            n -= lost
        sessions.append(n)
        return {"captured": True, f"{match}_launches": n,
                f"{match}_ms": 0.5 * n, "device_busy_ms": 0.5 * n}

    monkeypatch.setattr(cs, "device_profile", fake_profile)
    counts = {}
    got = cs.profiler_ms(lambda: calls.append(1), "paged_attention",
                         reps=20, counts=counts)
    if lost == "alone":
        assert sessions == [0, 0, 0]
        assert counts == {"one_call": 0}
        assert got is None
        return
    assert sessions == [2, 40 - lost]
    assert counts == {"one_call": 2, "launches": 40 - lost, "expected": 40}
    assert got == (None if lost else 1.0)
