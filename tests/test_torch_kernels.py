"""The port's kernel modules against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the reference side
(the Pallas kernels in interpret mode, their numpy oracles, the host
decoders and scoring) and through the port (the plain PyTorch versions
its wrappers take for CPU tensors, the ``torch`` and ``cuda`` backends on
``device="cpu"``).  Everything is integer arithmetic, so the tolerance
is zero: outputs must be bit-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.postings import PostingDecoder, encode_postings, encode_varint
from repro.kernels.intersect.ops import intersect_sorted as ref_intersect_sorted
from repro.kernels.intersect.ref import intersect_sorted_ref
from repro.kernels.posting_decode.ops import (
    decode_member_prefilter as ref_decode_member_prefilter,
    to_device_rows as ref_to_device_rows,
    unpack_varints as ref_unpack_varints,
)
from repro.kernels.posting_decode.ref import as_byte_array, unpack_varints_np
from repro.search.join import numpy_window_join as ref_window_join
from repro.search.scoring import ScoreSpec as RefScoreSpec
from repro.search.scoring import score_docs as ref_score_docs

from repro_torch.core.postings import PostingDecoder as PortPostingDecoder
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.intersect.kernel import (
    sorted_member_mask,
    sorted_member_mask_plain,
)
from repro_torch.kernels.intersect.ops import doc_member_mask, intersect_sorted
from repro_torch.kernels.posting_decode.kernel import (
    varint_segment_sum,
    varint_segment_sum_plain,
)
from repro_torch.kernels.posting_decode.ops import (
    DECODE_BACKENDS,
    DeviceDecoder,
    decode_member_prefilter,
    from_device_rows,
    to_device_rows,
    unpack_varints,
)
from repro_torch.kernels.posting_decode.ref import byte_prep
from repro_torch.search.join import (
    JOIN_BACKENDS,
    numpy_window_join,
    torch_join_many,
)
from repro_torch.search.scoring import ScoreSpec, score_docs_torch

CPU = "cpu"
DEVICE_BACKENDS = ("torch", "cuda")


def _varint_buf(values) -> bytes:
    buf = bytearray()
    for v in values:
        encode_varint(int(v), buf)
    return bytes(buf)


def _posting_stream(n, seed, max_doc=50, max_pos=200_000):
    rng = np.random.RandomState(seed)
    arr = np.stack(
        [np.sort(rng.randint(0, max_doc, n)), rng.randint(0, max_pos, n)], 1
    ).astype(np.int64)
    arr = arr[np.lexsort((arr[:, 1], arr[:, 0]))]
    return arr, encode_postings(arr)


def _tensors(*arrays):
    return [torch.tensor(np.asarray(a, dtype=np.int64)) for a in arrays]


# ------------------------------------------------- varint segment sum --
@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_segment_sum_matches_pallas_kernel(width):
    """Varints of up to 4 bytes: the reference routes them through the
    Pallas ``varint_unpack_kernel`` (interpret mode); the port's segment
    sum over the same byte prep must give the same values."""
    rng = np.random.RandomState(100 + width)
    vals = rng.randint(0, 1 << (7 * width), size=rng.randint(50, 300))
    buf = _varint_buf(vals)
    ref = ref_unpack_varints(buf, backend="pallas")
    contrib, vid, n = byte_prep(as_byte_array(buf))
    vid_t, contrib_t = _tensors(vid, contrib)
    got = varint_segment_sum(vid_t, contrib_t, n)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(ref, vals)


@pytest.mark.parametrize("backend", DECODE_BACKENDS)
def test_unpack_varints_matches_oracle_all_widths(backend):
    """Widths 1..5 and values near 2^62: the port's int64 device sum
    decodes every width exactly (no width gate), like the host oracle."""
    rng = np.random.RandomState(21)
    for width in (1, 2, 3, 4, 5):
        vals = rng.randint(0, 1 << (7 * width), size=rng.randint(1, 400))
        buf = _varint_buf(vals)
        got = unpack_varints(buf, backend=backend, device=CPU)
        assert got.dtype == np.int64
        assert np.array_equal(got, unpack_varints_np(as_byte_array(buf)))
        assert np.array_equal(got, vals)
    wide = [3, 1 << 40, 127, (1 << 62) - 5, 0, 1 << 28]
    assert unpack_varints(_varint_buf(wide), backend=backend,
                          device=CPU).tolist() == wide


def test_segment_sum_plain_equals_wrapper_and_validates():
    rng = np.random.RandomState(5)
    contrib, vid, n = byte_prep(as_byte_array(_varint_buf(
        rng.randint(0, 1 << 35, 500))))
    vid_t, contrib_t = _tensors(vid, contrib)
    assert torch.equal(varint_segment_sum(vid_t, contrib_t, n),
                       varint_segment_sum_plain(vid_t, contrib_t, n))
    with pytest.raises(TypeError):
        varint_segment_sum(vid_t.to(torch.int32), contrib_t, n)
    with pytest.raises(ValueError):
        varint_segment_sum(vid_t[:-1], contrib_t, n)
    with pytest.raises(ValueError):
        varint_segment_sum(vid_t.to("meta"), contrib_t.to("meta"), n)


# ------------------------------------------------- sorted member mask --
@pytest.mark.parametrize("na,nb", [(100, 200), (1000, 50), (8, 8),
                                   (2000, 3000)])
def test_member_mask_matches_pallas_kernel(na, nb):
    rng = np.random.RandomState(na + nb)
    a = np.unique(rng.randint(0, 10_000, na)).astype(np.int32)
    b = np.unique(rng.randint(0, 10_000, nb)).astype(np.int32)
    ref = np.asarray(ref_intersect_sorted(a, b))
    want = np.asarray(intersect_sorted_ref(jnp.asarray(a), jnp.asarray(b)))
    a_t, b_t = _tensors(a, b)
    got = sorted_member_mask(a_t, b_t)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(intersect_sorted(a, b, device=CPU), ref)


@pytest.mark.parametrize("case", ["disjoint", "identical", "empty_b",
                                  "beyond_int32"])
def test_member_mask_edge_cases(case):
    a = np.arange(0, 100, dtype=np.int64)
    if case == "disjoint":
        b, want = np.arange(1000, 1100), np.zeros(100, bool)
    elif case == "identical":
        b, want = a.copy(), np.ones(100, bool)
    elif case == "empty_b":
        b, want = np.zeros(0, np.int64), np.zeros(100, bool)
    else:
        # doc ids past the reference kernel's int32 keys: no gate here
        a = a + (1 << 40)
        b, want = a[::3], np.arange(100) % 3 == 0
    a_t, b_t = _tensors(a, b)
    assert np.array_equal(sorted_member_mask(a_t, b_t).numpy(), want)
    assert np.array_equal(sorted_member_mask_plain(a_t, b_t).numpy(), want)
    assert np.array_equal(doc_member_mask(a, b, device=CPU), want)


# ------------------------------------------------------ device decoder --
@pytest.mark.parametrize("backend", DECODE_BACKENDS)
def test_device_decoder_matches_reference_under_random_chunkings(backend):
    """The port's DeviceDecoder == the reference PostingDecoder on the
    same stream fed through random chunk boundaries (cuts inside varints
    included); their carry states stay interchangeable throughout."""
    arr, enc = _posting_stream(300, seed=31)
    rng = np.random.RandomState(len(backend))
    raw = np.frombuffer(enc, np.uint8)
    for _ in range(4):
        cuts = np.sort(
            rng.choice(len(enc), size=rng.randint(0, 12), replace=False)
        )
        host = PostingDecoder()
        dev = DeviceDecoder(backend=backend, device=CPU)
        hrows, drows = [], []
        for c in np.split(raw, cuts):
            hrows.append(host.feed(c.tobytes())[0])
            drows.append(dev.feed(c.tobytes())[0])
            assert host.state() == dev.state()
        h = np.concatenate(hrows)
        assert np.array_equal(h, np.concatenate(drows))
        assert np.array_equal(h, arr)


@pytest.mark.parametrize("backend", DEVICE_BACKENDS)
def test_suspend_under_reference_resume_under_port(backend):
    """A stream suspended under the reference PostingDecoder resumes under
    the port's DeviceDecoder, and one suspended under the port resumes
    under the port's own copy of the host decoder."""
    arr, enc = _posting_stream(200, seed=37, max_pos=(1 << 40))
    cut = len(enc) // 2 + 1
    host = PostingDecoder()
    head = host.feed(enc[:cut])[0]
    dev = DeviceDecoder(backend=backend, device=CPU)
    dev.set_state(host.state())
    tail = dev.feed(enc[cut:])[0]
    assert np.array_equal(np.concatenate([head, tail]), arr)
    dev2 = DeviceDecoder(backend=backend, device=CPU)
    head2 = dev2.feed(enc[:cut])[0]
    host2 = PortPostingDecoder()
    host2.set_state(dev2.state())
    tail2 = host2.feed(enc[cut:])[0]
    assert np.array_equal(np.concatenate([head2, tail2]), arr)


@pytest.mark.parametrize("backend", DECODE_BACKENDS)
def test_decode_member_prefilter_matches_reference(backend):
    arr, enc = _posting_stream(250, seed=53)
    docs = np.unique(arr[:, 0])
    other = np.concatenate([docs[::2], docs.max() + 7 + docs[:5]])
    state = ref_state = (b"", 0, 0, False)
    cut = len(enc) // 3
    for blob in (enc[:cut], enc[cut:]):
        posts, mask, state = decode_member_prefilter(
            blob, other, backend=backend, state=state, device=CPU
        )
        rposts, rmask, ref_state = ref_decode_member_prefilter(
            blob, other, backend="pallas", state=ref_state
        )
        assert np.array_equal(posts, rposts)
        assert np.array_equal(mask, rmask)
        assert state == ref_state


def test_unknown_decode_backend_rejected():
    with pytest.raises(ValueError):
        unpack_varints(b"\x01", backend="pallas", device=CPU)
    with pytest.raises(ValueError):
        DeviceDecoder(backend="jax", device=CPU)


# ---------------------------------------------------------- device rows --
def test_device_rows_gate_and_charge_match_reference():
    """The device tier stays int32: the same gate as the reference, and
    the same ``nbytes`` the posting cache charges."""
    arr, _ = _posting_stream(100, seed=59)
    buf = to_device_rows(arr, device=CPU)
    ref = ref_to_device_rows(arr)
    assert buf.dtype == torch.int32
    assert int(buf.nbytes) == int(ref.nbytes)
    back = from_device_rows(buf)
    assert back.dtype == np.int64 and not back.flags.writeable
    assert np.array_equal(back, arr)
    big = np.array([[0, np.iinfo(np.int32).max]], dtype=np.int64)
    assert to_device_rows(big, device=CPU) is None
    assert ref_to_device_rows(big) is None
    empty = np.zeros((0, 2), dtype=np.int64)
    assert np.array_equal(from_device_rows(to_device_rows(empty, CPU)), empty)


# -------------------------------------------------------------- scoring --
@pytest.mark.parametrize("n_slots,n_docs", [(1, 1), (2, 37), (3, 500),
                                            (5, 0)])
def test_score_docs_torch_equals_reference(n_slots, n_docs):
    rng = np.random.RandomState(n_slots * 1000 + n_docs)
    counts = [rng.randint(0, 9, n_docs).astype(np.int64)
              for _ in range(n_slots)]
    weights = tuple(int(w) for w in rng.randint(1, 13, n_slots))
    want = ref_score_docs(counts, RefScoreSpec(weights=weights))
    got = score_docs_torch(counts, ScoreSpec(weights=weights), device=CPU)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


# ---------------------------------------------------------------- joins --
def _join_case(rng, n_a, n_b, doc_base, n_docs=30, max_pos=400):
    def rows(n):
        r = np.stack([doc_base + rng.randint(0, n_docs, n),
                      rng.randint(0, max_pos, n)], 1).astype(np.int64)
        return r[np.lexsort((r[:, 1], r[:, 0]))]
    return rows(n_a), rows(n_b)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("doc_base", [0, 1 << 24, (1 << 40) + 3])
def test_join_backends_equal_numpy_oracle(backend, doc_base):
    """Every backend equals the reference host join, doc ids beyond 2^24
    (the old int32 packing limit) and 2^40 included."""
    rng = np.random.RandomState(doc_base % 997)
    join = JOIN_BACKENDS[backend]
    for n_a, n_b, w in [(50, 80, 3), (200, 7, 1), (1, 1, 2), (0, 5, 3),
                        (300, 300, 5)]:
        a, b = _join_case(rng, n_a, n_b, doc_base)
        want = ref_window_join(a, b, w)
        got = join(a, b, w, device=CPU)
        assert np.array_equal(got, want), (n_a, n_b, w)
        assert np.array_equal(numpy_window_join(a, b, w), want)


def test_torch_join_many_buckets_match_oracle():
    """Many pairs of mixed shapes and windows, joined in power-of-two
    buckets with one batched searchsorted each."""
    rng = np.random.RandomState(77)
    pairs = []
    for i in range(24):
        a, b = _join_case(rng, rng.randint(0, 90), rng.randint(0, 90),
                          (1 << 33) * (i % 2))
        pairs.append((a, b, int(rng.randint(1, 6))))
    got = torch_join_many(pairs, device=CPU)
    for (a, b, w), g in zip(pairs, got):
        assert np.array_equal(g, ref_window_join(a, b, w))


# ---------------------------------------------------------------- build --
def test_kernel_sources_and_flags():
    """Every kernel's wrapper names a CUDA source that exists and is built
    for sm_90a."""
    names = {s.name for s in cuda_lib.sources()}
    assert {"varint_segment_sum.cu", "sorted_member_mask.cu"} <= names
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
    for src in cuda_lib.sources():
        text = src.read_text()
        if "__global__" in text:
            assert "Replaces src/repro/kernels/" in text
            assert "Bound on an H100" in text
