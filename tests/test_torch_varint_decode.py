"""The port's fused varint decode against the JAX package, on the CPU.

``varint_decode`` takes raw LEB128 bytes; on the CPU it runs its plain
version (flags, cumsum ids, ranks and shifts in PyTorch, then the
segment sum).  The same bytes, made from a seed with numpy, go through
the reference's ``unpack_varints`` (the Pallas kernel in interpret mode,
and the numpy oracle) and through the port.  A numpy emulation of the
CUDA kernel's tiling (its per-thread windows, block counts, decoupled
look-back across tiles and assembly) is held to the same oracle.
Integer arithmetic throughout: outputs must be bit-identical."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.postings import PostingDecoder, encode_postings, encode_varint
from repro.kernels.posting_decode.ops import unpack_varints as ref_unpack_varints
from repro.kernels.posting_decode.ref import unpack_varints_np

from repro_torch.kernels.posting_decode.kernel import (
    TILE_BYTES,
    varint_decode,
    varint_decode_plain,
)
from repro_torch.kernels.posting_decode.ops import DeviceDecoder, unpack_varints

CPU = "cpu"
U64 = np.uint64


def _varint_buf(values) -> np.ndarray:
    buf = bytearray()
    for v in values:
        encode_varint(int(v), buf)
    return np.frombuffer(bytes(buf), dtype=np.uint8)


def _values_of_width(width: int, n: int, rng) -> list:
    """``n`` Python ints whose LEB128 encoding is ``width`` bytes (width
    10 reaches bit 63: values in [2^63, 2^64))."""
    lo = 0 if width == 1 else 1 << (7 * (width - 1))
    hi = min(1 << (7 * width), 1 << 64)
    return [lo + int(rng.randint(0, 1 << 62)) * (hi - lo) // (1 << 62)
            for _ in range(n)]


def _as_int64(values) -> np.ndarray:
    """The int64 values numpy's decode gives: the low 64 bits."""
    low = ((int(v) & ((1 << 64) - 1)) for v in values)
    return np.fromiter(low, dtype=U64).view(np.int64)


def _decode(raw: np.ndarray) -> torch.Tensor:
    return varint_decode(torch.tensor(raw), int(np.count_nonzero(raw < 0x80)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------- against the reference --
@pytest.mark.parametrize("width", range(1, 11))
def test_plain_matches_reference_each_width(width):
    """Widths 1 to 10, each alone and mixed with 1-byte varints: the
    port's plain decode equals the reference's Pallas route (interpret
    mode; it takes the host path past 4 bytes) and its numpy oracle."""
    rng = np.random.RandomState(200 + width)
    vals = _values_of_width(width, 60, rng)
    mixed = [v for pair in zip(vals, rng.randint(0, 128, 60)) for v in pair]
    for values in (vals, mixed):
        raw = _varint_buf(values)
        want = unpack_varints_np(raw)
        assert np.array_equal(want, _as_int64(values))
        assert np.array_equal(ref_unpack_varints(raw.tobytes(),
                                                 backend="pallas"), want)
        n = int(np.count_nonzero(raw < 0x80))
        got = varint_decode_plain(torch.tensor(raw), n)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(varint_decode(torch.tensor(raw), n).numpy(),
                              want)


def test_values_near_two_to_the_62():
    near = [(1 << 62) + d for d in (-3, -1, 0, 1, 7)] + [(1 << 63) - 1,
                                                         1 << 63,
                                                         (1 << 64) - 1]
    raw = _varint_buf(near)
    assert np.array_equal(_decode(raw).numpy(), unpack_varints_np(raw))
    assert np.array_equal(_decode(raw).numpy(), _as_int64(near))


def test_empty_buffer_and_single_byte():
    empty = varint_decode(torch.zeros(0, dtype=torch.uint8), 0)
    assert empty.dtype == torch.int64 and empty.numel() == 0
    for b in (0, 1, 0x7F):
        one = varint_decode(torch.tensor([b], dtype=torch.uint8), 1)
        assert one.tolist() == [b]
        assert one.tolist() == unpack_varints_np(
            np.array([b], np.uint8)).tolist()


def test_trailing_partial_varint_adds_nothing():
    """Bytes after the last terminator (a split varint) are ignored, as
    the kernel ignores them."""
    raw = np.concatenate([_varint_buf([5, 300, 1 << 40]),
                          np.array([0x81, 0xFF], np.uint8)])
    got = varint_decode(torch.tensor(raw), 3)
    assert got.tolist() == [5, 300, 1 << 40]
    with pytest.raises(ValueError):   # the decode backends take whole varints
        unpack_varints(raw, backend="cuda", device=CPU)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suspend_resume_random_chunkings_wide_varints(seed):
    """Postings whose positions need 5 to 9 bytes, fed through random cuts
    (inside varints too): the port's DeviceDecoder under ``cuda`` and
    ``torch`` equals the reference PostingDecoder, and a stream suspended
    under either resumes under the other."""
    rng = np.random.RandomState(300 + seed)
    n = 250
    docs = np.sort(rng.randint(0, 40, n))
    # below 2^57, so the delta expansion's int64 sums over 40 doc runs
    # stay exact
    pos = rng.randint(1 << 28, 1 << 57, n, dtype=np.int64)
    arr = np.stack([docs, pos], 1).astype(np.int64)
    arr = arr[np.lexsort((arr[:, 1], arr[:, 0]))]
    enc = encode_postings(arr)
    raw = np.frombuffer(enc, np.uint8)
    cuts = np.sort(rng.choice(len(enc), size=10, replace=False))
    host = PostingDecoder()
    decs = {b: DeviceDecoder(backend=b, device=CPU) for b in ("cuda", "torch")}
    rows = {b: [] for b in ("host", *decs)}
    for i, c in enumerate(np.split(raw, cuts)):
        rows["host"].append(host.feed(c.tobytes())[0])
        for b, d in decs.items():
            rows[b].append(d.feed(c.tobytes())[0])
            assert d.state() == host.state()
        if i == 4:   # hand the streams across mid-way
            decs["cuda"].set_state(host.state())
            host.set_state(decs["torch"].state())
    for b in rows:
        assert np.array_equal(np.concatenate(rows[b]), arr)


# ------------------------------------------------ the kernel's tiling --
def _load16(raw: np.ndarray, g: int) -> np.ndarray:
    """The kernel's ``load16``: bytes before the stream read as 0x00
    (terminators), bytes at or past its end as 0x80."""
    idx = np.arange(g, g + 16)
    out = np.where(idx < 0, 0, 0x80).astype(np.uint8)
    ok = (idx >= 0) & (idx < raw.size)
    out[ok] = raw[idx[ok]]
    return out


def _terminators(b16: np.ndarray) -> int:
    """The kernel's ``terminators``: four 32-bit words, each folded by a
    multiply into 4 bits."""
    mask = 0
    for i, x in enumerate(b16.view("<u4").tolist()):
        t = ((~x & 0x80808080) & 0xFFFFFFFF) >> 7
        mask |= (((t * 0x10204080) & 0xFFFFFFFF) >> 28) << (4 * i)
    return mask


def _assemble(smem: np.ndarray, pos: int, length: int) -> int:
    """The kernel's ``assemble`` in Python ints: up to 4 bytes, two
    aligned 4-byte reads, a funnel shift and a two-step pack; else three
    aligned 8-byte reads, funnel shifts, the length masks and the
    three-step pack."""
    if length <= 4:
        a, off = pos & ~3, (pos & 3) * 8
        lo, hi = (int.from_bytes(smem[a + 4 * i:a + 4 * i + 4].tobytes(),
                                 "little") for i in range(2))
        x = ((hi << 32 | lo) >> off) & 0xFFFFFFFF
        x &= (0xFFFFFFFF >> (32 - 8 * length)) & 0x7F7F7F7F
        x = (x & 0x007F007F) | ((x & 0x7F007F00) >> 1)
        return (x & 0x00003FFF) | ((x & 0x3FFF0000) >> 2)
    m64 = (1 << 64) - 1
    a, off = pos & ~7, (pos & 7) * 8
    w0, w1, w2 = (int.from_bytes(smem[a + 8 * i:a + 8 * i + 8].tobytes(),
                                 "little") for i in range(3))
    lo = ((w0 >> off) | (w1 << (64 - off))) & m64 if off else w0
    hi = ((w1 >> off) | (w2 << (64 - off))) & m64 if off else w1
    if length < 8:
        lo &= (1 << (8 * length)) - 1
        hi = 0
    else:
        hi &= (1 << (8 * (length - 8))) - 1
    lo &= 0x7F7F7F7F7F7F7F7F
    lo = (lo & 0x007F007F007F007F) | ((lo & 0x7F007F007F007F00) >> 1)
    lo = (lo & 0x00003FFF00003FFF) | ((lo & 0x3FFF00003FFF0000) >> 2)
    lo = (lo & 0x000000000FFFFFFF) | ((lo & 0x0FFFFFFF00000000) >> 4)
    return (lo | ((hi & 0x7F) << 56) | (((hi >> 8) & 0x7F) << 63)) & m64


def _emulate_kernel(raw: np.ndarray, n_values: int, tile: int,
                    rng) -> np.ndarray:
    """``csrc/varint_decode.cu`` step by step in numpy, at a tile of
    ``tile`` bytes (16 a thread).  Tiles take tickets in order; when tile
    t looks back, a random subset of the tiles before it has posted its
    inclusive prefix (the rest only its count), and warp 0 reads 32 status
    words at a time back to the first posted prefix.  Each tile's shared
    memory holds the 16 bytes before it, its bytes and 16 bytes of
    garbage, from which the threads assemble their varints; the last tile
    writes 0 to the ids past the stream's last value."""
    threads = tile // 16
    n_tiles = -(-raw.size // tile)
    out = np.full(n_values, -1, dtype=np.int64)
    written = np.zeros(n_values, dtype=np.int64)
    status = {}        # tile -> ("A" | "P", count)
    pending = []       # prefixes computed but not yet posted
    for t in range(n_tiles):
        t0 = t * tile
        smem = np.concatenate(
            [_load16(raw, t0 + 16 * i) for i in range(-1, threads)]
            + [rng.randint(0, 256, 16).astype(np.uint8)])
        terms = [_terminators(smem[16 * tid:16 * tid + 16])
                 | _terminators(smem[16 * tid + 16:16 * tid + 32]) << 16
                 for tid in range(threads)]
        counts = [bin(m >> 16).count("1") for m in terms]
        excl = np.concatenate([[0], np.cumsum(counts)[:-1]])
        total = int(sum(counts))
        status[t] = ("P" if t == 0 else "A", total)
        prefix = 0
        if t > 0:
            j = t - 1
            while True:
                words = [status[j - lane] if j - lane >= 0 else ("P", 0)
                         for lane in range(32)]
                firsts = [lane for lane, w in enumerate(words) if w[0] == "P"]
                first = firsts[0] if firsts else 32
                prefix += sum(w[1] for lane, w in enumerate(words)
                              if lane <= first)
                if firsts:
                    break
                j -= 32
            pending.append((t, prefix + total))
        rng.shuffle(pending)
        keep = int(rng.randint(0, len(pending) + 1)) if pending else 0
        for tt, inc in pending[keep:]:
            status[tt] = ("P", inc)
        pending = pending[:keep]
        for tid in range(threads):
            term = terms[tid]
            k = int(excl[tid])
            for jj in range(16, 32):
                if not (term >> jj) & 1:
                    continue
                before = term & ((1 << jj) - 1)
                p = before.bit_length() - 1
                start = max(p + 1, jj - 9)
                v = _assemble(smem, 16 * tid + start, jj - start + 1)
                vid = prefix + k
                k += 1
                if vid < n_values:
                    out[vid] = np.array(v, dtype=U64).view(np.int64)
                    written[vid] += 1
        if t == n_tiles - 1:   # the ids past the stream's last value
            out[prefix + total:] = 0
            written[prefix + total:] += 1
    assert (written == 1).all(), "every value is written exactly once"
    return out


@pytest.mark.parametrize("tile,n_bytes", [
    (64, 64), (64, 65), (64, 3000),          # 47 tiles: look-back past 32
    (TILE_BYTES, TILE_BYTES), (TILE_BYTES, TILE_BYTES + 1),
    (TILE_BYTES, 3 * TILE_BYTES + 777),
])
def test_tiling_emulation_matches_oracle(tile, n_bytes):
    """Varints of 5 to 10 bytes, so many straddle a thread's and a tile's
    edge: the emulated kernel decodes them as the oracle does."""
    rng = np.random.RandomState(n_bytes + tile)
    values, left = [], n_bytes
    while left:
        width = min(int(rng.randint(5, 11)), left)
        values += _values_of_width(width, 1, rng)
        left -= width
    raw = _varint_buf(values)
    assert raw.size == n_bytes
    n_values = int(np.count_nonzero(raw < 0x80))
    want = unpack_varints_np(raw)
    assert want.size == n_values
    got = _emulate_kernel(raw, n_values, tile, rng)
    assert np.array_equal(got, want)
    assert np.array_equal(_decode(raw).numpy(), want)


def test_tiling_emulation_short_varints_and_stream_start():
    """1- to 3-byte varints across 40 small tiles, and a first varint
    that starts at byte 0 of the stream (no terminator before it)."""
    rng = np.random.RandomState(7)
    values = [int(v) for v in rng.randint(0, 1 << 21, 900)]
    raw = _varint_buf(values)
    got = _emulate_kernel(raw, len(values), 64, rng)
    assert np.array_equal(got, np.array(values, np.int64))


@pytest.mark.parametrize("extra", [-3, 0, 7])
def test_values_asked_past_the_stream(extra):
    """``n_values`` off the stream's count of values: fewer keep the first
    values, more leave the ids past the last value 0, in the plain
    version as in the emulated kernel (its last tile writes them)."""
    rng = np.random.RandomState(20 + extra)
    values = [v for w in rng.randint(5, 11, 40)
              for v in _values_of_width(int(w), 1, rng)]
    raw = _varint_buf(values)
    n_values = len(values) + extra
    want = np.concatenate([unpack_varints_np(raw),
                           np.zeros(max(extra, 0), np.int64)])[:n_values]
    assert np.array_equal(_emulate_kernel(raw, n_values, 64, rng), want)
    assert np.array_equal(
        varint_decode(torch.tensor(raw), n_values).numpy(), want)


def test_chip_smoke_encoder_matches_reference():
    """The card check's LEB128 encoder and width-drawn values give the
    reference encoder's bytes, for widths 1 to 10."""
    smoke = _chip_smoke()
    rng = np.random.RandomState(11)
    widths = rng.randint(1, 11, 500)
    vals = smoke.values_of_widths(widths, rng)
    assert vals.dtype == U64
    raw = smoke.leb128_bytes(vals)
    want = _varint_buf([int(v) for v in vals])
    assert np.array_equal(raw, want)
    lens = np.diff(np.concatenate([[-1], np.flatnonzero(raw < 0x80)]))
    assert np.array_equal(lens, widths)
