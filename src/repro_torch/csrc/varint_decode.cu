// varint_decode: raw LEB128 posting bytes -> int64 values, in one launch.
//
// Replaces src/repro/kernels/posting_decode/kernel.py::varint_unpack_kernel
// (Pallas, TPU), and with it the host's byte prep.  The TPU kernel summed
// per-byte payloads that the host had prepared (value ids and shifted
// payloads, 16 B a stream byte); this kernel reads the stream itself and
// does all three steps of kernels/posting_decode/ref.py:
//   1. terminator flags: a byte below 0x80 ends a varint;
//   2. value ids: a terminator's id is the count of terminators before it;
//   3. assembly: value = sum of (b & 0x7f) << 7 * rank over its bytes.
// Payloads are assembled in uint64 with shifts of at most 63, so rank 9
// keeps only its low bit, as numpy's int64 << does in byte_prep: varints
// of 1 to 10 bytes decode bit for bit as unpack_varints_np decodes them.
// A longer run of continuation bytes is no LEB128 encoding of a 64-bit
// value; the kernel assembles only its last 10 bytes.  Bytes after the
// last terminator are ignored, and a value id at or past n_values is not
// written.
//
// Bound on an H100: bytes.  Each stream byte is read once (1 B) and each
// value written once (8 B), against a few integer operations a byte; the
// least time is (n_bytes + 8 * n_values) over 3.35 TB/s.
//
// Design.  A block owns a tile of kTile = 4096 bytes; each of its 256
// threads loads 16 consecutive bytes with one 16-byte load (byte loads
// only for a misaligned base or the ragged last tile) and stages them in
// shared memory beside the 16 bytes before the tile, so a varint that
// straddles the tile's start is read whole.  A thread counts its
// terminators, and one block-wide exclusive scan gives each terminator
// its id within the tile.  The ids across tiles come from a single-pass
// decoupled look-back: a block posts its tile's count as soon as it is
// known, and warp 0 reads the words of the 32 tiles before it at a time,
// summing counts back to the first tile whose inclusive prefix is posted.
// The status words and the tile ticket are zeroed by a memset on the
// launch's stream before the kernel (one 8-byte word a 4 KB tile), and
// tiles are handed out in launch order by the atomic ticket, so every
// tile a block waits on has a block running.
// While warp 0 looks back, each thread assembles the varints that end in
// its 16 bytes (a loop over its terminators: 8-byte reads of its window in
// shared memory, funnel shifts and a three-step pack of the 7-bit groups,
// no loop over bytes) and stages the values in shared memory; the block
// then writes its run of values out[prefix ...] with coalesced stores.
// Every value is written once, with no atomics: the output is torch.empty.
// The last tile writes 0 to the ids from the stream's count of values up
// to n_values, as the plain version leaves them.  A buffer of one tile
// (every search chunk so far) runs as one block without memset, ticket or
// look-back.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytes = 16;                // stream bytes a thread owns
constexpr int kTile = kThreads * kBytes;  // stream bytes a block owns
constexpr int kMaxVarint = 10;            // bytes of a 64-bit LEB128 value

// status word of a tile: flag (2 bits) | count (62 bits); 0 is not posted
constexpr int kCountBits = 62;
constexpr unsigned long long kCountMask = (1ull << kCountBits) - 1;
constexpr unsigned long long kFlagMask = 3ull << kCountBits;
constexpr unsigned long long kAggregate = 1ull << kCountBits;  // own count
constexpr unsigned long long kPrefix = 2ull << kCountBits;     // inclusive
constexpr unsigned kFull = 0xffffffffu;

// 16 stream bytes from byte g: bytes before the stream read as terminators
// (a varint starts at byte 0), bytes at or past n as continuation bytes
// (they end nothing)
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ buf,
                                        long long n, long long g,
                                        bool aligned) {
  if (aligned && g >= 0 && g + kBytes <= n)
    return __ldg(reinterpret_cast<const uint4*>(buf + g));
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t x = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long i = g + 4 * j + b;
      const uint32_t byte = i < 0 ? 0u : (i >= n ? 0x80u : buf[i]);
      x |= byte << (8 * b);
    }
    w[j] = x;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// terminators before `tile` (> 0), read back from the posted status words;
// called by a whole warp
__device__ long long look_back(const unsigned long long* status,
                               long long tile, int lane) {
  long long prefix = 0;
  for (long long j = tile - 1;; j -= 32) {
    const long long t = j - lane;  // lane 0 reads the nearest tile
    unsigned long long w;
    bool ready;
    do {
      if (t >= 0) {
        w = load_status(status + t);
        ready = (w & kFlagMask) != 0;
      } else {
        w = kPrefix;  // before tile 0: an inclusive prefix of 0
        ready = true;
      }
    } while (!__all_sync(kFull, ready));
    const unsigned pmask = __ballot_sync(kFull, (w & kFlagMask) == kPrefix);
    const int first = pmask ? __ffs(pmask) - 1 : 32;
    long long c = lane <= first ? static_cast<long long>(w & kCountMask) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
    prefix += c;
    if (pmask) return prefix;
  }
}

// bit i of the result: byte i of the 16 ends a varint (is below 0x80)
__device__ __forceinline__ uint32_t terminators(uint4 b) {
  const uint32_t w[4] = {b.x, b.y, b.z, b.w};
  uint32_t mask = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)  // bits 7, 15, 23, 31 to bits 0..3
    mask |= ((((~w[i] & 0x80808080u) >> 7) * 0x10204080u) >> 28) << (4 * i);
  return mask;
}

// the value of the varint at bytes p[0 .. len) (len 1..10): its 7-bit
// groups in little-endian order, bits past 63 dropped.  p may be unaligned;
// the 24 bytes from p rounded down to 8 must be readable.  Up to 4 bytes
// (every posting delta below 2^28) take a 32-bit path.
__device__ __forceinline__ unsigned long long assemble(const uint8_t* p,
                                                       int len) {
  if (len <= 4) {  // the common case, in 32 bits: four 7-bit groups
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    uint32_t x = __funnelshift_r(w[0], w[1], static_cast<int>(a & 3) * 8);
    x &= (0xffffffffu >> (32 - 8 * len)) & 0x7f7f7f7fu;
    x = (x & 0x007f007fu) | ((x & 0x7f007f00u) >> 1);
    return (x & 0x00003fffu) | ((x & 0x3fff0000u) >> 2);
  }
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 7) * 8;
  const unsigned long long* w = reinterpret_cast<const unsigned long long*>(
      p - (reinterpret_cast<uintptr_t>(p) & 7));
  const unsigned long long w0 = w[0], w1 = w[1], w2 = w[2];
  unsigned long long lo = off ? (w0 >> off) | (w1 << (64 - off)) : w0;
  unsigned long long hi = off ? (w1 >> off) | (w2 << (64 - off)) : w1;
  if (len < 8) {
    lo &= (1ull << (8 * len)) - 1;
    hi = 0;
  } else {
    hi &= (1ull << (8 * (len - 8))) - 1;
  }
  // eight 7-bit groups, one a byte, packed into 56 bits
  lo &= 0x7f7f7f7f7f7f7f7full;
  lo = (lo & 0x007f007f007f007full) | ((lo & 0x7f007f007f007f00ull) >> 1);
  lo = (lo & 0x00003fff00003fffull) | ((lo & 0x3fff00003fff0000ull) >> 2);
  lo = (lo & 0x000000000fffffffull) | ((lo & 0x0fffffff00000000ull) >> 4);
  return lo | ((hi & 0x7full) << 56) | (((hi >> 8) & 0x7full) << 63);
}

__global__ void __launch_bounds__(kThreads)
varint_decode_kernel(const uint8_t* __restrict__ buf, long long n,
                     long long* __restrict__ out, long long n_values,
                     unsigned long long* __restrict__ status,
                     unsigned long long* __restrict__ ticket,
                     long long n_tiles) {
  // the 16 bytes before the tile, the tile, and 16 bytes that assemble()
  // may read past the last thread's bytes (never used)
  __shared__ uint4 sm_bytes[kThreads + 2];
  __shared__ long long sm_vals[kTile];      // the tile's values, in order
  __shared__ int sm_warp[kWarps];
  __shared__ long long sm_tile, sm_prefix;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool multi = n_tiles > 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(buf) & 15) == 0;

  if (tid == 0)
    sm_tile = multi ? static_cast<long long>(atomicAdd(ticket, 1ull)) : 0;
  __syncthreads();
  const long long tile = sm_tile;
  const long long t0 = tile * kTile;
  const uint4 own = load16(buf, n, t0 + tid * kBytes, aligned);
  sm_bytes[tid + 1] = own;
  if (tid == 0) sm_bytes[0] = load16(buf, n, t0 - kBytes, aligned);

  // window: the 16 bytes before this thread's (0..15) and its own (16..31);
  // bit j of term: window byte j ends a varint
  uint32_t term = terminators(own) << 16;
  const int cnt = __popc(term);

  // block-wide exclusive scan of the counts
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm_warp[warp] = x;
  __syncthreads();  // also publishes sm_bytes
  if (warp == 0) {
    int s = lane < kWarps ? sm_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) sm_warp[lane] = s;
  }
  __syncthreads();
  const int excl = x - cnt + (warp > 0 ? sm_warp[warp - 1] : 0);
  const int total = sm_warp[kWarps - 1];

  if (tid == 0 && multi)
    atomicExch(status + tile, (tile == 0 ? kPrefix : kAggregate) |
                                  static_cast<unsigned long long>(total));
  if (warp == 0) {
    long long prefix = 0;
    if (multi && tile > 0) {
      prefix = look_back(status, tile, lane);
      if (lane == 0)
        atomicExch(status + tile,
                   kPrefix | static_cast<unsigned long long>(prefix + total));
    }
    if (lane == 0) sm_prefix = prefix;
  }

  // assemble the varints that end in this thread's bytes, from its window
  // in shared memory: a varint starts after the terminator before it, at
  // most kMaxVarint bytes back
  term |= terminators(sm_bytes[tid]);
  const uint8_t* window = reinterpret_cast<const uint8_t*>(sm_bytes) +
                          tid * kBytes;
  int k = excl;
  for (uint32_t todo = term >> 16; todo; todo &= todo - 1) {
    const int j = 16 + __ffs(todo) - 1;
    const uint32_t before = term & ((1u << j) - 1u);
    const int p = before ? 31 - __clz(before) : -1;  // previous terminator
    const int start = max(p + 1, j - (kMaxVarint - 1));
    sm_vals[k++] =
        static_cast<long long>(assemble(window + start, j - start + 1));
  }
  __syncthreads();

  const long long base = sm_prefix;
  for (int i = tid; i < total; i += kThreads) {
    const long long v = base + i;
    if (v < n_values) out[v] = sm_vals[i];
  }
  if (tile == n_tiles - 1)  // ids past the stream's last value
    for (long long v = base + total + tid; v < n_values; v += kThreads)
      out[v] = 0;
}

}  // namespace

// buf: (n_bytes,) uint8; out: (n_values,) int64.  scratch: n_tiles + 1
// 64-bit words (n_tiles = ceil(n_bytes / 4096)) of any contents, zeroed
// here on the stream: a status word a tile, then the tile ticket.  It is
// unused (and may be null) for a buffer of one tile.
extern "C" int varint_decode(const void* buf, long long n_bytes, void* out,
                             long long n_values, void* scratch,
                             void* stream) {
  if (n_bytes < 0 || n_values < 0 || n_values > n_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_bytes == 0) return static_cast<int>(cudaSuccess);
  const long long n_tiles = (n_bytes + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* status = static_cast<unsigned long long*>(scratch);
  if (n_tiles > 1) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, (n_tiles + 1) * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  varint_decode_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(buf), n_bytes, static_cast<long long*>(out),
      n_values, status, n_tiles > 1 ? status + n_tiles : nullptr, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
