// sorted_member_mask: out[i] = (a[i] occurs in b), segment by segment.
//
// Replaces src/repro/kernels/intersect/kernel.py::intersect_kernel (Pallas,
// TPU): the doc-id prefilter of the window join and of the fused
// decode-then-intersect entry point.  One launch takes S segments: segment
// s asks, for each key of a[a_off[s]:a_off[s+1]], whether it occurs in
// b[b_off[s]:b_off[s+1]].  Within a segment a is sorted and may repeat keys
// (doc ids of (doc, pos) postings), b is sorted without duplicates; either
// side may be empty.  The window join hands a whole join round over in one
// launch; one (a, b) pair is the one-segment case.  Keys are int64.
//
// Bound on an H100: bytes.  Each key of a and b is read once (8 B), each
// mask byte written once and each offset read once: 8N + 8M + N + 16(S+1)
// bytes over 3.35 TB/s (0.0851 ms at 2^24 in 2^24).  Where b is much the
// longer, the least work is a search: each key of a touches at least one
// 32-byte sector of b and no key needs more of b than all of it, so the
// bound is 9N + min(8M, 32N) + 16(S+1) bytes.  The compares (one per
// merged element) are few next to those bytes.
//
// Design, two routes; the wrapper picks one per launch
// (kernels/intersect/kernel.py::member_route: the search route where
// M >= 32 N, measured on an H100 80GB HBM3 at 700 W; PERF.md section 6).
//
// Merge route (merge path).  A global diagonal d of the merge space of all
// segments splits it into d = i + j: i keys of a and j keys of b come
// before it, because segments are concatenated on both sides.  On equal
// keys a goes first, so when a[i] is placed the head of b is
// lower_bound(b, a[i]) and a[i] is a member iff that head equals it.  The
// space of N + M elements is cut into tiles of 256 threads x kItems (15:
// an odd count spreads the threads' runs over the shared-memory banks).
//   - A partition pass finds the co-rank (segment, i) of every tile edge
//     in global memory, four lanes an edge: a 4-way search by ballot, first
//     over the segment starts a_off + b_off, then over the segment's keys.
//     (A 32-way search in each block read more sectors than the tile.)  A
//     launch of one tile, as a join round is, skips it.
//   - A block a tile: one thread stages its a range and its b range, plus
//     one b past the range (the head of b after the tile's last a), into
//     shared memory with two bulk copies (cp.async.bulk, each start aligned
//     down and each end up to 16 B: at most 8 bytes past an operand, in a
//     16-byte chunk it shares, so never on another page) that complete on
//     an mbarrier.
//   - Each thread finds its own co-rank by a binary search in shared memory
//     bounded by its segment and the staged ranges, and merges its kItems
//     serially.  A tile that straddles segments finds a thread's segment by
//     a binary search over the tile's segments, and a thread walks on from
//     one segment to the next; each segment's b head is clamped to its own
//     end, so a key never matches a neighbour segment's b.
//   - Hits go to a byte mask in shared memory and leave in 16-byte stores.
// Search route (M >> N).  One thread per key of a; the 32 keys of a warp
// that share a segment (__match_any_sync) find their window of b once,
// from their first and last key (lower bounds in the segment's b), and each
// lane then runs its lower bound inside that window.  It reads about
// N log2(M/N) sectors of b where a merge reads all of it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// merged elements a thread of the merge route: of 8, 15 and 16, 15 was the
// fastest at every large case (scripts/member_sweep.py; PERF.md section 6)
constexpr int kItems = 15;
constexpr int kEdgeLanes = 4;  // lanes that search one tile edge
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSpinLimit = 1u << 30;
constexpr int kRouteSearch = 0;
constexpr int kRouteMerge = 1;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == kSpinLimit) __trap();
  }
}

// bytes from global to shared memory; both 16-byte aligned, a multiple of 16
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The segments' offsets: up to kInline segments inside the kernel's
// parameters (no copy to the device: a join round, one pair), more from
// device memory.
constexpr int kInline = 64;
struct Offsets {
  const long long* a_dev;  // (S + 1) a offsets on the device, or null
  const long long* b_dev;
  long long a[kInline + 1];
  long long b[kInline + 1];
  __device__ __forceinline__ long long A(long long s) const {
    return a_dev ? __ldg(a_dev + s) : a[s];
  }
  __device__ __forceinline__ long long B(long long s) const {
    return b_dev ? __ldg(b_dev + s) : b[s];
  }
  __device__ __forceinline__ long long start(long long s) const {
    return A(s) + B(s);
  }
};

__device__ __forceinline__ uintptr_t down16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15);
}

__device__ __forceinline__ uintptr_t up16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t(15);
}

// The smallest x in [lo, hi] where pred(x) holds; pred is monotone (false,
// then true) and taken as true at hi, where it is not evaluated.  Each
// group of kEdgeLanes lanes runs its own search: a round probes kEdgeLanes
// points and cuts the range as many times.  Every lane of the warp calls
// it; a group with lo == hi has its answer and probes nothing.
template <class Pred>
__device__ long long group_search(long long lo, long long hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  const int g = lane % kEdgeLanes, base = lane - g;
  while (__any_sync(kFull, lo < hi)) {
    const long long step = (hi - lo + kEdgeLanes - 1) / kEdgeLanes;
    const long long x = lo + g * step;
    const bool p = lo < hi && (x >= hi || pred(x));
    const unsigned group =
        (__ballot_sync(kFull, p) >> base) & ((1u << kEdgeLanes) - 1);
    if (lo < hi) {
      const int f = group ? __ffs(group) - 1 : kEdgeLanes;
      if (f == 0) {
        hi = lo;
      } else {
        if (f < kEdgeLanes) hi = min(hi, lo + f * step);
        lo = lo + (f - 1) * step + 1;
      }
    }
  }
  return lo;
}

// The co-rank of every tile edge t = 0 .. tiles (diagonal min(t tile, n +
// m)): ranks[2t] its segment, ranks[2t + 1] the a index i at which that
// segment's merge stands (j = d - i).  The end of the merge space is
// (S - 1, n).
__global__ void __launch_bounds__(kThreads)
member_partition_kernel(const long long* __restrict__ a, long long n,
                        const long long* __restrict__ b, long long m,
                        const __grid_constant__ Offsets off, long long S,
                        long long tile, long long tiles,
                        long long* __restrict__ ranks) {
  const long long t =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kEdgeLanes;
  if (t - (threadIdx.x & 31) / kEdgeLanes > tiles) return;  // whole warp past
  const long long d = min(t * tile, n + m);
  const bool inside = t <= tiles && d < n + m;
  long long s = group_search(1, inside ? S : 1, [&](long long x) {
                  return off.start(x) > d;
                }) - 1;
  long long lo = 0, hi = 0;
  if (inside) {  // i in [max(a_lo, d - b_hi), min(a_hi, d - b_lo)]
    lo = max(off.A(s), d - off.B(s + 1));
    hi = min(off.A(s + 1), d - off.B(s));
  }
  // the first i with a[i] > b[d - 1 - i]
  long long i = group_search(lo, hi, [&](long long x) {
    return __ldg(a + x) > __ldg(b + d - 1 - x);
  });
  if (!inside) s = S - 1, i = n;
  if (t <= tiles && threadIdx.x % kEdgeLanes == 0) {
    ranks[2 * t] = s;
    ranks[2 * t + 1] = i;
  }
}

__global__ void __launch_bounds__(kThreads)
member_merge_kernel(const long long* __restrict__ a, long long n,
                    const long long* __restrict__ b, long long m,
                    const __grid_constant__ Offsets off, long long S,
                    const long long* __restrict__ ranks,
                    unsigned char* __restrict__ out) {
  constexpr int kTile = kThreads * kItems;
  // the a range, then the b range (+1 past it); each start aligned down to
  // 16 B and each length rounded up to 16 B
  __shared__ alignas(16) long long keys[kTile + 8];
  __shared__ alignas(16) unsigned char hit[kTile + 32];
  __shared__ alignas(8) uint64_t bar;

  // a launch of one tile needs no partition: it spans every segment
  const long long t = blockIdx.x;
  const long long s0 = ranks ? __ldg(ranks + 2 * t) : 0;
  const long long A0 = ranks ? __ldg(ranks + 2 * t + 1) : 0;
  const long long s1 = ranks ? __ldg(ranks + 2 * t + 2) : S - 1;
  const long long A1 = ranks ? __ldg(ranks + 2 * t + 3) : n;
  const long long d0 = t * kTile, d1 = min(d0 + kTile, n + m);
  const long long B0 = d0 - A0, B1 = d1 - A1;
  const long long Bx = min(B1 + 1, m);  // one b past the range
  const uint32_t a_bytes =
      A1 > A0 ? static_cast<uint32_t>(up16(a + A1) - down16(a + A0)) : 0;
  const uint32_t b_bytes =
      Bx > B0 ? static_cast<uint32_t>(up16(b + Bx) - down16(b + B0)) : 0;
  if (threadIdx.x == 0) {
    const uint32_t br = smem_addr(&bar);
    mbar_init(br, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(br, a_bytes + b_bytes);
    if (a_bytes)
      bulk_load(smem_addr(keys), reinterpret_cast<const void*>(down16(a + A0)),
                a_bytes, br);
    if (b_bytes)
      bulk_load(smem_addr(keys + a_bytes / 8),
                reinterpret_cast<const void*>(down16(b + B0)), b_bytes, br);
  }
  const uintptr_t o0 = reinterpret_cast<uintptr_t>(out + A0);
  const uintptr_t o1 = reinterpret_cast<uintptr_t>(out + A1);
  const uintptr_t obase = o0 & ~uintptr_t(15);
  // tile-local indices: a[A0 + x] is sa[x], b[B0 + y] is sb[y], and the
  // hit of a[A0 + x] goes to sh[x]; at local diagonal u, x + y = u
  const long long* sa = keys + (reinterpret_cast<uintptr_t>(a + A0) & 15) / 8;
  const long long* sb =
      keys + a_bytes / 8 + (reinterpret_cast<uintptr_t>(b + B0) & 15) / 8;
  unsigned char* sh = hit + (o0 - obase);
  __syncthreads();  // the barrier is initialised
  mbar_wait(smem_addr(&bar), 0);

  const int u_end = static_cast<int>(d1 - d0);
  const int u0 = threadIdx.x * kItems;
  if (u0 < u_end) {
    const long long dt = d0 + u0;
    // the thread's segment: the last in [s0, s1] that starts at or before dt
    long long s = s0;
    for (long long hi = s1; s < hi;) {
      const long long mid = s + (hi - s + 1) / 2;
      if (off.start(mid) <= dt) s = mid; else hi = mid - 1;
    }
    long long a_end = off.A(s + 1), b_end = off.B(s + 1);
    // co-rank in shared memory, inside the segment and the staged ranges
    int lo = static_cast<int>(max(max(off.A(s), dt - b_end),
                                  max(A0, dt - B1)) - A0);
    int hi = static_cast<int>(min(min(a_end, dt - off.B(s)),
                                  min(A1, dt - B0)) - A0);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sa[mid] > sb[u0 - 1 - mid]) hi = mid; else lo = mid + 1;
    }
    // a[A1] is not staged: past a_lim the tile's next element is a b; b's
    // head is clamped to the segment's end
    int a_lim = static_cast<int>(min(a_end, A1) - A0);
    int b_lim = static_cast<int>(min(b_end, Bx) - B0);
    int seg_end = static_cast<int>(min(a_end + b_end, d1) - d0);
    int x = lo, y = u0 - lo;
    const int stop = min(u0 + kItems, u_end);
    for (int u = u0; u < stop; ++u) {
      while (u == seg_end) {  // segment done: on to the next one
        ++s;
        a_end = off.A(s + 1);
        b_end = off.B(s + 1);
        a_lim = static_cast<int>(min(a_end, A1) - A0);
        b_lim = static_cast<int>(min(b_end, Bx) - B0);
        seg_end = static_cast<int>(min(a_end + b_end, d1) - d0);
      }
      // both reads stay inside keys[]; past a range they are ignored
      const long long ka = sa[x], kb = sb[y];
      const bool has_b = y < b_lim;
      const bool take_a = x < a_lim && (!has_b || ka <= kb);
      if (take_a) sh[x] = has_b && ka == kb;
      x += take_a;
      y += !take_a;
    }
  }
  __syncthreads();
  // out[A0:A1] in 16-byte stores; partial chunks at the ends byte by byte
  const long long chunks = static_cast<long long>((o1 - obase + 15) / 16);
  for (long long c = threadIdx.x; c < chunks; c += kThreads) {
    const uintptr_t g = obase + 16 * c;
    if (g >= o0 && g + 16 <= o1) {
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(hit + 16 * c);
    } else {
      for (int q = 0; q < 16; ++q) {
        if (g + q >= o0 && g + q < o1)
          *reinterpret_cast<unsigned char*>(g + q) = hit[16 * c + q];
      }
    }
  }
}

// lower_bound of x in b[lo:hi]
__device__ __forceinline__ long long lower_bound(const long long* b,
                                                 long long lo, long long hi,
                                                 long long x) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ldg(b + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
member_search_kernel(const long long* __restrict__ a, long long n,
                     const long long* __restrict__ b,
                     const __grid_constant__ Offsets off, long long S,
                     unsigned char* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i - (threadIdx.x & 31) >= n) return;  // the whole warp is past the end
  const long long k = min(i, n - 1);  // lanes past the end join the last key
  // the key's segment: the last that starts at or before k
  long long s = 0;
  for (long long hi = S - 1; s < hi;) {
    const long long mid = s + (hi - s + 1) / 2;
    if (off.A(mid) <= k) s = mid; else hi = mid - 1;
  }
  const long long x = __ldg(a + k);
  const long long b_lo = off.B(s), b_hi = off.B(s + 1);
  // the lanes of this segment find their window of b from their first and
  // last key
  const unsigned group = __match_any_sync(kFull, s);
  const int lane = threadIdx.x & 31;
  const int first = __ffs(group) - 1, last = 31 - __clz(group);
  long long edge = 0;
  if (lane == first || lane == last) edge = lower_bound(b, b_lo, b_hi, x);
  const long long w_lo = __shfl_sync(kFull, edge, first);
  const long long w_hi = __shfl_sync(kFull, edge, last);
  const long long pos = lower_bound(b, w_lo, w_hi, x);
  if (i < n) out[i] = pos < b_hi && __ldg(b + pos) == x;
}

int launch_merge(const long long* a, long long n, const long long* b,
                 long long m, const Offsets& off, long long S,
                 long long* ranks, unsigned char* o, cudaStream_t st) {
  constexpr long long kTile = static_cast<long long>(kThreads) * kItems;
  const long long tiles = (n + m + kTile - 1) / kTile;
  if (tiles > 1) {
    const long long edge_blocks =
        ((tiles + 1) * kEdgeLanes + kThreads - 1) / kThreads;
    member_partition_kernel<<<static_cast<unsigned>(edge_blocks), kThreads,
                              0, st>>>(a, n, b, m, off, S, kTile, tiles, ranks);
  }
  member_merge_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      a, n, b, m, off, S, tiles > 1 ? ranks : nullptr, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route: 0 takes the search route, 1 the merge route, whose tile edges go
// to scratch: 2 (tiles + 1) int64 for tiles of 256 x 15, where there is
// more than one tile.  a_off and b_off are the S + 1 offsets, from 0 to n
// and to m, which the wrapper has checked: on the host, read here, where
// S <= 64; else on the device (offs_dev: a's, then b's).
extern "C" int sorted_member_mask(const void* a, long long n,
                                  const void* a_off, const void* b,
                                  long long m, const void* b_off,
                                  const void* offs_dev, long long S,
                                  void* out, void* scratch, int route,
                                  void* stream) {
  const auto* a_ = static_cast<const long long*>(a);
  const auto* b_ = static_cast<const long long*>(b);
  auto* o = static_cast<unsigned char*>(out);
  auto* ranks = static_cast<long long*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Offsets off{};
  if (offs_dev != nullptr) {
    off.a_dev = static_cast<const long long*>(offs_dev);
    off.b_dev = off.a_dev + S + 1;
  } else if (S <= kInline) {
    for (long long s = 0; s <= S; ++s) {
      off.a[s] = static_cast<const long long*>(a_off)[s];
      off.b[s] = static_cast<const long long*>(b_off)[s];
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (route) {
    case kRouteSearch: {
      const long long blocks = (n + kThreads - 1) / kThreads;
      member_search_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          a_, n, b_, off, S, o);
      return static_cast<int>(cudaGetLastError());
    }
    case kRouteMerge: return launch_merge(a_, n, b_, m, off, S, ranks, o, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
