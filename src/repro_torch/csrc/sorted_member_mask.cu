// sorted_member_mask: out[i] = (a[i] occurs in b), a and b sorted int64.
//
// Replaces src/repro/kernels/intersect/kernel.py::intersect_kernel (Pallas,
// TPU): the doc-id prefilter of the window join and of the fused
// decode-then-intersect entry point.  b holds no duplicates.
//
// Bound on an H100: bytes.  Every element of a and b is read once (8 B
// each) and every mask byte written once; the compares are few next to
// those bytes, so the least time is (8N + 8M + N) B over 3.35 TB/s.
//
// Design: one thread per element of a runs a lower-bound binary search in
// b: O(N log M) compares where the TPU's dense tile compare did O(N * M)
// with a block-corner skip.  Because a is sorted, the threads of a warp
// search for neighbouring keys and walk nearly the same path through b, so
// the top levels of every search are shared cache lines (L1, then the 50 MB
// L2) and device memory sees each line of b about once.  Keys are int64, so
// doc ids need no width gate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void sorted_member_mask_kernel(const long long* __restrict__ a,
                                          long long n,
                                          const long long* __restrict__ b,
                                          long long m,
                                          unsigned char* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long x = __ldg(a + i);
  long long lo = 0;
  long long hi = m;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(b + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = (lo < m && __ldg(b + lo) == x) ? 1 : 0;
}

}  // namespace

extern "C" int sorted_member_mask(const void* a, long long n, const void* b,
                                  long long m, void* out, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    sorted_member_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(a), n,
        static_cast<const long long*>(b), m,
        static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
