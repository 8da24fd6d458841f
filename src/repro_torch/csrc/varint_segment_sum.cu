// varint_segment_sum: step 3 of the byte-parallel LEB128 posting decode.
//
// Replaces src/repro/kernels/posting_decode/kernel.py::varint_unpack_kernel
// (Pallas, TPU).  Byte k of a terminator-aligned varint stream carries a
// shifted payload contrib[k] and the id vid[k] of the varint it belongs to
// (ids sorted, every id in [0, n_values) present); the kernel computes
//     out[v] = sum of contrib[k] over the bytes with vid[k] == v.
// Payloads of one varint occupy disjoint bit ranges, so the sum IS the
// decoded value, exact in int64 for varints of any width.
//
// Bound on an H100: bytes.  Each stream byte costs 16 B of reads (an int64
// id and an int64 payload) and each value 8 B of writes, against a few
// integer adds: the least time is those bytes over 3.35 TB/s.
//
// Design: one thread per byte, so loads are coalesced 8-byte words.  The
// TPU kernel broadcast-compared tiles of output slots against tiles of bytes
// because its vector unit favours dense compares; here each warp reduces its
// 32 bytes by segment with shuffles (ids are sorted, so a segment is a run
// of lanes: five suffix-scan steps), and only the first lane of each run
// writes, with one 64-bit atomicAdd.  A varint has at most 10 bytes, so a
// run crosses at most one warp boundary and at most two atomics meet on one
// slot; integer atomics commute, so the result does not depend on their
// order.  The caller passes a zeroed output.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void varint_segment_sum_kernel(const long long* __restrict__ vid,
                                          const long long* __restrict__ contrib,
                                          long long n_bytes,
                                          unsigned long long* __restrict__ out,
                                          long long n_values) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const bool valid = i < n_bytes;
  const long long id = valid ? __ldg(vid + i) : -1;
  unsigned long long sum =
      valid ? static_cast<unsigned long long>(__ldg(contrib + i)) : 0ull;
  // segmented suffix sum: after the step with offset d, lane l holds the
  // sum over lanes [l, l + 2d) that share its id
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long s = __shfl_down_sync(0xffffffffu, sum, d);
    const long long o = __shfl_down_sync(0xffffffffu, id, d);
    if (lane + d < 32 && o == id) sum += s;
  }
  const long long prev = __shfl_up_sync(0xffffffffu, id, 1);
  const bool head = lane == 0 || prev != id;
  if (valid && head && id >= 0 && id < n_values) atomicAdd(out + id, sum);
}

}  // namespace

extern "C" int varint_segment_sum(const void* vid, const void* contrib,
                                  long long n_bytes, void* out,
                                  long long n_values, void* stream) {
  if (n_bytes > 0) {
    const long long blocks = (n_bytes + kThreads - 1) / kThreads;
    varint_segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(vid),
        static_cast<const long long*>(contrib), n_bytes,
        static_cast<unsigned long long*>(out), n_values);
  }
  return static_cast<int>(cudaGetLastError());
}
