// adamw: one leaf's whole AdamW update in one pass over memory,
//   g   = float(g) * scale
//   mu  = mu * b1 + c1 * g              (c1 = 1 - b1)
//   nu  = nu * b2 + (c2 * g) * g        (c2 = 1 - b2)
//   upd = lr * (mu / bc1 / (sqrt(nu / bc2) + eps) + wd * p)
//   p   = p - upd                       (rounded to nearest even for bf16 p)
// each operation rounded once to f32, in this order, as the plain version
// (kernels/adamw/kernel.py::adamw_leaf_plain) takes them, one PyTorch op
// each.  The explicitly rounded intrinsics keep nvcc from contracting a
// product and a sum into one FMA, which the plain version's separate kernels
// never do, so p, mu and nu equal the plain version's bit for bit.  The
// constants b1, c1, b2, c2, eps and wd come as floats, each rounded once
// from the optimizer's double, as PyTorch rounds a Python scalar operand;
// scale, lr, bc1 and bc2 are 0-d f32 tensors the optimizer computed on the
// device, read here through their pointers, so no value goes to the host.
// mu and nu are f32; p and g are both f32 or both bf16, as autograd gives
// each gradient its leaf's dtype.  In and out pointers may be
// the same (the trainer's donated step updates p, mu and nu in place): each
// element is read and then written by one thread.
//
// Replaces no TPU kernel: the reference's AdamW (src/repro/train/optim.py)
// is plain jnp arithmetic that XLA fuses into one pass a leaf, with no
// Pallas kernel behind it.  It is added because PyTorch runs the same
// arithmetic eagerly as about 15 kernels a leaf, each reading or writing a
// full-size f32 temporary: on the card that was 169 ms of DLRM training's
// 206 ms step, about six times the bytes the update needs.
//
// Bound on an H100: bytes.  An element reads p, g, mu and nu once and writes
// p, mu and nu once, 28 B with f32 p and g (22 B with bf16), for 17
// f32 operations (three divisions and a square root among them): about 0.6
// an operation a byte, where the 32-bit units would need about 20 (67
// TFLOP/s over 3.35 TB/s).
// The design:
//   * one pass and no temporaries: each operand is read once and each result
//     written once, the whole update kept in registers;
//   * a thread works on quads, 4 consecutive elements: an f32 operand is one
//     16-byte vector (float4) a quad, a bf16 one 8 bytes; neighbouring
//     threads take neighbouring quads, so a warp reads each operand as 512
//     (f32) or 256 (bf16) contiguous bytes, whole 32-byte sectors.  The f32
//     moments set the quad: a bf16 operand read 8 elements a vector would
//     put a thread's elements on two quads of the moments, 32 bytes apart;
//   * kQuads quads a thread an iteration, every load issued before any
//     arithmetic: 256 bytes of loads in flight a thread with f32 p and g, 128
//     KB an SM at two blocks of 256 threads, several times the bytes that
//     cover the memory's latency at full bandwidth;
//   * a grid-stride loop over kWaves waves of the blocks the SMs hold at
//     once, so a leaf of any size is one launch and the blocks' shares differ
//     by at most one tile;
//   * streaming cache hints (ld.global.cs, st.global.cs): nothing is read
//     twice, so the leaf should not push other data out of L2;
//   * a masked scalar tail, one element a thread, for the n % 4 elements
//     after the last whole quad; where any pointer is not aligned to its
//     vector (a leaf that is an offset view), the whole leaf takes the
//     scalar loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 4;   // quads a thread loads before it computes
constexpr int kWaves = 4;   // the grid: waves of the blocks the SMs hold
constexpr int kMaxDevices = 64;

using bf16_bits = uint16_t;

// the constants the optimizer gives as Python floats, each rounded once
struct Consts {
  float b1, c1, b2, c2, eps, wd;
};

// the 0-d f32 tensors the optimizer computed on the device
struct Scalars {
  float scale, lr, bc1, bc2;
};

__device__ __forceinline__ void update(float& p, float g, float& mu,
                                       float& nu, const Scalars& s,
                                       const Consts& c) {
  g = __fmul_rn(g, s.scale);
  mu = __fadd_rn(__fmul_rn(mu, c.b1), __fmul_rn(c.c1, g));
  nu = __fadd_rn(__fmul_rn(nu, c.b2), __fmul_rn(__fmul_rn(c.c2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, s.bc2)), c.eps);
  const float step = __fdiv_rn(__fdiv_rn(mu, s.bc1), den);
  const float upd = __fmul_rn(s.lr, __fadd_rn(step, __fmul_rn(c.wd, p)));
  p = __fsub_rn(p, upd);
}

__device__ __forceinline__ float widen(bf16_bits x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ bf16_bits narrow(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// quad q of an operand, widened to f32
__device__ __forceinline__ void load4(const float* x, int64_t q,
                                      float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(x) + q);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const bf16_bits* x, int64_t q,
                                      float (&v)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(x) + q);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* x, int64_t q,
                                       const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(x) + q,
         make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store4(bf16_bits* x, int64_t q,
                                       const float (&v)[4]) {
  const uint32_t lo = narrow(v[0]) | static_cast<uint32_t>(narrow(v[1])) << 16;
  const uint32_t hi = narrow(v[2]) | static_cast<uint32_t>(narrow(v[3])) << 16;
  __stcs(reinterpret_cast<uint2*>(x) + q, make_uint2(lo, hi));
}

__device__ __forceinline__ float load1(const float* x, int64_t i) {
  return __ldcs(x + i);
}

__device__ __forceinline__ float load1(const bf16_bits* x, int64_t i) {
  return widen(__ldcs(x + i));
}

__device__ __forceinline__ void store1(float* x, int64_t i, float v) {
  __stcs(x + i, v);
}

__device__ __forceinline__ void store1(bf16_bits* x, int64_t i, float v) {
  __stcs(x + i, narrow(v));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
adamw_kernel(const T* p, T* p_out, const T* g, const float* mu, float* mu_out,
             const float* nu, float* nu_out, int64_t n, const float* scale,
             const float* lr, const float* bc1, const float* bc2, Consts c) {
  const Scalars s{__ldg(scale), __ldg(lr), __ldg(bc1), __ldg(bc2)};
  int64_t head = 0;
  if constexpr (kVec) {
    const int64_t nq = n / 4;
    constexpr int64_t tile = static_cast<int64_t>(kThreads) * kQuads;
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * tile; base < nq;
         base += static_cast<int64_t>(gridDim.x) * tile) {
      float vp[kQuads][4], vg[kQuads][4], vm[kQuads][4], vn[kQuads][4];
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const int64_t q = base + j * kThreads + threadIdx.x;
        if (q < nq) {
          load4(p, q, vp[j]);
          load4(g, q, vg[j]);
          load4(mu, q, vm[j]);
          load4(nu, q, vn[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const int64_t q = base + j * kThreads + threadIdx.x;
        if (q < nq) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            update(vp[j][e], vg[j][e], vm[j][e], vn[j][e], s, c);
          store4(p_out, q, vp[j]);
          store4(mu_out, q, vm[j]);
          store4(nu_out, q, vn[j]);
        }
      }
    }
    head = nq * 4;
  }
  for (int64_t i = head + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    float vp = load1(p, i), vm = load1(mu, i), vn = load1(nu, i);
    update(vp, load1(g, i), vm, vn, s, c);
    store1(p_out, i, vp);
    store1(mu_out, i, vm);
    store1(nu_out, i, vn);
  }
}

// blocks an SM holds of one instance, read once a device and instance
template <typename T, bool kVec>
int resident_blocks(int device) {
  static int cached[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (cached[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, adamw_kernel<T, kVec>, kThreads, 0) != cudaSuccess)
      return 0;
    cached[device] = sms * per_sm;
  }
  return cached[device];
}

template <typename T, bool kVec>
cudaError_t run(const void* p, void* p_out, const void* g, const void* mu,
                void* mu_out, const void* nu, void* nu_out, int64_t n,
                const void* scale, const void* lr, const void* bc1,
                const void* bc2, Consts c, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int resident = resident_blocks<T, kVec>(device);
  if (resident <= 0) {
    err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  const int64_t per_block =
      kVec ? static_cast<int64_t>(kThreads) * kQuads * 4 : kThreads;
  const int64_t needed = (n + per_block - 1) / per_block;
  const int64_t most = static_cast<int64_t>(resident) * kWaves;
  const int blocks = static_cast<int>(needed < most ? needed : most);
  adamw_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<T*>(p_out),
      static_cast<const T*>(g), static_cast<const float*>(mu),
      static_cast<float*>(mu_out), static_cast<const float*>(nu),
      static_cast<float*>(nu_out), n, static_cast<const float*>(scale),
      static_cast<const float*>(lr), static_cast<const float*>(bc1),
      static_cast<const float*>(bc2), c);
  return cudaGetLastError();
}

bool aligned(const void* x, int bytes) {
  return reinterpret_cast<uintptr_t>(x) % bytes == 0;
}

template <typename T>
cudaError_t dispatch(const void* p, void* p_out, const void* g,
                     const void* mu, void* mu_out, const void* nu,
                     void* nu_out, int64_t n, const void* scale,
                     const void* lr, const void* bc1, const void* bc2,
                     Consts c, cudaStream_t stream) {
  constexpr int v = 4 * sizeof(T);
  if (aligned(p, v) && aligned(p_out, v) && aligned(g, v) &&
      aligned(mu, 16) && aligned(mu_out, 16) && aligned(nu, 16) &&
      aligned(nu_out, 16))
    return run<T, true>(p, p_out, g, mu, mu_out, nu, nu_out, n, scale, lr,
                        bc1, bc2, c, stream);
  return run<T, false>(p, p_out, g, mu, mu_out, nu, nu_out, n, scale, lr, bc1,
                       bc2, c, stream);
}

}  // namespace

// dtype, of p and g: 0 f32, 1 bf16 (cuda_lib.FLOAT_CODES).  n elements of
// each operand, contiguous; with p_out == p, mu_out == mu and nu_out == nu
// the update is in place.
extern "C" int adamw(const void* p, void* p_out, const void* g,
                     const void* mu, void* mu_out, const void* nu,
                     void* nu_out, long long n, const void* scale,
                     const void* lr, const void* bc1, const void* bc2,
                     float b1, float c1, float b2, float c2, float eps,
                     float wd, int dtype, void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Consts c{b1, c1, b2, c2, eps, wd};
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(p, p_out, g, mu, mu_out, nu, nu_out, n,
                                   scale, lr, bc1, bc2, c, s)
                 : dispatch<bf16_bits>(p, p_out, g, mu, mu_out, nu, nu_out, n,
                                       scale, lr, bc1, bc2, c, s);
  return static_cast<int>(err);
}
