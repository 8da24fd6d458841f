// flash_attention_backward(_mma): the gradient of flash attention,
// (dq, dk, dv) of o[b,h] = softmax(q[b,h] k[b,h/G]^T / sqrt(D)) v[b,h/G],
// causal or not, from the saved q, k, v, output o, the forward's base-2
// log-sum-exp lse and the output's gradient dO.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (Pallas, TPU) under autograd: the reference has no backward kernel and
// differentiates its jnp attention with jax.grad.  The port launches its
// forward kernels under an autograd.Function, and this file is that
// Function's backward on the card (kernels/flash_attention/kernel.py::
// run_backward), in place of the plain PyTorch backward, which stays for
// CPU tensors.
//
// Each entry point launches three kernels on the caller's stream:
//  (a) a row pass, delta_i = sum_d dO_id o_id in f32, from the saved
//      output.  The plain version takes delta from the same saved output
//      when it is given one (ref.py::flash_attention_backward_plain), so
//      the card's check compares like with like; in f32, where the CPU
//      tests hold the plain backward to jax.grad, the saved output is the
//      recomputed one.  The other way, delta = sum_j P_ij dP_ij on a pass
//      of its own over the keys, would cost two more products a pair.
//  (b) dK/dV: one block per (b, KV head, 64-key tile).  It loops over the
//      G query heads of its group and over the query tiles at or below
//      the diagonal, recomputes P^T = exp2(s c - lse) (c = log2(e) /
//      sqrt(D)) and dS^T = P^T o (dP^T - delta), and sums dV += P^T dO
//      and dK += dS^T Q in registers: the GQA sum over the group needs no
//      atomics.
//  (c) dQ: one block per (b, head, 64-query tile), over the key tiles up
//      to the diagonal: it recomputes S and dP, and sums dQ += dS K.
// Each of dq, dk and dv is written once, in the operands' dtype, by one
// thread in a fixed order of sums: no float atomics, so two calls on the
// same inputs give the same bits (a one-rank mesh step is held bit for bit
// to the unsharded one).
//
// Bound on an H100: operations.  Five products of 2 D flops a (query,
// key) pair and head (q k^T and dO v^T again, P^T dO, dS^T q, dS k):
// 10 B H D S (S + 1) / 2 flops over 989 TFLOP/s at causal prefill
// lengths, against q, k, v, o, dO read and dq, dk, dv written once over
// 3.35 TB/s.
//
// The bf16 route (D 64 and 128; flash_attention_backward_mma) runs the
// products on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  Tiles are staged by cp.async (double-buffered where they
// stream) into shared memory rows padded by 16 bytes, so ldmatrix is free
// of bank conflicts; ldmatrix and ldmatrix.trans read one staged tile of Q,
// K, V or dO in either orientation, which the five products need (P^T and
// dS^T are A operands made from the f32 accumulators in registers).  Why
// not wgmma: P^T and dS^T as A operands and four operands in both
// orientations; mma.sync reaches all of them from one tile.  P and dS go
// through their products as bf16 hi + lo pairs into one f32 accumulator,
// as the forward's P V does: rounded once to bf16 they err by 2^-9 of the
// sum of |terms|, which outputs near zero cannot absorb.  That makes ten
// products where the bound counts five.  Each streamed tile's share of dK,
// dV or dQ is summed on the tensor cores from zero and added to the
// running sum in f32 (promote, below): summed straight on the tensor
// cores, the running sums lost too many low bits.
//
// The scalar route (f32 at any D, bf16 at D 8 to 32;
// flash_attention_backward) is the same three steps on f32 FMAs: four
// threads a row, each a quarter of D, the dot products summed across the
// quad.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;   // rows a block owns: keys in (b), queries in (c)

struct Strides {
  long long b, h, s;  // elements; D is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ------------------------------------------------------------ (a) row pass
// One thread a (b, h, s) row; delta is (B, H, S) contiguous.
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int H, int S, int D, long long rows,
             Strides so, Strides sdo) {
  const long long row = blockIdx.x * 256LL + threadIdx.x;
  if (row >= rows) return;
  const long long bh = row / S;
  const int s = static_cast<int>(row % S);
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const T* orow = o + b * so.b + h * so.h + s * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + s * sdo.s;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
  delta[row] = acc;
}

// ----------------------------------------------------- bf16: mma.sync route
constexpr int kMmaThreads = 128;   // 4 warps, 16 owned rows each

template <int D>
struct Mma {
  static constexpr int kP = D + 8;                // padded row, bf16
  static constexpr int kN = D == 64 ? 64 : 32;    // rows of a streamed tile
  static constexpr int kBytes = (2 * kRows + 4 * kN) * kP * 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; 0 bytes read (zeros written) when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d(16 x 8) += a(16 x 16, row) b(16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as a bf16 pair hi = bf16(x, y) and lo = bf16 of the remainder.
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi, lo) of a 16 x 16 chunk from the f32 C fragments of
// its two 8-column halves: the m16n8 C layout is the A layout of k16.
__device__ __forceinline__ void a_of_c(const float (&c0)[4],
                                       const float (&c1)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// acc += part, in f32 on the CUDA cores.  An mma adds its k16 products to
// its accumulator in fewer bits than an f32 add keeps: summed straight into
// dK and dV over a whole key's row (thousands of mmas at S 4,096), that
// loss put gradients near zero, whose terms sum to far more than they do,
// past the card's check (1.7 and 3.5 times its limit at granite's
// training shape on an H100).  So each tile's share starts from zero and
// is promoted here.
__device__ __forceinline__ void promote(float (&acc)[4],
                                        const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// Copy rows [row0, row0 + n) of one head (D contiguous, row stride `rs`)
// into shared memory at pitch Mma<D>::kP; rows past S arrive as zeros.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long rs,
                                      int row0, int n, int S) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* from = ok ? src + (row0 + r) * rs + c * 8 : src;
    cp_async16(smem_u32(dst + r * Mma<D>::kP + c * 8), from, ok);
  }
}

// Shared-memory addresses, per lane, of the ldmatrix.x4 loads of a
// 16 x 16 chunk at (row0, col0) of a tile of pitch kP:
//  * a_addr: an A fragment of a row-major [m][k] tile;
//  * b_addr: the B fragments (b0, b1) of two 8-wide n tiles from an
//    [n][k] tile (k contiguous): regs 0-1 n tile 0, 2-3 n tile 1;
//  * bt_addr: the same from a [k][n] tile (n contiguous), with .trans.
template <int kP>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int row0, int col0,
                                           int lane) {
  return base + ((row0 + (lane & 15)) * kP + col0 + (lane >> 4) * 8) * 2;
}
template <int kP>
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int n0, int k0,
                                           int lane) {
  return base +
         ((n0 + (lane & 7) + ((lane >> 4) << 3)) * kP + k0 +
          ((lane >> 3) & 1) * 8) * 2;
}
template <int kP>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int k0, int n0,
                                            int lane) {
  return base +
         ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kP + n0 +
          (lane >> 4) * 8) * 2;
}

// Store a warp's 16 x D f32 accumulator, times `mul`, as bf16 rows
// row0 + g and row0 + g + 8 (those below S).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs,
                                           const float (&acc)[D / 8][4],
                                           int row0, int S, float mul,
                                           int lane) {
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + g + 8 * j;
    if (row >= S) continue;
    __nv_bfloat16* out = base + row * rs;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(out + nd * 8 + 2 * tig) =
          __floats2bfloat162_rn(acc[nd][2 * j] * mul,
                                acc[nd][2 * j + 1] * mul);
  }
}

struct Ptrs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
};

struct AllStrides {
  Strides q, k, v, dout, dq, dk, dv;
};

// (b) dK and dV of one (b, KV head, 64-key tile).  Warp w owns keys
// k0 + 16 w .. + 15; the query tiles (kN rows) of the G heads stream
// through a 2-stage ring.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dkdv_mma_kernel(Ptrs p, AllStrides st, int H, int Hkv, int S, int causal,
                float c, float scale) {
  using M = Mma<D>;
  constexpr int kP = M::kP, kN = M::kN;
  extern __shared__ __align__(16) uint8_t sm_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(sm_raw);
  __nv_bfloat16* ks = sm;
  __nv_bfloat16* vs = ks + kRows * kP;
  __nv_bfloat16* qs = vs + kRows * kP;   // [2][kN][kP]
  __nv_bfloat16* dos = qs + 2 * kN * kP;  // [2][kN][kP]

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * kRows;  // causal: the longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  stage<D>(ks, p.k + b * st.k.b + hk * st.k.h, st.k.s, k0, kRows, S);
  stage<D>(vs, p.v + b * st.v.b + hk * st.v.h, st.v.s, k0, kRows, S);
  const int qt0 = causal ? k0 / kN : 0;
  const int nq = (S + kN - 1) / kN - qt0;  // query tiles a head
  const int n_iter = group * nq;
  auto load = [&](int it, int buf) {
    const int h = hk * group + it / nq;
    const int q0 = (qt0 + it % nq) * kN;
    stage<D>(qs + buf * kN * kP, p.q + b * st.q.b + h * st.q.h, st.q.s, q0,
             kN, S);
    stage<D>(dos + buf * kN * kP, p.dout + b * st.dout.b + h * st.dout.h,
             st.dout.s, q0, kN, S);
  };
  load(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const uint32_t ka = smem_u32(ks), va = smem_u32(vs);

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) {
      load(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int h = hk * group + it / nq;
    const int q0 = (qt0 + it % nq) * kN;
    const long long bh = static_cast<long long>(b) * H + h;
    // lse and delta of this thread's query columns; rows past S give p = 0
    float lc[kN / 8][2], dc[kN / 8][2];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = q0 + nt * 8 + 2 * tig + j;
        lc[nt][j] = col < S ? p.lse[bh * S + col] : INFINITY;
        dc[nt][j] = col < S ? p.delta[bh * S + col] : 0.f;
      }
    const uint32_t qa = smem_u32(qs + buf * kN * kP);
    const uint32_t da = smem_u32(dos + buf * kN * kP);

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x kN queries a warp
    float s[kN / 8][4], dp[kN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4], vf[4];
      ldsm(af, a_addr<kP>(ka, warp * 16, kk * 16, lane));
      ldsm(vf, a_addr<kP>(va, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < kN / 16; ++n2) {
        uint32_t bq[4], bd[4];
        ldsm(bq, b_addr<kP>(qa, n2 * 16, kk * 16, lane));
        ldsm(bd, b_addr<kP>(da, n2 * 16, kk * 16, lane));
        mma(s[2 * n2], af, bq[0], bq[1]);
        mma(s[2 * n2 + 1], af, bq[2], bq[3]);
        mma(dp[2 * n2], vf, bd[0], bd[1]);
        mma(dp[2 * n2 + 1], vf, bd[2], bd[3]);
      }
    }
    // P^T and dS^T = P^T o (dP^T - delta) in place; keys after a query
    // are masked (keys past S are never stored)
    const bool diag = causal && k0 + kRows - 1 > q0;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(fmaf(s[nt][e], c, -lc[nt][e & 1]));
        if (diag && key0 + 8 * (e >> 1) > q0 + nt * 8 + 2 * tig + (e & 1))
          pv = 0.f;
        s[nt][e] = pv;
        dp[nt][e] = pv * (dp[nt][e] - dc[nt][e & 1]);
      }
    // dV += P^T dO and dK += dS^T Q, the k dim running over the queries:
    // each 16-wide column chunk of this tile's share is summed from zero
    // on the tensor cores, then added to dV and dK in f32 (promote)
    uint32_t ph[kN / 16][4], pl[kN / 16][4], sh[kN / 16][4], sl[kN / 16][4];
#pragma unroll
    for (int kc = 0; kc < kN / 16; ++kc) {
      a_of_c(s[2 * kc], s[2 * kc + 1], ph[kc], pl[kc]);
      a_of_c(dp[2 * kc], dp[2 * kc + 1], sh[kc], sl[kc]);
    }
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      float tv[2][4] = {}, tk[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc) {
        uint32_t bd[4], bq[4];
        ldsm_t(bd, bt_addr<kP>(da, kc * 16, n2 * 16, lane));
        ldsm_t(bq, bt_addr<kP>(qa, kc * 16, n2 * 16, lane));
        mma(tv[0], ph[kc], bd[0], bd[1]);
        mma(tv[0], pl[kc], bd[0], bd[1]);
        mma(tv[1], ph[kc], bd[2], bd[3]);
        mma(tv[1], pl[kc], bd[2], bd[3]);
        mma(tk[0], sh[kc], bq[0], bq[1]);
        mma(tk[0], sl[kc], bq[0], bq[1]);
        mma(tk[1], sh[kc], bq[2], bq[3]);
        mma(tk[1], sl[kc], bq[2], bq[3]);
      }
      promote(dv[2 * n2], tv[0]);
      promote(dv[2 * n2 + 1], tv[1]);
      promote(dk[2 * n2], tk[0]);
      promote(dk[2 * n2 + 1], tk[1]);
    }
    __syncthreads();  // this buffer is read; the next load may refill it
  }
  store_rows<D>(p.dk + b * st.dk.b + hk * st.dk.h, st.dk.s, dk,
                k0 + warp * 16, S, scale, lane);
  store_rows<D>(p.dv + b * st.dv.b + hk * st.dv.h, st.dv.s, dv,
                k0 + warp * 16, S, 1.f, lane);
}

// (c) dQ of one (b, head, 64-query tile).  Warp w owns queries
// q0 + 16 w .. + 15; the key tiles (kN rows) up to the diagonal stream
// through a 2-stage ring.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(Ptrs p, AllStrides st, int H, int Hkv, int S, int causal,
              float c, float scale) {
  using M = Mma<D>;
  constexpr int kP = M::kP, kN = M::kN;
  extern __shared__ __align__(16) uint8_t sm_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(sm_raw);
  __nv_bfloat16* qs = sm;
  __nv_bfloat16* dos = qs + kRows * kP;
  __nv_bfloat16* ks = dos + kRows * kP;   // [2][kN][kP]
  __nv_bfloat16* vs = ks + 2 * kN * kP;   // [2][kN][kP]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  // the longest causal rows first, so the tail of the grid is short
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  stage<D>(qs, p.q + b * st.q.b + h * st.q.h, st.q.s, q0, kRows, S);
  stage<D>(dos, p.dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0, kRows,
           S);
  const int all_kt = (S + kN - 1) / kN;
  const int n_kt = causal ? min(all_kt, (q0 + kRows + kN - 1) / kN) : all_kt;
  const __nv_bfloat16* kb = p.k + b * st.k.b + hk * st.k.h;
  const __nv_bfloat16* vb = p.v + b * st.v.b + hk * st.v.h;
  auto load = [&](int t, int buf) {
    stage<D>(ks + buf * kN * kP, kb, st.k.s, t * kN, kN, S);
    stage<D>(vs + buf * kN * kP, vb, st.v.s, t * kN, kN, S);
  };
  load(0, 0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const long long bh = static_cast<long long>(b) * H + h;
  float lr[2], dr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    lr[j] = row < S ? p.lse[bh * S + row] : INFINITY;
    dr[j] = row < S ? p.delta[bh * S + row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  const uint32_t qa = smem_u32(qs), da = smem_u32(dos);

  for (int t = 0; t < n_kt; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_kt) {
      load(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kt0 = t * kN;
    const uint32_t ka = smem_u32(ks + buf * kN * kP);
    const uint32_t va = smem_u32(vs + buf * kN * kP);

    // S = Q K^T and dP = dO V^T, 16 queries x kN keys a warp
    float s[kN / 8][4], dp[kN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4], df[4];
      ldsm(af, a_addr<kP>(qa, warp * 16, kk * 16, lane));
      ldsm(df, a_addr<kP>(da, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n2 = 0; n2 < kN / 16; ++n2) {
        uint32_t bk[4], bv[4];
        ldsm(bk, b_addr<kP>(ka, n2 * 16, kk * 16, lane));
        ldsm(bv, b_addr<kP>(va, n2 * 16, kk * 16, lane));
        mma(s[2 * n2], af, bk[0], bk[1]);
        mma(s[2 * n2 + 1], af, bk[2], bk[3]);
        mma(dp[2 * n2], df, bv[0], bv[1]);
        mma(dp[2 * n2 + 1], df, bv[2], bv[3]);
      }
    }
    // dS = P o (dP - delta); keys past S or after the query are masked
    const bool edge = kt0 + kN > S || (causal && kt0 + kN - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(fmaf(s[nt][e], c, -lr[e >> 1]));
        const int key = kt0 + nt * 8 + 2 * tig + (e & 1);
        if (edge && (key >= S || (causal && key > row0 + 8 * (e >> 1))))
          pv = 0.f;
        dp[nt][e] = pv * (dp[nt][e] - dr[e >> 1]);
      }
    // dQ += dS K, the k dim running over the keys, promoted as in (b)
    uint32_t sh[kN / 16][4], sl[kN / 16][4];
#pragma unroll
    for (int kc = 0; kc < kN / 16; ++kc)
      a_of_c(dp[2 * kc], dp[2 * kc + 1], sh[kc], sl[kc]);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      float tq[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc) {
        uint32_t bk[4];
        ldsm_t(bk, bt_addr<kP>(ka, kc * 16, n2 * 16, lane));
        mma(tq[0], sh[kc], bk[0], bk[1]);
        mma(tq[0], sl[kc], bk[0], bk[1]);
        mma(tq[1], sh[kc], bk[2], bk[3]);
        mma(tq[1], sl[kc], bk[2], bk[3]);
      }
      promote(dq[2 * n2], tq[0]);
      promote(dq[2 * n2 + 1], tq[1]);
    }
    __syncthreads();  // this buffer is read; the next load may refill it
  }
  store_rows<D>(p.dq + b * st.dq.b + h * st.dq.h, st.dq.s, dq,
                q0 + warp * 16, S, scale, lane);
}

// ------------------------------------------------------ f32 FMA: scalar route
constexpr int kSThreads = 256;
constexpr int kTPR = kSThreads / kRows;  // threads a row: 4
constexpr int kST = 32;                  // rows of a streamed tile

template <int D>
constexpr int scalar_smem_bytes() {
  return (2 * kST * (D + 1) + 2 * kST) * static_cast<int>(sizeof(float));
}

// A quad's sum of its four partial dot products.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
struct ScalarPtrs {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  T *dq, *dk, *dv;
};

// (b) dK and dV of one (b, KV head, 64-key tile): thread 4 r + t owns key
// k0 + r and columns t, t + 4, ... of D.
template <typename T, int D>
__global__ void __launch_bounds__(kSThreads)
dkdv_scalar_kernel(ScalarPtrs<T> p, AllStrides st, int H, int Hkv, int S,
                   int causal, float c, float scale) {
  constexpr int kDT = D / kTPR;
  extern __shared__ float fs[];
  float* qs = fs;                 // kST x (D + 1)
  float* dos = qs + kST * (D + 1);  // kST x (D + 1)
  float* ls = dos + kST * (D + 1);  // kST
  float* ds = ls + kST;             // kST

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, t = tid % kTPR;
  const int key = k0 + tid / kTPR;
  const bool valid = key < S;
  float kr[kDT], vr[kDT], dk[kDT], dv[kDT];
  {
    const T* krow = p.k + b * st.k.b + hk * st.k.h + key * st.k.s;
    const T* vrow = p.v + b * st.v.b + hk * st.v.h + key * st.v.s;
#pragma unroll
    for (int dd = 0; dd < kDT; ++dd) {
      kr[dd] = valid ? to_f32(krow[dd * kTPR + t]) : 0.f;
      vr[dd] = valid ? to_f32(vrow[dd * kTPR + t]) : 0.f;
      dk[dd] = dv[dd] = 0.f;
    }
  }
  const int qstart = causal ? k0 : 0;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* qb = p.q + b * st.q.b + h * st.q.h;
    const T* db = p.dout + b * st.dout.b + h * st.dout.h;
    const long long bh = static_cast<long long>(b) * H + h;
    for (int q0 = qstart; q0 < S; q0 += kST) {
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < kST * D; i += kSThreads) {
        const int r = i / D, d = i % D;
        const int row = q0 + r;
        const bool ok = row < S;
        qs[r * (D + 1) + d] = ok ? to_f32(qb[row * st.q.s + d]) : 0.f;
        dos[r * (D + 1) + d] = ok ? to_f32(db[row * st.dout.s + d]) : 0.f;
      }
      if (tid < kST) {
        const int row = q0 + tid;
        ls[tid] = row < S ? p.lse[bh * S + row] : INFINITY;
        ds[tid] = row < S ? p.delta[bh * S + row] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < kST; ++i) {
        const float* qrow = qs + i * (D + 1);
        const float* drow = dos + i * (D + 1);
        float sc = 0.f, dp = 0.f;
#pragma unroll
        for (int dd = 0; dd < kDT; ++dd) {
          sc = fmaf(kr[dd], qrow[dd * kTPR + t], sc);
          dp = fmaf(vr[dd], drow[dd * kTPR + t], dp);
        }
        sc = quad_sum(sc);
        dp = quad_sum(dp);
        float pv = exp2f(fmaf(sc, c, -ls[i]));
        if (causal && key > q0 + i) pv = 0.f;
        const float dsv = pv * (dp - ds[i]);
#pragma unroll
        for (int dd = 0; dd < kDT; ++dd) {
          dv[dd] = fmaf(pv, drow[dd * kTPR + t], dv[dd]);
          dk[dd] = fmaf(dsv, qrow[dd * kTPR + t], dk[dd]);
        }
      }
    }
  }
  if (valid) {
    T* dkrow = p.dk + b * st.dk.b + hk * st.dk.h + key * st.dk.s;
    T* dvrow = p.dv + b * st.dv.b + hk * st.dv.h + key * st.dv.s;
#pragma unroll
    for (int dd = 0; dd < kDT; ++dd) {
      store(dkrow + dd * kTPR + t, dk[dd] * scale);
      store(dvrow + dd * kTPR + t, dv[dd]);
    }
  }
}

// (c) dQ of one (b, head, 64-query tile): thread 4 r + t owns query
// q0 + r and columns t, t + 4, ... of D.
template <typename T, int D>
__global__ void __launch_bounds__(kSThreads)
dq_scalar_kernel(ScalarPtrs<T> p, AllStrides st, int H, int Hkv, int S,
                 int causal, float c, float scale) {
  constexpr int kDT = D / kTPR;
  extern __shared__ float fs[];
  float* ks = fs;                  // kST x (D + 1)
  float* vs = ks + kST * (D + 1);  // kST x (D + 1)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, t = tid % kTPR;
  const int row = q0 + tid / kTPR;
  const bool valid = row < S;
  const long long bh = static_cast<long long>(b) * H + h;
  float qr[kDT], dr[kDT], dq[kDT];
  {
    const T* qrow = p.q + b * st.q.b + h * st.q.h + row * st.q.s;
    const T* drow = p.dout + b * st.dout.b + h * st.dout.h + row * st.dout.s;
#pragma unroll
    for (int dd = 0; dd < kDT; ++dd) {
      qr[dd] = valid ? to_f32(qrow[dd * kTPR + t]) : 0.f;
      dr[dd] = valid ? to_f32(drow[dd * kTPR + t]) : 0.f;
      dq[dd] = 0.f;
    }
  }
  const float lse = valid ? p.lse[bh * S + row] : INFINITY;
  const float delta = valid ? p.delta[bh * S + row] : 0.f;
  const T* kb = p.k + b * st.k.b + hk * st.k.h;
  const T* vb = p.v + b * st.v.b + hk * st.v.h;
  const int kend = causal ? min(S, q0 + kRows) : S;
  for (int k0 = 0; k0 < kend; k0 += kST) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kST * D; i += kSThreads) {
      const int r = i / D, d = i % D;
      const int kr = k0 + r;
      const bool ok = kr < S;
      ks[r * (D + 1) + d] = ok ? to_f32(kb[kr * st.k.s + d]) : 0.f;
      vs[r * (D + 1) + d] = ok ? to_f32(vb[kr * st.v.s + d]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kST; ++j) {
      const float* krow = ks + j * (D + 1);
      const float* vrow = vs + j * (D + 1);
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < kDT; ++dd) {
        sc = fmaf(qr[dd], krow[dd * kTPR + t], sc);
        dp = fmaf(dr[dd], vrow[dd * kTPR + t], dp);
      }
      sc = quad_sum(sc);
      dp = quad_sum(dp);
      const int key = k0 + j;
      float pv = exp2f(fmaf(sc, c, -lse));
      if (key >= S || (causal && key > row)) pv = 0.f;
      const float dsv = pv * (dp - delta);
#pragma unroll
      for (int dd = 0; dd < kDT; ++dd)
        dq[dd] = fmaf(dsv, krow[dd * kTPR + t], dq[dd]);
    }
  }
  if (valid) {
    T* dqrow = p.dq + b * st.dq.b + h * st.dq.h + row * st.dq.s;
#pragma unroll
    for (int dd = 0; dd < kDT; ++dd) store(dqrow + dd * kTPR + t, dq[dd] * scale);
  }
}

// --------------------------------------------------------------- launches
struct Problem {
  int B, H, Hkv, S, D, causal;
  float scale;
  Strides o;
  AllStrides st;
};

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta,
                 const Problem& pr, cudaStream_t stream) {
  const long long rows = static_cast<long long>(pr.B) * pr.H * pr.S;
  const unsigned blocks = static_cast<unsigned>((rows + 255) / 256);
  delta_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, pr.H,
      pr.S, pr.D, rows, pr.o, pr.st.dout);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const Ptrs& p, const Problem& pr, cudaStream_t stream) {
  constexpr int smem = Mma<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((pr.S + kRows - 1) / kRows);
  const float c = pr.scale * kLog2e;
  dkdv_mma_kernel<D><<<dim3(pr.B * pr.Hkv, tiles), kMmaThreads, smem,
                       stream>>>(p, pr.st, pr.H, pr.Hkv, pr.S, pr.causal, c,
                                 pr.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_mma_kernel<D><<<dim3(pr.B * pr.H, tiles), kMmaThreads, smem, stream>>>(
      p, pr.st, pr.H, pr.Hkv, pr.S, pr.causal, c, pr.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_scalar(const ScalarPtrs<T>& p, const Problem& pr,
                  cudaStream_t stream) {
  constexpr int smem = scalar_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_scalar_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_scalar_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((pr.S + kRows - 1) / kRows);
  const float c = pr.scale * kLog2e;
  dkdv_scalar_kernel<T, D><<<dim3(pr.B * pr.Hkv, tiles), kSThreads, smem,
                             stream>>>(p, pr.st, pr.H, pr.Hkv, pr.S,
                                       pr.causal, c, pr.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_scalar_kernel<T, D><<<dim3(pr.B * pr.H, tiles), kSThreads, smem,
                           stream>>>(p, pr.st, pr.H, pr.Hkv, pr.S, pr.causal,
                                     c, pr.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scalar_dispatch(const ScalarPtrs<T>& p, const Problem& pr,
                    cudaStream_t stream) {
  switch (pr.D) {
    case 8: return launch_scalar<T, 8>(p, pr, stream);
    case 16: return launch_scalar<T, 16>(p, pr, stream);
    case 32: return launch_scalar<T, 32>(p, pr, stream);
    case 64: return launch_scalar<T, 64>(p, pr, stream);
    case 128: return launch_scalar<T, 128>(p, pr, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Problem problem(int B, int H, int Hkv, int S, int D, const long long* s,
                int causal, float scale) {
  auto at = [s](int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; };
  return Problem{B, H, Hkv, S, D, causal, scale, at(3),
                 AllStrides{at(0), at(1), at(2), at(4), at(5), at(6), at(7)}};
}

}  // namespace

// q, o, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Hkv, S, D), each
// addressed through (batch, head, seq) strides in elements, D contiguous;
// the strides come in the order q, k, v, o, dout, dq, dk, dv.  lse (the
// forward's, base 2) and delta (scratch, written here) are (B, H, S) f32
// contiguous.  dq, dk and dv are written whole.

// bf16 at D 64 or 128: q, k, v and dout need 16-byte aligned bases and
// strides (of the dims longer than 1) that are multiples of 8 elements.
extern "C" int flash_attention_backward_mma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob, long long soh,
    long long sos, long long sdob, long long sdoh, long long sdos,
    long long sdqb, long long sdqh, long long sdqs, long long sdkb,
    long long sdkh, long long sdks, long long sdvb, long long sdvh,
    long long sdvs, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long s[24] = {sqb,  sqh,  sqs,  skb,  skh,  sks,  svb,  svh,
                           svs,  sob,  soh,  sos,  sdob, sdoh, sdos, sdqb,
                           sdqh, sdqs, sdkb, sdkh, sdks, sdvb, sdvh, sdvs};
  const Problem pr = problem(B, H, Hkv, S, D, s, causal, scale);
  auto st = static_cast<cudaStream_t>(stream);
  const Ptrs p{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<__nv_bfloat16*>(dq),
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv)};
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_delta<__nv_bfloat16>(o, dout,
                                              static_cast<float*>(delta), pr,
                                              st);
  if (err != 0) return err;
  return D == 64 ? launch_mma<64>(p, pr, st) : launch_mma<128>(p, pr, st);
}

// dtype: 0 float32, 1 bfloat16; D in {8, 16, 32, 64, 128}.
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int Hkv, int S, int D, long long sqb,
    long long sqh, long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, long long sob, long long soh,
    long long sos, long long sdob, long long sdoh, long long sdos,
    long long sdqb, long long sdqh, long long sdqs, long long sdkb,
    long long sdkh, long long sdks, long long sdvb, long long sdvh,
    long long sdvs, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D != 8 && D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long s[24] = {sqb,  sqh,  sqs,  skb,  skh,  sks,  svb,  svh,
                           svs,  sob,  soh,  sos,  sdob, sdoh, sdos, sdqb,
                           sdqh, sdqs, sdkb, sdkh, sdks, sdvb, sdvh, sdvs};
  const Problem pr = problem(B, H, Hkv, S, D, s, causal, scale);
  auto st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  const float* ls = static_cast<const float*>(lse);
  if (dtype == 0) {
    const int err = launch_delta<float>(o, dout, dl, pr, st);
    if (err != 0) return err;
    return scalar_dispatch<float>(
        ScalarPtrs<float>{static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          static_cast<const float*>(dout), ls, dl,
                          static_cast<float*>(dq), static_cast<float*>(dk),
                          static_cast<float*>(dv)},
        pr, st);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const int err = launch_delta<bf>(o, dout, dl, pr, st);
    if (err != 0) return err;
    return scalar_dispatch<bf>(
        ScalarPtrs<bf>{static_cast<const bf*>(q), static_cast<const bf*>(k),
                       static_cast<const bf*>(v),
                       static_cast<const bf*>(dout), ls, dl,
                       static_cast<bf*>(dq), static_cast<bf*>(dk),
                       static_cast<bf*>(dv)},
        pr, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
