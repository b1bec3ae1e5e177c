// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two TPU kernels of zhpe_ompi_tpu/ops/flash_attention.py::
// _flash_bwd: _flash_bwd_dq_kernel (pl.pallas_call at flash_attention.py:312)
// and _flash_bwd_dkv_kernel (pl.pallas_call at :332), with their shared
// tile recompute _recompute_p_ds (:177):
//
//     p  = exp(scale * Q K^T - lse)      (masked: 0)
//     ds = p * (dO V^T - delta)          delta = rowsum(dO * O)
//     dq = scale * ds K    dk = scale * ds^T Q    dv = p^T dO
//
// What bounds them on an H100: bytes, at the flagship shape.  At (B, S, h,
// hd) = (16, 512, 16, 64) causal, dq does 3 products and dk/dv 4, ~4.3
// GFLOP each (~13 and ~17 us at 989 TFLOP/s), while dq must read q, k, v,
// O, dO and lse and write dq and delta (~102 MB, ~30 us at 3.35 TB/s) and
// dk/dv must read q, k, v, dO, lse and delta and write dk and dv (~102 MB).
//
// Design (the forward kernel's structure; wgmma and TMA come later):
// - Two kernels, as in the JAX package, so neither needs atomics and both
//   are deterministic.  zt_flash_bwd_dq runs first and also computes delta
//   (the TPU wrapper computed it in plain XLA at flash_attention.py:302),
//   which zt_flash_bwd_dkv then reads.
// - dq: one block of four warps per (batch*head, 64-row query tile), a
//   loop over 64-key tiles up to the diagonal (the TPU grid's sequential
//   k axis).  dk/dv: one block per (batch*head, 64-key tile), a loop over
//   64-row query tiles from the diagonal on; it computes S^T = K Q^T and
//   dP^T = V dO^T key-major, so that p^T and ds^T come out of the
//   accumulators already in the A-operand layout of p^T dO and ds^T Q.
// - Every product is a bf16 mma.sync m16n8k16 with f32 accumulation.  Each
//   warp owns 16 rows of the block's tile.  A operands that live in shared
//   memory come in with ldmatrix; a B operand stored (n, k) (K for Q K^T)
//   is read as 32-bit pairs; a B operand stored (k, n) (K for ds K, Q and
//   dO for the key-major products) comes in with ldmatrix.trans.  p and ds
//   are rounded to bf16 in registers for their products.
// - p is recomputed exactly as the forward made the lse: the scale is
//   applied to the f32 scores after the bf16 product, and masked entries
//   (causal, and keys or queries past S) are set to 0 after the exp.
// - Four (64, hd + 8) bf16 tiles in dynamic shared memory (the 8-element
//   pad staggers rows over the 32 banks, for the 32-bit reads and for
//   ldmatrix alike); hd = 128 needs 68 KB, above the 48 KB static limit.
// - q, k, v, O and dO are read through their strides (q, k, v are views of
//   the fused qkv product); dq, dk and dv are written (B, S, h, hd)
//   contiguous, lse and delta are (B*h, S) f32.  Ragged S is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;  // query rows or keys per tile (16 per warp)
constexpr int kWarps = 4;

typedef __nv_bfloat16 bf16;

// element strides (batch, seq, head) of q, k, v, O and dO
struct Strides {
  int64_t b[5], s[5], h[5];
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major shared tile with leading dimension LD.
template <int LD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// B fragments of a shared tile stored (k, n) row-major: k rows [k0, k0 + 16),
// n columns [n0, n0 + 16).  b[0], b[1] feed n-tile n0..n0+7 and b[2], b[3]
// n-tile n0+8..n0+15.
template <int LD>
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(p)));
}

// The B fragment pair of n-tile [n0, n0 + 8) and k-step [k0, k0 + 16) of a
// shared tile stored (n, k) row-major.
template <int LD>
__device__ __forceinline__ void ld_b(uint32_t& b0, uint32_t& b1, const bf16* tile, int n0,
                                     int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (n0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Copy rows [row0, row0 + 64) of one head into a (64, LD) shared tile,
// zero-filling rows at or past S.  16-byte loads; the wrapper guarantees
// 16-byte aligned rows.
template <int HD, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t s_stride,
                                          int row0, int S) {
  constexpr int kVecPerRow = HD / 8;
  for (int i = threadIdx.x; i < kB * kVecPerRow; i += 32 * kWarps) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * s_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Write this warp's 16 rows of an f32 accumulator, times mul, as bf16 rows
// of a (B, S, H, HD) contiguous tensor.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HD / 8][4], int64_t b,
                                           int h, int S, int H, int row0, float mul) {
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int row1 = row0 + 8;
  const int64_t ss = (int64_t)H * HD;
  bf16* p = out + (b * S * H + h) * HD;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + tq * 2;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(p + row0 * ss + c) =
          __floats2bfloat162_rn(acc[dt][0] * mul, acc[dt][1] * mul);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(p + row1 * ss + c) =
          __floats2bfloat162_rn(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

template <int HD>
constexpr int smem_bytes() {
  return 4 * kB * (HD + 8) * (int)sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dO, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int S, int H, Strides st,
                    int causal, float scale) {
  constexpr int LD = HD + 8;
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T and dO V^T
  constexpr int DT = HD / 8;       // n-tiles of ds K
  constexpr int NT = kB / 8;       // n-tiles of Q K^T
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kB * LD;
  bf16* sK = sdO + kB * LD;
  bf16* sV = sK + kB * LD;
  __shared__ float sDelta[kB];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  const bf16* qp = q + b * st.b[0] + h * st.h[0];
  const bf16* kp = k + b * st.b[1] + h * st.h[1];
  const bf16* vp = v + b * st.b[2] + h * st.h[2];
  const bf16* op = o + b * st.b[3] + h * st.h[3];
  const bf16* dop = dO + b * st.b[4] + h * st.h[4];

  // Q and dO stay in shared memory for the whole loop; O passes through sK
  // once, for delta = rowsum(dO * O) in f32 (two threads per row).
  load_tile<HD, LD>(sQ, qp, st.s[0], q0, S);
  load_tile<HD, LD>(sdO, dop, st.s[4], q0, S);
  load_tile<HD, LD>(sK, op, st.s[3], q0, S);
  __syncthreads();
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.f;
#pragma unroll
    for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); ++c)
      acc += __bfloat162float(sdO[r * LD + c]) * __bfloat162float(sK[r * LD + c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sDelta[r] = acc;
      if (q0 + r < S) delta[(int64_t)bh * S + q0 + r] = acc;
    }
  }
  __syncthreads();

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float lse0 = row0 < S ? lse[(int64_t)bh * S + row0] : 0.f;
  const float lse1 = row1 < S ? lse[(int64_t)bh * S + row1] : 0.f;
  const float dl0 = sDelta[warp * 16 + g], dl1 = sDelta[warp * 16 + g + 8];

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_kt = causal ? qt + 1 : (S + kB - 1) / kB;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // every warp is done with the previous tile (and O)
    load_tile<HD, LD>(sK, kp, st.s[1], k0, S);
    load_tile<HD, LD>(sV, vp, st.s[2], k0, S);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_a<LD>(qa, sQ, warp * 16, kk * 16);
      ldsm_a<LD>(da, sdO, warp * 16, kk * 16);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        ld_b<LD>(b0, b1, sK, nt * 8, kk * 16);
        mma_bf16(s[nt], qa, b0, b1);
        ld_b<LD>(b0, b1, sV, nt * 8, kk * 16);
        mma_bf16(dp[nt], da, b0, b1);
      }
    }

    // p, then ds in place of s
    const bool need_mask = (causal && kt == qt) || (k0 + kB > S);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = __expf(s[nt][e] * scale - (lo ? lse0 : lse1));
        if (need_mask) {
          const int col = k0 + nt * 8 + tq * 2 + (e & 1);
          if (col >= S || (causal && col > (lo ? row0 : row1))) p = 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - (lo ? dl0 : dl1));
      }
    }

    // dq += ds K: the ds accumulators of n-tiles 2j and 2j + 1 are the A
    // fragment of key chunk j; K, stored (key, d), is B (k = key, n = d).
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t bb[4];
        ldsm_b_trans<LD>(bb, sK, j * 16, d2 * 16);
        mma_bf16(acc[2 * d2], a, bb[0], bb[1]);
        mma_bf16(acc[2 * d2 + 1], a, bb[2], bb[3]);
      }
    }
  }
  store_rows<HD>(dq, acc, b, h, S, H, row0, scale);
}

template <int HD>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, Strides st,
                     int causal, float scale) {
  constexpr int LD = HD + 8;
  constexpr int KSTEPS = HD / 16;
  constexpr int DT = HD / 8;
  constexpr int NT = kB / 8;  // n-tiles (queries) of K Q^T
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kB * LD;
  bf16* sQ = sV + kB * LD;
  bf16* sdO = sQ + kB * LD;
  __shared__ float sL[kB], sD[kB];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kt = blockIdx.y;  // low key tiles see the most queries: first
  const int k0 = kt * kB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  const bf16* qp = q + b * st.b[0] + h * st.h[0];
  const bf16* kp = k + b * st.b[1] + h * st.h[1];
  const bf16* vp = v + b * st.b[2] + h * st.h[2];
  const bf16* dop = dO + b * st.b[4] + h * st.h[4];

  load_tile<HD, LD>(sK, kp, st.s[1], k0, S);
  load_tile<HD, LD>(sV, vp, st.s[2], k0, S);

  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  const int n_qt = (S + kB - 1) / kB;
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<HD, LD>(sQ, qp, st.s[0], q0, S);
    load_tile<HD, LD>(sdO, dop, st.s[4], q0, S);
    for (int i = threadIdx.x; i < kB; i += 32 * kWarps) {
      const bool in = q0 + i < S;
      sL[i] = in ? lse[(int64_t)bh * S + q0 + i] : 0.f;
      sD[i] = in ? delta[(int64_t)bh * S + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_a<LD>(ka, sK, warp * 16, kk * 16);
      ldsm_a<LD>(va, sV, warp * 16, kk * 16);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        ld_b<LD>(b0, b1, sQ, nt * 8, kk * 16);
        mma_bf16(s[nt], ka, b0, b1);
        ld_b<LD>(b0, b1, sdO, nt * 8, kk * 16);
        mma_bf16(dp[nt], va, b0, b1);
      }
    }

    // p^T in place of s, ds^T in place of dp
    const bool need_mask = (causal && qt == kt) || (q0 + kB > S);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + tq * 2 + (e & 1);
        float p = __expf(s[nt][e] * scale - sL[c]);
        if (need_mask) {
          const int col = q0 + c;
          if (col >= S || (causal && (e < 2 ? key0 : key1) > col)) p = 0.f;
        }
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sD[c]);
      }
    }

    // dv += p^T dO and dk += ds^T Q: A from the accumulators of n-tiles 2j
    // and 2j + 1 (query chunk j); dO and Q, stored (query, d), are B.
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      da[0] = pack_bf16(dp[2 * j][0], dp[2 * j][1]);
      da[1] = pack_bf16(dp[2 * j][2], dp[2 * j][3]);
      da[2] = pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]);
      da[3] = pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t bb[4];
        ldsm_b_trans<LD>(bb, sdO, j * 16, d2 * 16);
        mma_bf16(dva[2 * d2], pa, bb[0], bb[1]);
        mma_bf16(dva[2 * d2 + 1], pa, bb[2], bb[3]);
        ldsm_b_trans<LD>(bb, sQ, j * 16, d2 * 16);
        mma_bf16(dka[2 * d2], da, bb[0], bb[1]);
        mma_bf16(dka[2 * d2 + 1], da, bb[2], bb[3]);
      }
    }
  }
  store_rows<HD>(dk, dka, b, h, S, H, key0, scale);
  store_rows<HD>(dv, dva, b, h, S, H, key0, 1.f);
}

Strides make_strides(const long long* st) {
  Strides s;
  for (int i = 0; i < 5; ++i) {
    s.b[i] = st[3 * i];
    s.s[i] = st[3 * i + 1];
    s.h[i] = st[3 * i + 2];
  }
  return s;
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dO,
              const void* lse, void* delta, void* dq, int B, int S, int H,
              const long long* st, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + kB - 1) / kB));
  flash_bwd_dq_kernel<HD><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), S,
      H, make_strides(st), causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO, const void* lse,
               const void* delta, void* dk, void* dv, int B, int S, int H,
               const long long* st, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + kB - 1) / kB));
  flash_bwd_dkv_kernel<HD><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H,
      make_strides(st), causal, scale);
  return (int)cudaGetLastError();
}

bool valid(int B, int S, int H) { return B > 0 && S > 0 && H > 0 && S <= 65535 * kB; }

}  // namespace

// q, k, v, o, dO: bf16 (B, S, H, hd), the last axis contiguous, with
// element strides (batch, seq, head) at strides[0..2] for q, [3..5] k,
// [6..8] v, [9..11] o and [12..14] dO.  lse: the forward's f32 (B*H, S).
// Writes delta, f32 (B*H, S), and dq, bf16 (B, S, H, hd) contiguous.
// hd must be 16, 32, 64 or 128.  Returns the cudaError_t of the launch.
extern "C" int zt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dO, const void* lse, void* delta, void* dq, int B,
                               int S, int H, int hd, const long long* strides, int causal,
                               float scale, void* stream) {
  if (!valid(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_dq<16>(q, k, v, o, dO, lse, delta, dq, B, S, H, strides, causal, scale, st);
    case 32: return launch_dq<32>(q, k, v, o, dO, lse, delta, dq, B, S, H, strides, causal, scale, st);
    case 64: return launch_dq<64>(q, k, v, o, dO, lse, delta, dq, B, S, H, strides, causal, scale, st);
    case 128: return launch_dq<128>(q, k, v, o, dO, lse, delta, dq, B, S, H, strides, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same tensors and strides (o's entries unused); reads the delta that
// zt_flash_bwd_dq wrote and writes dk and dv, bf16 (B, S, H, hd)
// contiguous.  Returns the cudaError_t of the launch.
extern "C" int zt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int S, int H, int hd, const long long* strides, int causal,
                                float scale, void* stream) {
  if (!valid(B, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_dkv<16>(q, k, v, dO, lse, delta, dk, dv, B, S, H, strides, causal, scale, st);
    case 32: return launch_dkv<32>(q, k, v, dO, lse, delta, dk, dv, B, S, H, strides, causal, scale, st);
    case 64: return launch_dkv<64>(q, k, v, dO, lse, delta, dk, dv, B, S, H, strides, causal, scale, st);
    case 128: return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, B, S, H, strides, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
