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
// Two kernels, as in the JAX package, so neither needs atomics and both
// are deterministic.  zt_flash_bwd_dq runs first and also computes delta
// (the TPU wrapper computed it in plain XLA at flash_attention.py:302),
// which zt_flash_bwd_dkv then reads.  p is recomputed as the forward made
// the lse: the scale is applied to the f32 scores after the bf16 product,
// and masked entries (causal, and keys or queries past S) are set to 0
// after the exp.  q, k, v, O and dO are read through their strides (q, k,
// v are views of the fused qkv product); dq, dk and dv are written
// (B, S, h, hd) contiguous, lse and delta are (B*h, S) f32.  Ragged S is
// masked.
//
// dq (the first design, unchanged): one block of four warps per
// (batch*head, 64-row query tile), a loop over 64-key tiles up to the
// diagonal (the TPU grid's sequential k axis), tiles staged synchronously
// in four (64, hd + 8) bf16 shared tiles (the pad staggers rows over the
// banks), bf16 mma.sync m16n8k16 products with ldmatrix(.trans) operands.
//
// dk/dv.  What held its first design (the dq design, key-major) back, at
// 147.6 us on an NVIDIA H100 80GB HBM3 at 700 W: each 64-query step was
// staged with nothing in flight (Q and dO through registers, lse and delta
// with scalar loads, between two __syncthreads); the B operands of
// S^T = K Q^T and dP^T = V dO^T came from two 32-bit shared loads per
// mma.sync; p and ds read lse and delta from shared memory once per
// element; 128 f32 accumulators per thread at hd = 64 left few warps per
// SM to hide the synchronous copies; and Q and dO were read again for
// every 64 keys.
//
// This design:
// - Persistent: one block per SM (at most), each walking work items of
//   (batch*head, 128-key tile) in the order of sm90.cuh's Walk: the key
//   tiles of one head run at the same time, so its Q and dO come from
//   device memory about once.  A block runs two consumer warpgroups of
//   64 keys each and a producer warpgroup; setmaxnreg gives the consumers
//   232 registers and leaves the producer 40.
// - K and V of an item are loaded once by TMA and stay resident, in one of
//   two buffers, so the next item's K and V load while this one computes.
//   The producer streams the query side, from the diagonal on when
//   causal, into a ring of kStages stages that runs on across items: a
//   64-query tile of Q and of dO by TMA (4-D tensor maps), and its 64 lse
//   and 64 delta floats, which a second producer warp copies with plain
//   loads (a (B*h, S) row is 16-byte aligned only when S is a multiple of
//   4, and TMA needs that).  Each stage and each K/V buffer has a full
//   and an empty mbarrier.
// - All four products are wgmma.  S^T = K Q^T and dP^T = V dO^T take K or
//   V as A and the Q or dO tile as B, all in shared memory and K-major;
//   their accumulators are key-major, so p^T and ds^T, rounded to bf16 in
//   pairs, are register for register the A fragments of dV += p^T dO and
//   dK += ds^T Q, whose B (the same dO and Q tiles) is read MN-major.
//   dV is issued before ds is computed, and both run on while the
//   warpgroup waits for the next stage and issues its S^T and dP^T.
// - A lane's 16 query columns take their lse and delta from the stage once
//   per tile, as float pairs; exp is exp2 with scale * log2(e) folded in.
//   Only the diagonal tile and a ragged last tile are masked, and a
//   warpgroup skips a causal tile wholly before its keys.
// - The epilogue writes dk * scale and dv as bf16 from registers; keys at
//   or past S are never written.  No atomics: the same bits on every run.
// - Tiles (shared-memory layout in sm90.cuh): 64-row atoms swizzled to the
//   row width.  kStages = 3 at hd <= 64 (115 KB of shared memory), 2 at
//   hd = 128 (194 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ---------------------------------------------------------------- dk/dv
//
// dk/dv for Hopper: TMA ring, wgmma, a producer warpgroup (see the note at
// the top of this file).
namespace dkv {

using namespace sm90;

constexpr int kBK = 128;             // keys per work item: two consumer warpgroups of 64
constexpr int kBQ = 64;              // queries per ring stage
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 3 * 128;    // and one producer warpgroup
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232 = 64 K registers
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Smem {
  using T = Tiles<HD>;
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  static constexpr int kKV = 0;                         // K, V of two work items
  static constexpr int kQ = 8 * T::kTile;               // Q ring
  static constexpr int kDO = kQ + kStages * T::kTile;   // dO ring
  static constexpr int kL = kDO + kStages * T::kTile;   // lse ring, 64 floats a stage
  static constexpr int kD = kL + kStages * kBQ * 4;     // delta ring
  static constexpr int kBar = kD + kStages * kBQ * 4;   // kv_full[2], kv_empty[2], full[], empty[]
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages) + 1024;

  // the 64-key tile of K (which = 0) or V (which = 1) of warpgroup wg, in
  // K/V buffer kv
  static __device__ __forceinline__ uint32_t kv_tile(uint32_t s0, int kv, int which, int wg) {
    return s0 + kKV + ((kv * 2 + which) * 2 + wg) * T::kTile;
  }
};

// A work item: key tile kt of batch*head bh.
struct Item {
  int bh, b, h, k0;
  __device__ __forceinline__ Item(int bh_, int kt, int H)
      : bh(bh_), b(bh_ / H), h(bh_ % H), k0(kt * kBK) {}
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int BH,
                     int causal, float scale) {
  using C = Smem<HD>;
  using T = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t kv_full0 = s0 + C::kBar, kv_empty0 = kv_full0 + 16;
  const uint32_t full0 = kv_empty0 + 16, empty0 = full0 + 8 * C::kStages;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int n_kb = (S + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int kv = 0; kv < 2; ++kv) {
      mbar_init(kv_full0 + 8 * kv, 1);
      mbar_init(kv_empty0 + 8 * kv, kConsumerWarps);
    }
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);  // the TMA thread and the row-statistics warp
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // producer warpgroup: one thread issues the TMA loads, one warp copies
    // the row statistics; both walk the block's work items in step with
    // the consumers (i counts query tiles over all items, n items)
    setmaxnreg_dec<kProducerRegs>();
    const int pwarp = (threadIdx.x >> 5) - kConsumerWarps, lane = threadIdx.x & 31;
    if (pwarp == 0 && lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_do);
      Walk walk(BH, n_kb);
      for (int bh, kt, i = 0, n = 0; walk.next(bh, kt); ++n) {
        const Item it(bh, kt, H);
        const int kv = n & 1;
        const uint32_t kv_full = kv_full0 + 8 * kv;
        const bool two_k = it.k0 + 64 < S;  // the second warpgroup has keys
        mbar_wait(kv_empty0 + 8 * kv, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(kv_full, (two_k ? 4 : 2) * T::kTile);
        for (int wg = 0; wg < (two_k ? 2 : 1); ++wg) {
          tma_load_rows<HD>(C::kv_tile(s0, kv, 0, wg), &tm_k, kv_full, it.k0 + 64 * wg, it.h, it.b);
          tma_load_rows<HD>(C::kv_tile(s0, kv, 1, wg), &tm_v, kv_full, it.k0 + 64 * wg, it.h, it.b);
        }
        for (int qt = causal ? it.k0 / kBQ : 0; qt < n_qt; ++qt, ++i) {
          const int st = i % C::kStages;
          const uint32_t full = full0 + 8 * st;
          mbar_wait(empty0 + 8 * st, ((i / C::kStages) & 1) ^ 1);
          mbar_expect_tx(full, 2 * T::kTile);
          tma_load_rows<HD>(s0 + C::kQ + st * T::kTile, &tm_q, full, qt * kBQ, it.h, it.b);
          tma_load_rows<HD>(s0 + C::kDO + st * T::kTile, &tm_do, full, qt * kBQ, it.h, it.b);
        }
      }
    } else if (pwarp == 1) {
      // lse * log2(e) and delta of each query tile: 64 floats each, zero
      // past S.  A TMA box of the (B*h, S) rows would need 16-byte aligned
      // rows (S a multiple of 4); plain loads take any S.
      Walk walk(BH, n_kb);
      for (int bh, kt, i = 0; walk.next(bh, kt);) {
        const Item it(bh, kt, H);
        for (int qt = causal ? it.k0 / kBQ : 0; qt < n_qt; ++qt, ++i) {
          const int st = i % C::kStages;
          mbar_wait(empty0 + 8 * st, ((i / C::kStages) & 1) ^ 1);
          float* sl = reinterpret_cast<float*>(smem + C::kL + st * kBQ * 4);
          float* sd = reinterpret_cast<float*>(smem + C::kD + st * kBQ * 4);
#pragma unroll
          for (int r = lane; r < kBQ; r += 32) {
            const int q = qt * kBQ + r;
            const int64_t at = (int64_t)it.bh * S + q;
            sl[r] = q < S ? lse[at] * kLog2e : 0.f;  // the exp is an exp2
            sd[r] = q < S ? delta[at] : 0.f;
          }
          mbar_arrive(full0 + 8 * st);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys [kbase, kbase + 64) of each item
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wg = warp >> 2;
    const int tq = lane & 3;
    const float sl2 = scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // dV += p^T dO and dK += ds^T Q of a tile run asynchronously while the
    // warpgroup waits for the next tile and issues its S^T and dP^T; the
    // stage they read (`pending`) is released after the next wait.
    uint32_t pa[kBQ / 16][4] = {}, da[kBQ / 16][4] = {};
    Walk walk(BH, n_kb);
    for (int bh, kt, i = 0, n = 0; walk.next(bh, kt); ++n) {
      const Item it(bh, kt, H);
      const int kv = n & 1;
      const int kbase = it.k0 + wg * 64;
      const int key0 = kbase + (warp & 3) * 16 + (lane >> 2), key1 = key0 + 8;
      const bool live = kbase < S;
      const uint32_t sk = C::kv_tile(s0, kv, 0, wg), sv = C::kv_tile(s0, kv, 1, wg);
      float dka[HD / 2], dva[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) dka[j] = dva[j] = 0.f;
      mbar_wait(kv_full0 + 8 * kv, (n >> 1) & 1);

      int pending = -1;
      for (int qt = causal ? it.k0 / kBQ : 0; qt < n_qt; ++qt, ++i) {
        const int st = i % C::kStages;
        const int q0 = qt * kBQ;
        mbar_wait(full0 + 8 * st, (i / C::kStages) & 1);
        // a causal tile wholly before this warpgroup's keys contributes nothing
        if (!live || (causal && q0 + kBQ <= kbase)) {
          release(empty0 + 8 * st);
          continue;
        }
        const uint32_t sq = s0 + C::kQ + st * T::kTile, sdo = s0 + C::kDO + st * T::kTile;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries per warpgroup
        float s[kBQ / 2], dp[kBQ / 2];
#pragma unroll
        for (int j = 0; j < kBQ / 2; ++j) s[j] = dp[j] = 0.f;
        wgmma_fence();
        fence_regs(s);
        fence_regs(dp);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(s, desc_k<HD>(sk, kk), desc_k<HD>(sq, kk), kk > 0 ? 1 : 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(dp, desc_k<HD>(sv, kk), desc_k<HD>(sdo, kk), kk > 0 ? 1 : 0);
        wgmma_commit();
        wgmma_wait<0>();  // also the previous tile's dV and dK
        fence_regs(s);
        fence_regs(dp);
        fence_regs(dka);
        fence_regs(dva);
        fence_frags(pa);
        fence_frags(da);
        if (pending >= 0) release(empty0 + 8 * pending);

        // p^T in place of s.  This lane's 16 query columns are 8j + 2tq and
        // 8j + 2tq + 1: their lse (times log2(e)) and delta come from the
        // stage once, as float pairs.
        const float* sl = reinterpret_cast<const float*>(smem + C::kL + st * kBQ * 4);
        const float* sd = reinterpret_cast<const float*>(smem + C::kD + st * kBQ * 4);
        const bool need_mask = (causal && q0 == kbase) || q0 + kBQ > S;
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(sl + j * 8 + tq * 2);
          const float ll[2] = {l2.x, l2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[4 * j + e], sl2, -ll[e & 1]));
            if (need_mask) {
              const int col = q0 + j * 8 + tq * 2 + (e & 1);
              if (col >= S || (causal && (e < 2 ? key0 : key1) > col)) p = 0.f;
            }
            s[4 * j + e] = p;
          }
        }
        // dv += p^T dO: A from the accumulator (query chunk j), dO (query,
        // d) read MN-major; it runs while ds is computed
#pragma unroll
        for (int j = 0; j < kBQ / 16; ++j) acc_to_a(pa[j], s, j);
        wgmma_fence();
        fence_regs(dva);
        fence_frags(pa);
#pragma unroll
        for (int j = 0; j < kBQ / 16; ++j) wgmma_rs(dva, pa[j], desc_mn<HD>(sdo, j), 1);
        wgmma_commit();

        // ds^T = p^T (dP^T - delta) in place of dp, then dk += ds^T Q
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(sd + j * 8 + tq * 2);
          const float dl[2] = {d2.x, d2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl[e & 1]);
        }
#pragma unroll
        for (int j = 0; j < kBQ / 16; ++j) acc_to_a(da[j], dp, j);
        wgmma_fence();
        fence_regs(dka);
        fence_frags(da);
#pragma unroll
        for (int j = 0; j < kBQ / 16; ++j) wgmma_rs(dka, da[j], desc_mn<HD>(sq, j), 1);
        wgmma_commit();
        pending = st;
      }
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_frags(pa);
      fence_frags(da);
      if (pending >= 0) release(empty0 + 8 * pending);
      release(kv_empty0 + 8 * kv);  // this item's K and V are read no more
      store_acc<HD>(dk, dka, it.b, it.h, S, H, key0, scale, scale);
      store_acc<HD>(dv, dva, it.b, it.h, S, H, key0, 1.f, 1.f);
    }
  }
}

}  // namespace dkv

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
               const long long* maps, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = sm90::encode_operand(&tq, q, maps)) != cudaSuccess ||
      (err = sm90::encode_operand(&tk, k, maps + sm90::kGeomLen)) != cudaSuccess ||
      (err = sm90::encode_operand(&tv, v, maps + 2 * sm90::kGeomLen)) != cudaSuccess ||
      (err = sm90::encode_operand(&tdo, dO, maps + 3 * sm90::kGeomLen)) != cudaSuccess)
    return (int)err;
  constexpr int smem = dkv::Smem<HD>::kBytes;
  static unsigned long long smem_set = 0;
  if ((err = sm90::allow_smem(dkv::flash_bwd_dkv_kernel<HD>, smem, &smem_set)) != cudaSuccess)
    return (int)err;
  // persistent: at most one block per SM, each walking work items
  const long long items = (long long)B * H * ((S + dkv::kBK - 1) / dkv::kBK);
  int sms = 0;
  if ((err = sm90::sm_count(&sms)) != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);
  dkv::flash_bwd_dkv_kernel<HD><<<blocks, dkv::kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, B * H, causal, scale);
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

// q, k, v, dO: bf16 (B, S, H, hd), each described by sm90::kGeomLen
// entries of `maps` (q, k, v, then dO): dims (hd, S, H, B), byte strides of
// S, H and B, and the box (min(hd, 64), 64, 1, 1), as
// ops/flash_attention.py::tma_map_geometry computes them.  lse and delta:
// f32 (B*H, S), delta as zt_flash_bwd_dq wrote it.  Writes dk and dv, bf16
// (B, S, H, hd) contiguous.  Returns the cudaError_t of the encoding or the
// launch.
extern "C" int zt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int S, int H, int hd, const long long* maps, int causal,
                                float scale, void* stream) {
  // work items are counted in int
  if (!valid(B, S, H) || (long long)B * H * S >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (!sm90::geometry_ok(maps + i * sm90::kGeomLen, B, S, H, hd))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_dkv<16>(q, k, v, dO, lse, delta, dk, dv, B, S, H, maps, causal, scale, st);
    case 32: return launch_dkv<32>(q, k, v, dO, lse, delta, dk, dv, B, S, H, maps, causal, scale, st);
    case 64: return launch_dkv<64>(q, k, v, dO, lse, delta, dk, dv, B, S, H, maps, causal, scale, st);
    case 128: return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, B, S, H, maps, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
