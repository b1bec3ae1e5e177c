// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel zhpe_ompi_tpu/ops/flash_attention.py::
// _flash_fwd_kernel (launched by _flash_fwd, pl.pallas_call at
// flash_attention.py:142): softmax(scale * Q K^T) V with the online-softmax
// recurrence, f32 running max m, sum l and accumulator, -1e30 masking,
// causal tiles above the diagonal skipped, and the per-row natural-log
// lse = m + log(max(l, 1e-30)) of the scaled scores, which the dq kernel
// recomputes p from.
//
// What bounds it on an H100: bytes, at the flagship shape.  At
// (B, S, h, hd) = (16, 512, 16, 64) causal it does ~8.6 GFLOP of products
// (~9 us at 989 TFLOP/s) but must read q, k, v and write O and lse, ~67 MB
// (~20 us at 3.35 TB/s).
//
// What held the first design back (78.1 us on an NVIDIA H100 80GB HBM3 at
// 700 W, against SDPA's 39.3 us): each 64-key step synchronised the block,
// copied K and V global -> registers -> shared, and synchronised again, so
// nothing was in flight while the tensor cores worked; the B operand of
// P V was built from 16-bit shared loads (~128 per thread per key tile) and
// that of Q K^T from 32-bit pairs; mma.sync m16n8k16 on 64 rows per block,
// so each staged K/V tile served 64 query rows; and exp paid a multiply
// per score for the scale.
//
// This design:
// - Persistent: kMinBlocks blocks per SM (at most), each walking work
//   items of (batch*head, 128-row query tile) in the order of sm90.cuh's
//   Walk: the query tiles of one head run at the same time, so its K and
//   V come from device memory about once (K and V of all heads do not fit
//   the L2 together with Q and O).  A block runs two consumer warpgroups
//   of 64 rows each and one producer warp.
// - The producer issues TMA loads (tensor maps encoded on the host, passed
//   __grid_constant__): an item's Q into one of two buffers, then its K
//   and V tiles of 64 keys into a ring of kStages stages that runs on
//   across items, so the next item's Q and first tiles load while this one
//   finishes and writes its output.  Each stage and Q buffer has a full
//   barrier (the producer's arrival plus the TMA bytes) and an empty
//   barrier (one arrival per consumer warp when its products on it are
//   done).
// - S = Q K^T is wgmma m64n64k16 with Q and K both in shared memory,
//   K-major (K's (key, d) rows are already (n, k)).  P V is wgmma with P
//   from registers and V in shared memory MN-major (transposed): the f32
//   accumulator of S, rounded to bf16 in pairs, is register for register
//   the A fragment of the next product, so P never leaves registers.
// - Online softmax per row in registers (a row is spread over the four
//   lanes of a quad, two shuffles per reduction), in exp2 with
//   scale * log2(e) folded into one FMA per score.
// - Only the diagonal tile and a ragged last tile are masked (keys past S
//   read as zeros, so their scores are set to -1e30); a warpgroup whose
//   rows end before a key tile skips its products on it.
// - The epilogue writes O as bf16 (B, S, h, hd) and lse (B*h, S) from
//   registers; rows at or past S are never written.
// - Tiles (shared-memory layout in sm90.cuh): 64-row atoms swizzled to
//   the row width (128 B for hd >= 64).  kStages = 3 at hd <= 64 (81 KB
//   of shared memory, two blocks per SM), 2 at hd = 128 (129 KB, one block
//   per SM).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;             // query rows per block: two warpgroups of 64
constexpr int kBN = 64;              // keys per ring stage
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 32;  // and one producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Fwd {
  using T = Tiles<HD>;
  static constexpr int kStages = HD <= 64 ? 3 : 2;
  static constexpr int kMinBlocks = HD <= 64 ? 2 : 1;
  static constexpr int kQ = 0;                          // Q of two work items, two tiles each
  static constexpr int kK = 4 * T::kTile;               // K ring
  static constexpr int kV = kK + kStages * T::kTile;    // V ring
  static constexpr int kBar = kV + kStages * T::kTile;  // q_full[2], q_empty[2], full[], empty[]
  static constexpr int kSmem = kBar + 8 * (4 + 2 * kStages) + 1024;
};

// A work item: query tile qt of batch*head bh.
struct Item {
  int bh, b, h, q0;
  __device__ __forceinline__ Item(int bh_, int qt, int H)
      : bh(bh_), b(bh_ / H), h(bh_ % H), q0(qt * kBM) {}
};

template <int HD>
__global__ void __launch_bounds__(kThreads, Fwd<HD>::kMinBlocks)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int BH, int causal, float scale) {
  using C = Fwd<HD>;
  using T = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = smem_u32(align_1k(smem_raw));
  const uint32_t q_full0 = s0 + C::kBar, q_empty0 = q_full0 + 16;
  const uint32_t full0 = q_empty0 + 16, empty0 = full0 + 8 * C::kStages;
  const int n_qt = (S + kBM - 1) / kBM;
  const int n_kv = (S + kBN - 1) / kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full0 + 8 * qb, 1);
      mbar_init(q_empty0 + 8 * qb, kConsumerWarps);
    }
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one lane issues every load, walking the block's work items
    // in step with the consumers (i counts K/V tiles over all items, n
    // items); the next item's Q and first tiles load while this one ends
    if (lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      Walk walk(BH, n_qt);
      for (int bh, qt, i = 0, n = 0; walk.next(bh, qt); ++n) {
        const Item it(bh, qt, H);
        const int n_kt = causal ? min(n_kv, (it.q0 + kBM + kBN - 1) / kBN) : n_kv;
        const bool two_q = it.q0 + 64 < S;  // the second warpgroup has rows
        const int qb = n & 1;
        const uint32_t q_full = q_full0 + 8 * qb;
        mbar_wait(q_empty0 + 8 * qb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full, (two_q ? 2 : 1) * T::kTile);
        tma_load_rows<HD>(s0 + C::kQ + 2 * qb * T::kTile, &tm_q, q_full, it.q0, it.h, it.b);
        if (two_q)
          tma_load_rows<HD>(s0 + C::kQ + (2 * qb + 1) * T::kTile, &tm_q, q_full, it.q0 + 64,
                            it.h, it.b);
        for (int kt = 0; kt < n_kt; ++kt, ++i) {
          const int st = i % C::kStages;
          const uint32_t full = full0 + 8 * st;
          mbar_wait(empty0 + 8 * st, ((i / C::kStages) & 1) ^ 1);
          mbar_expect_tx(full, 2 * T::kTile);
          tma_load_rows<HD>(s0 + C::kK + st * T::kTile, &tm_k, full, kt * kBN, it.h, it.b);
          tma_load_rows<HD>(s0 + C::kV + st * T::kTile, &tm_v, full, kt * kBN, it.h, it.b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [rbase, rbase + 64) of each item
    const int wg = warp >> 2;
    const int g = lane >> 2, tq = lane & 3;
    const float sl2 = scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    Walk walk(BH, n_qt);
    for (int bh, qt, i = 0, n = 0; walk.next(bh, qt); ++n) {
      const Item it(bh, qt, H);
      const int n_kt = causal ? min(n_kv, (it.q0 + kBM + kBN - 1) / kBN) : n_kv;
      const int rbase = it.q0 + wg * 64;
      const int row0 = rbase + (warp & 3) * 16 + g, row1 = row0 + 8;
      const int my_kt = rbase >= S ? 0 : causal ? min(n_kt, (rbase + 64 + kBN - 1) / kBN) : n_kt;
      const int qb = n & 1;
      const uint32_t sq = s0 + C::kQ + (2 * qb + wg) * T::kTile;

      float acc[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
      float m0 = kNegInf, m1 = kNegInf;  // running max of the raw scores, rows row0 and row1
      float l0 = 0.f, l1 = 0.f;          // this lane's share of the running sums
      mbar_wait(q_full0 + 8 * qb, (n >> 1) & 1);

      for (int kt = 0; kt < n_kt; ++kt, ++i) {
        const int st = i % C::kStages;
        mbar_wait(full0 + 8 * st, (i / C::kStages) & 1);
        if (kt >= my_kt) {
          release(empty0 + 8 * st);
          continue;
        }
        const uint32_t sk = s0 + C::kK + st * T::kTile, sv = s0 + C::kV + st * T::kTile;
        float s[kBN / 2];
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) s[j] = 0.f;
        wgmma_fence();
        fence_regs(s);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(s, desc_k<HD>(sq, kk), desc_k<HD>(sk, kk), kk > 0 ? 1 : 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        const int k0 = kt * kBN;
        if ((causal && kt == my_kt - 1) || k0 + kBN > S) {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + j * 8 + tq * 2 + (e & 1);
              if (col >= S || (causal && col > (e < 2 ? row0 : row1))) s[4 * j + e] = kNegInf;
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float c0 = ex2((m0 - mx0) * sl2), c1 = ex2((m1 - mx1) * sl2);
        m0 = mx0;
        m1 = mx1;
        const float b0 = mx0 * sl2, b1 = mx1 * sl2;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          s[4 * j] = ex2(fmaf(s[4 * j], sl2, -b0));
          s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -b0));
          s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -b1));
          s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -b1));
          ps0 += s[4 * j] + s[4 * j + 1];
          ps1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = fmaf(l0, c0, ps0);
        l1 = fmaf(l1, c1, ps1);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j] *= c0;
          acc[4 * j + 1] *= c0;
          acc[4 * j + 2] *= c1;
          acc[4 * j + 3] *= c1;
        }

        uint32_t pa[kBN / 16][4];
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) acc_to_a(pa[j], s, j);
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) wgmma_rs(acc, pa[j], desc_mn<HD>(sv, j), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frags(pa);  // read by the wgmma until the wait
        release(empty0 + 8 * st);
      }
      release(q_empty0 + 8 * qb);  // this item's Q is read no more

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      l0 = fmaxf(l0, 1e-30f);
      l1 = fmaxf(l1, 1e-30f);
      store_acc<HD>(o, acc, it.b, it.h, S, H, row0, 1.f / l0, 1.f / l1);
      if (tq == 0) {
        if (row0 < S) lse[(int64_t)it.bh * S + row0] = m0 * scale + logf(l0);
        if (row1 < S) lse[(int64_t)it.bh * S + row1] = m1 * scale + logf(l1);
      }
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                   int H, const long long* maps, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = encode_operand(&tq, q, maps)) != cudaSuccess) return err;
  if ((err = encode_operand(&tk, k, maps + kGeomLen)) != cudaSuccess) return err;
  if ((err = encode_operand(&tv, v, maps + 2 * kGeomLen)) != cudaSuccess) return err;
  constexpr int smem = Fwd<HD>::kSmem;
  static unsigned long long smem_set = 0;
  if ((err = allow_smem(flash_fwd_kernel<HD>, smem, &smem_set)) != cudaSuccess) return err;
  // persistent: Fwd<HD>::kMinBlocks blocks per SM (at most), each walking
  // work items
  const long long items = (long long)B * H * ((S + kBM - 1) / kBM);
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const long long slots = (long long)sms * Fwd<HD>::kMinBlocks;
  const unsigned blocks = (unsigned)(items < slots ? items : slots);
  flash_fwd_kernel<HD><<<blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), S, H, B * H, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, S, H, hd), each described by kGeomLen entries of
// `maps` (q, then k, then v): dims (hd, S, H, B), byte strides of S, H
// and B, and the box (min(hd, 64), 64, 1, 1), as
// ops/flash_attention.py::tma_map_geometry computes them.  o: bf16
// (B, S, H, hd) contiguous.  lse: f32 (B*H, S).  hd must be 16, 32, 64 or
// 128.  Returns the cudaError_t of the encoding or the launch.
extern "C" int zt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int S, int H, int hd, const long long* maps, int causal,
                            float scale, void* stream) {
  // work items are counted in int
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (!geometry_ok(maps + i * kGeomLen, B, S, H, hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(q, k, v, o, lse, B, S, H, maps, causal, scale, st);
    case 32: return (int)launch<32>(q, k, v, o, lse, B, S, H, maps, causal, scale, st);
    case 64: return (int)launch<64>(q, k, v, o, lse, B, S, H, maps, causal, scale, st);
    case 128: return (int)launch<128>(q, k, v, o, lse, B, S, H, maps, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
