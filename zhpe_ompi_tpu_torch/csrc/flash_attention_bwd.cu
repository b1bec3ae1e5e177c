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
// after the exp.  q, k, v, O and dO are read through TMA tensor maps of
// their strides (q, k, v are views of the fused qkv product); dq, dk and
// dv are written (B, S, h, hd) contiguous, lse and delta are (B*h, S) f32.
// Ragged S is masked.
//
// Both kernels share one shape: persistent blocks of two consumer
// warpgroups (64 rows or keys each) and a producer warpgroup, which gives
// up its registers with setmaxnreg (the consumers get 232, the producer
// 40); work items walked in the order of sm90.cuh's Walk, so the tiles of
// one head run at the same time and the operand they all stream comes
// from device memory about once; TMA loads into mbarrier rings that run
// on across items; every product on wgmma; only the diagonal tile and a
// ragged last tile masked; the epilogue writes bf16 from registers and
// never writes rows at or past S; no atomics, so the same bits on every
// run.  Tiles (shared-memory layout in sm90.cuh) are 64-row atoms swizzled
// to the row width.
//
// dq.  What held its first design back, at 100.7 us on an NVIDIA H100
// 80GB HBM3 at 700 W: one 128-thread block per (head, 64-query tile), which
// staged K and V synchronously through registers between two
// __syncthreads on every key tile, so nothing was in flight while the
// tensor cores worked; every product on mma.sync m16n8k16, its B
// fragments from 32-bit shared loads; each staged K/V tile served 64 query
// rows; and exp paid a multiply per score for the scale.
//
// This design, query-major like the forward:
// - Work items are (batch*head, 128-query tile).  The producer loads an
//   item's Q and dO tiles (double-buffered across items at hd <= 64) and
//   its O tiles by TMA, then streams K and V tiles of 64 keys through a
//   ring of kStages stages, up to the diagonal when causal.
// - delta = rowsum(dO * O) is computed once per item, in f32, from the
//   shared O and dO tiles read through the swizzle TMA wrote them with
//   (a row over the four lanes of a quad), written for rows below S, and
//   the O buffer is freed for the next item.  lse and delta are fixed
//   across the key loop: each lane holds its two rows' values.
// - S = Q K^T and dP = dO V^T take both operands from shared memory,
//   K-major.  dQ += dS K takes dS from registers: the f32 dS accumulator,
//   rounded to bf16 in pairs, is register for register the A fragment, and
//   K is read MN-major.  p is exp2 with scale * log2(e) folded in.
// - dS K of a tile is issued right after the next tile's S and dP and
//   runs while that tile's p and ds are computed, so a ring stage is held
//   one tile longer: kStages = 4 at hd <= 64 (144 KB of shared memory), 3
//   at hd = 128 with single-buffered Q and dO (192 KB); one block per SM.
//   No wgmma sits inside a data-dependent branch, where ptxas would
//   serialise every wgmma of the kernel (its warning C7520).
//
// dk/dv.  What held its first design (the first dq design, key-major)
// back, at 147.6 us on an NVIDIA H100 80GB HBM3 at 700 W: each 64-query
// step was staged with nothing in flight (Q and dO through registers, lse
// and delta with scalar loads, between two __syncthreads); the B operands
// of S^T = K Q^T and dP^T = V dO^T came from two 32-bit shared loads per
// mma.sync; p and ds read lse and delta from shared memory once per
// element; 128 f32 accumulators per thread at hd = 64 left few warps per
// SM to hide the synchronous copies; and Q and dO were read again for
// every 64 keys.
//
// This design:
// - Work items are (batch*head, 128-key tile): the key tiles of one head
//   run at the same time, so its Q and dO come from device memory about
//   once.
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
//   per tile, as float pairs; a warpgroup skips a causal tile wholly
//   before its keys.
// - The epilogue writes dk * scale and dv.  kStages = 3 at hd <= 64
//   (115 KB of shared memory), 2 at hd = 128 (194 KB).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kConsumerWarps = 8;
constexpr int kThreads = 3 * 128;    // two consumer warpgroups and one producer warpgroup
constexpr int kProducerRegs = 40;    // setmaxnreg: 128 x 40 + 256 x 232 = 64 K registers
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- dq

namespace dq {

constexpr int kBM = 128;  // query rows per work item: two consumer warpgroups of 64
constexpr int kBN = 64;   // keys per ring stage

template <int HD>
struct Smem {
  using T = Tiles<HD>;
  static constexpr int kStages = HD <= 64 ? 4 : 3;
  static constexpr int kQBufs = HD <= 64 ? 2 : 1;         // Q and dO buffers, one item each
  static constexpr int kQ = 0;                            // Q, two tiles a buffer
  static constexpr int kDO = kQ + 2 * kQBufs * T::kTile;  // dO, likewise
  static constexpr int kO = kDO + 2 * kQBufs * T::kTile;  // O of one item, two tiles
  static constexpr int kK = kO + 2 * T::kTile;            // K ring
  static constexpr int kV = kK + kStages * T::kTile;      // V ring
  // q_full[kQBufs], q_empty[kQBufs], o_full, o_empty, full[kStages], empty[kStages]
  static constexpr int kBar = kV + kStages * T::kTile;
  static constexpr int kBytes = kBar + 8 * (2 * kQBufs + 2 + 2 * kStages) + 1024;
};

// A work item: query tile qt of batch*head bh.
struct Item {
  int bh, b, h, q0;
  __device__ __forceinline__ Item(int bh_, int qt, int H)
      : bh(bh_), b(bh_ / H), h(bh_ % H), q0(qt * kBM) {}
};

// sum over 8 columns of a * b, two bf16 rows of 16 bytes each, in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pa[i]), y = __bfloat1622float2(pb[i]);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s;
}

// Columns [c, c + 8) of row r of a 64-row tile, where TMA wrote them: in
// column atom c / kAtom, with the 16-byte chunk index (bits 4.. of the
// byte offset in the atom) XORed with the row's place in the swizzle
// period (bits 7.. of the offset), as CU_TENSOR_MAP_SWIZZLE_{32,64,128}B
// lay them out.
template <int HD>
__device__ __forceinline__ uint4 ld_swizzled(const uint8_t* tile, int r, int c) {
  using T = Tiles<HD>;
  uint32_t o = r * T::kSwz + (c % T::kAtom) * 2;
  o ^= ((o >> 7) & (T::kSwz / 16 - 1)) << 4;
  return *reinterpret_cast<const uint4*>(tile + (c / T::kAtom) * 64 * T::kSwz + o);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq_out, int S, int H, int BH,
                    int causal, float scale) {
  using C = Smem<HD>;
  using T = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1k(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t q_full0 = s0 + C::kBar, q_empty0 = q_full0 + 8 * C::kQBufs;
  const uint32_t o_full = q_empty0 + 8 * C::kQBufs, o_empty = o_full + 8;
  const uint32_t full0 = o_empty + 8, empty0 = full0 + 8 * C::kStages;
  const int n_qt = (S + kBM - 1) / kBM;
  const int n_kv = (S + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < C::kQBufs; ++qb) {
      mbar_init(q_full0 + 8 * qb, 1);
      mbar_init(q_empty0 + 8 * qb, kConsumerWarps);
    }
    mbar_init(o_full, 1);
    mbar_init(o_empty, kConsumerWarps);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // producer warpgroup: one thread issues every load, walking the block's
    // work items in step with the consumers (i counts K/V tiles over all
    // items, n items)
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_o);
      prefetch_map(&tm_do);
      Walk walk(BH, n_qt);
      for (int bh, qt, i = 0, n = 0; walk.next(bh, qt); ++n) {
        const Item it(bh, qt, H);
        const int n_kt = causal ? min(n_kv, (it.q0 + kBM + kBN - 1) / kBN) : n_kv;
        const int tiles = it.q0 + 64 < S ? 2 : 1;  // the second warpgroup may have no rows
        const int qb = n % C::kQBufs;
        const uint32_t q_full = q_full0 + 8 * qb;
        mbar_wait(q_empty0 + 8 * qb, ((n / C::kQBufs) & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * tiles * T::kTile);
        for (int w = 0; w < tiles; ++w) {
          const uint32_t at = (2 * qb + w) * T::kTile;
          tma_load_rows<HD>(s0 + C::kQ + at, &tm_q, q_full, it.q0 + 64 * w, it.h, it.b);
          tma_load_rows<HD>(s0 + C::kDO + at, &tm_do, q_full, it.q0 + 64 * w, it.h, it.b);
        }
        mbar_wait(o_empty, (n & 1) ^ 1);
        mbar_expect_tx(o_full, tiles * T::kTile);
        for (int w = 0; w < tiles; ++w)
          tma_load_rows<HD>(s0 + C::kO + w * T::kTile, &tm_o, o_full, it.q0 + 64 * w, it.h,
                            it.b);
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
    // consumers: warpgroup wg owns rows [rbase, rbase + 64) of each item;
    // this lane holds rows r0 and r0 + 8 of them
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wg = warp >> 2;
    const int tq = lane & 3;
    const int r0 = (warp & 3) * 16 + (lane >> 2);
    const float sl2 = scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    uint32_t da[kBN / 16][4] = {};
    Walk walk(BH, n_qt);
    for (int bh, qt, i = 0, n = 0; walk.next(bh, qt); ++n) {
      const Item it(bh, qt, H);
      const int n_kt = causal ? min(n_kv, (it.q0 + kBM + kBN - 1) / kBN) : n_kv;
      const int rbase = it.q0 + wg * 64;
      const int row0 = rbase + r0, row1 = row0 + 8;
      // key tiles with keys this warpgroup's rows see; the last is the
      // diagonal when causal
      const int my_kt = rbase >= S ? 0 : causal ? min(n_kt, rbase / kBN + 1) : n_kt;
      const int qb = n % C::kQBufs;
      const uint32_t sq = s0 + C::kQ + (2 * qb + wg) * T::kTile;
      const uint32_t sdo = s0 + C::kDO + (2 * qb + wg) * T::kTile;
      const int64_t at = (int64_t)it.bh * S;
      // lse * log2(e) of this lane's rows (the exp is an exp2)
      const float l0 = row0 < S ? lse[at + row0] * kLog2e : 0.f;
      const float l1 = row1 < S ? lse[at + row1] * kLog2e : 0.f;

      // delta = rowsum(dO * O) in f32: each lane of a quad sums every
      // fourth 8-column chunk of the quad's two rows, then the quad adds
      mbar_wait(q_full0 + 8 * qb, (n / C::kQBufs) & 1);
      mbar_wait(o_full, n & 1);
      float dl0 = 0.f, dl1 = 0.f;
      {
        const uint8_t* so = smem + C::kO + wg * T::kTile;
        const uint8_t* sd = smem + C::kDO + (2 * qb + wg) * T::kTile;
#pragma unroll
        for (int c = tq * 8; c < HD; c += 32) {
          dl0 += dot8(ld_swizzled<HD>(sd, r0, c), ld_swizzled<HD>(so, r0, c));
          dl1 += dot8(ld_swizzled<HD>(sd, r0 + 8, c), ld_swizzled<HD>(so, r0 + 8, c));
        }
      }
      release(o_empty);  // this item's O is read no more
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
      dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
      dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
      if (tq == 0) {
        if (row0 < S) delta[at + row0] = dl0;
        if (row1 < S) delta[at + row1] = dl1;
      }

      // dq += ds K of a tile is issued with the next tile's S and dP and
      // runs while that tile's p and ds are computed: `held` is the stage
      // of the tile whose ds (in dp) waits for its product, `busy` the
      // stage read by the product in flight.  No wgmma sits in a branch
      // (ptxas would serialise them all, C7520): before the first tile the
      // product adds zero fragments times that tile's K, and a warpgroup
      // with no rows runs its last product on zeros and stores nothing.
      float dqa[HD / 2], dp[kBN / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) dqa[j] = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) dp[j] = 0.f;
      // dq += ds K of the tile in `stage`: A from its ds, K (key, d) read
      // MN-major
      auto issue_dsk = [&](int stage) {
        const uint32_t sk = s0 + C::kK + stage * T::kTile;
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) wgmma_rs(dqa, da[j], desc_mn<HD>(sk, j), 1);
        wgmma_commit();
      };
      int held = -1, busy = -1, kt = 0;
      for (; kt < my_kt; ++kt, ++i) {
        const int st = i % C::kStages;
        wgmma_wait<0>();  // the product in flight
        fence_regs(dqa);
        fence_frags(da);
        if (busy >= 0) release(empty0 + 8 * busy);
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) acc_to_a(da[j], dp, j);
        mbar_wait(full0 + 8 * st, (i / C::kStages) & 1);
        const uint32_t sk = s0 + C::kK + st * T::kTile, sv = s0 + C::kV + st * T::kTile;
        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys per warpgroup
        float s[kBN / 2];
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) s[j] = dp[j] = 0.f;
        wgmma_fence();
        fence_regs(s);
        fence_regs(dp);
        fence_regs(dqa);
        fence_frags(da);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(s, desc_k<HD>(sq, kk), desc_k<HD>(sk, kk), kk > 0 ? 1 : 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(dp, desc_k<HD>(sdo, kk), desc_k<HD>(sv, kk), kk > 0 ? 1 : 0);
        wgmma_commit();
        issue_dsk(held >= 0 ? held : st);
        wgmma_wait<1>();  // S and dP; the product runs on
        fence_regs(s);
        fence_regs(dp);
        busy = held;
        held = st;

        // ds = p (dP - delta) in place of dp, with p = exp2(s scale log2(e)
        // - lse log2(e)), masked to 0
        const int k0 = kt * kBN;
        const bool need_mask = (causal && kt == my_kt - 1) || k0 + kBN > S;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[4 * j + e], sl2, -(e < 2 ? l0 : l1)));
            if (need_mask) {
              const int col = k0 + j * 8 + tq * 2 + (e & 1);
              if (col >= S || (causal && col > (e < 2 ? row0 : row1))) p = 0.f;
            }
            dp[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
          }
        }
      }
      // the last tile's product
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_frags(da);
      if (busy >= 0) release(empty0 + 8 * busy);
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) acc_to_a(da[j], dp, j);
      wgmma_fence();
      fence_regs(dqa);
      fence_frags(da);
      issue_dsk(held >= 0 ? held : 0);
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_frags(da);
      if (held >= 0) release(empty0 + 8 * held);
      // key tiles past this warpgroup's rows (causal) or rows past S
      for (; kt < n_kt; ++kt, ++i) {
        const int st = i % C::kStages;
        mbar_wait(full0 + 8 * st, (i / C::kStages) & 1);
        release(empty0 + 8 * st);
      }
      release(q_empty0 + 8 * qb);  // this item's Q and dO are read no more
      store_acc<HD>(dq_out, dqa, it.b, it.h, S, H, row0, scale, scale);
    }
  }
}

}  // namespace dq

// ---------------------------------------------------------------- dk/dv
//
// (see the note at the top of this file)
namespace dkv {

constexpr int kBK = 128;  // keys per work item: two consumer warpgroups of 64
constexpr int kBQ = 64;   // queries per ring stage

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

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dO,
              const void* lse, void* delta, void* dq_out, int B, int S, int H,
              const long long* maps, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to, tdo;
  cudaError_t err;
  if ((err = encode_operand(&tq, q, maps)) != cudaSuccess ||
      (err = encode_operand(&tk, k, maps + kGeomLen)) != cudaSuccess ||
      (err = encode_operand(&tv, v, maps + 2 * kGeomLen)) != cudaSuccess ||
      (err = encode_operand(&to, o, maps + 3 * kGeomLen)) != cudaSuccess ||
      (err = encode_operand(&tdo, dO, maps + 4 * kGeomLen)) != cudaSuccess)
    return (int)err;
  constexpr int smem = dq::Smem<HD>::kBytes;
  static unsigned long long smem_set = 0;
  if ((err = allow_smem(dq::flash_bwd_dq_kernel<HD>, smem, &smem_set)) != cudaSuccess)
    return (int)err;
  // persistent: at most one block per SM, each walking work items
  const long long items = (long long)B * H * ((S + dq::kBM - 1) / dq::kBM);
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);
  dq::flash_bwd_dq_kernel<HD><<<blocks, kThreads, smem, stream>>>(
      tq, tk, tv, to, tdo, static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf16*>(dq_out), S, H, B * H, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO, const void* lse,
               const void* delta, void* dk, void* dv, int B, int S, int H,
               const long long* maps, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = encode_operand(&tq, q, maps)) != cudaSuccess ||
      (err = encode_operand(&tk, k, maps + kGeomLen)) != cudaSuccess ||
      (err = encode_operand(&tv, v, maps + 2 * kGeomLen)) != cudaSuccess ||
      (err = encode_operand(&tdo, dO, maps + 3 * kGeomLen)) != cudaSuccess)
    return (int)err;
  constexpr int smem = dkv::Smem<HD>::kBytes;
  static unsigned long long smem_set = 0;
  if ((err = allow_smem(dkv::flash_bwd_dkv_kernel<HD>, smem, &smem_set)) != cudaSuccess)
    return (int)err;
  // persistent: at most one block per SM, each walking work items
  const long long items = (long long)B * H * ((S + dkv::kBK - 1) / dkv::kBK);
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);
  dkv::flash_bwd_dkv_kernel<HD><<<blocks, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, B * H, causal, scale);
  return (int)cudaGetLastError();
}

// Work items and rows are counted in int.
bool valid(int B, int S, int H) {
  return B > 0 && S > 0 && H > 0 && (long long)B * H * S < (1LL << 31);
}

}  // namespace

// q, k, v, o, dO: bf16 (B, S, H, hd), each described by sm90::kGeomLen
// entries of `maps` (q, k, v, o, then dO): dims (hd, S, H, B), byte strides of S,
// H and B, and the box (min(hd, 64), 64, 1, 1), as
// ops/flash_attention.py::tma_map_geometry computes them.  lse: the
// forward's f32 (B*H, S).  Writes delta, f32 (B*H, S), and dq, bf16
// (B, S, H, hd) contiguous.  hd must be 16, 32, 64 or 128.  Returns the
// cudaError_t of the encoding or the launch.
extern "C" int zt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dO, const void* lse, void* delta, void* dq, int B,
                               int S, int H, int hd, const long long* maps, int causal,
                               float scale, void* stream) {
  if (!valid(B, S, H)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (!sm90::geometry_ok(maps + i * sm90::kGeomLen, B, S, H, hd))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_dq<16>(q, k, v, o, dO, lse, delta, dq, B, S, H, maps, causal, scale, st);
    case 32: return launch_dq<32>(q, k, v, o, dO, lse, delta, dq, B, S, H, maps, causal, scale, st);
    case 64: return launch_dq<64>(q, k, v, o, dO, lse, delta, dq, B, S, H, maps, causal, scale, st);
    case 128: return launch_dq<128>(q, k, v, o, dO, lse, delta, dq, B, S, H, maps, causal, scale, st);
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
  if (!valid(B, S, H)) return (int)cudaErrorInvalidValue;
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
