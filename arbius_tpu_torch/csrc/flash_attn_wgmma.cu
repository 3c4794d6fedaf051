// Exact softmax attention on Hopper's warpgroup tensor cores (wgmma), fed
// and drained by TMA, for sm_90a: the bf16 route for the UNets'
// self-attentions, at head dims 40, 64, 80 and 160 and any query and key
// lengths (4096^2 and 1024^2 at 512x512, 1600^2 at 640x640, 576^2 and
// 144^2 at D = 160 at 768x768, ...; the video UNet's 1024^2 and 256^2 at
// D = 64 at 256x256, 9216^2 to 144^2 at 1024x576).
//
// Replaces the Pallas TPU kernel `_kernel` launched by `flash_attention`
// in arbius_tpu/ops/flash.py (:34-60): out = softmax(q k^T / sqrt(D)) v
// over [B, H, S, D] tensors, with the running max m, the normaliser l and
// the accumulator in float32, and the output cast to q's dtype. It computes
// what the other tensor-core kernels compute: float32 scores, exp2 with
// scale*log2(e) folded into one FMA, keys >= S_kv at -inf, P rounded to
// bf16 before P V, l summed from the unrounded P, acc / l cast to bf16.
//
// What bounds it on this card. Every score costs one exp2 on the SFU, 16
// a clock per SM, against 4096 bf16 tensor-core FLOP a clock. At D = 40 a
// score carries 4 x 40 FLOP of the two products, so the exponentials
// (level 0, 8 x 8 x 4096^2 of them: 0.278 ms at the SFU's 3.87e12/s) take
// longer than the products (0.174 ms at 989 TFLOP/s): the SFU sets the
// floor. At D = 64 a score carries 256 FLOP against one exp2, which the
// tensor cores and the SFU each do in the same time: operations bound
// the long calls, bytes the short ones (256^2, 144^2), where a query tile
// meets 2 key tiles. At D = 80 the two are about level (0.017 ms exp2,
// 0.022 ms products at 1024^2): operations bound it. At D = 160 a score
// carries 640 FLOP of products against one exp2, and the calls are small:
// bytes bound them (144^2: 3.5 us to read q, k, v and write o, 0.9 us of
// products).
//
// What held the first design back (one block per (b*h, query tile), a
// K/V ring of two stages, two consumers at D = 64), measured by
// tools/flash_ablate.py on an NVIDIA H100 80GB HBM3 at 700 W: not the
// ring's depth (three to six stages timed as two at every shape) and not
// the loads' bytes (half of each K/V tile was no faster), but every
// block's own ramp (Q and the first K tile) and drain (the last P V and
// O's stores), most of a block's life where a query tile meets two key
// tiles (damo's 256^2, zeroscopev2xl's 144^2: a block per work tile is
// 1.3-1.4x the persistent kernel there), and at D = 64 two consumers'
// chains of waits (three were 1.06-1.5x faster where 192-row tiles waste
// little). A consumer's chain (wait for S, softmax, wait for P V, hand
// over the turn) still sets the time, with no one part leading: at
// 4096^2, D = 40, taking out the exp2s saves 14%, Q K^T 3%, P V nothing,
// and the loads alone take 0.40 of 0.50 ms; at damo's 1024^2, D = 64,
// taking out Q K^T saves 12%, the exp2s or P V nothing.
//
// Design (FlashAttention-3's shape):
//   - persistent blocks: the grid is the SM count (or the work tiles, if
//     fewer), and block i takes work tiles i, i + grid, i + 2 grid, ...
//     in that fixed order; work tile w is (b*h, query tile) = (w / nq,
//     w % nq), so the query tiles of one b*h run side by side and their
//     K and V stay in L2. No atomics, no tile counter in device memory:
//     the kernel allocates nothing and is captured in CUDA graphs.
//   - a producer warpgroup and consumer warpgroups of 64 query rows each,
//     three at D = 40 (192-row tiles), two at D = 80 and 160 (128-row
//     tiles), and at D = 64 three unless 192-row tiles would compute 1.2x
//     the rows of 128-row ones (`warpgroups_d64`, on the host: two at 256
//     rows). Little of a consumer's time is throughput: its softmax is a
//     chain of dependent steps run by one warp per SM sub-partition, so a
//     third consumer keeps the sub-partitions busy (160 registers each);
//     at D = 80 the accumulators of three would spill. Rows of the last
//     tile past Sq are read as zeros and not stored. A work tile walks
//     the key/value tiles, ceil(S_kv / kBK) of them, in a fixed order: no
//     split-KV, and a query row's arithmetic stays inside the warpgroup
//     that owns it, so results are bit-identical from run to run and
//     invariant to batch position, and do not depend on the number of
//     consumers, the block that takes a work tile, or the ring's depth.
//     The last tile's keys >= S_kv are masked: TMA reads the rows past
//     S_kv as zeros, which would score 0, not -inf.
//   - the key tile is 128 keys at D = 40, 64 and 80, 64 at D = 160: two
//     stages of 128-key K and V tiles at D = 160 would take 192 KB beside
//     Q's 48 KB, more than a block's 227 KB of shared memory.
//   - the producer (one thread; setmaxnreg gives its warpgroup's registers
//     to the consumers) walks the block's work tiles: each tile's Q, then
//     its K and V tiles into a ring of kStages, as deep as shared memory
//     holds beside Q and O's staging, at most six (five at D = 40, six or
//     five at D = 64, two at D = 80 and 160), each K and V stage with its
//     own full and empty mbarriers, so K_t can arrive while V_{t-1} is
//     read. It runs on into the next work tile while the consumers finish
//     this one: Q is reloaded once every consumer's last Q K^T on it has
//     retired (empty_q). Every barrier's parity follows a running count
//     (work tiles for Q, key tiles for K and V), never a count inside one
//     work tile.
//   - the tensor maps are the models' strided views ([B, S, H*D] seen as
//     [B, H, S, D], dims innermost first). A row of D = 40 is 80 bytes,
//     not a swizzle width, so every tile is loaded in boxes of 64 columns
//     with the 128-byte swizzle: columns past D lie outside the tensor and
//     TMA writes zeros there (never the next head's data). That pads the
//     contraction of Q K^T to 48 (D = 40) or 80 (D = 80) with zeros; at
//     D = 160 three boxes take columns 0-191 and the contraction is 10
//     k16 steps with no pad; D = 64 is one box and 4 k16 steps, no pad
//     either. The shared layout is the canonical 128-byte
//     swizzled one that wgmma reads without bank conflicts.
//   - S = Q K^T: wgmma m64n{kBK}k16, A (Q) and B (K) K-major from shared
//     memory. O += P V: wgmma m64nDk16, P as the A operand from registers
//     (the float32 accumulator layout of S, packed to bf16 pairs, is the
//     A-fragment layout), V as B from shared memory in its natural
//     [keys][D] layout with the transpose bit (MN-major). N = D = 40 is a
//     legal width: nothing is padded in P V.
//   - the consumers take turns on the tensor cores, in a ring of named
//     barriers: a consumer issues its S_t = Q K_t^T and its
//     P_{t-1} V_{t-1} back to back, hands the turn to the next, and runs
//     the softmax of S_t (the exp2s) while the others' products run.
//     Within a consumer the softmax of S_t also overlaps its own P V. The
//     turn carries from one work tile into the next: the last consumer's
//     last turn of a work tile hands over to the first consumer's first
//     turn of the next, and only the block's last turn hands over to no
//     one.
//   - the epilogue: O / l as bf16 into the consumer's own staging tile in
//     shared memory, written out by a TMA store whose reading of the tile
//     overlaps the consumer's next work tile (the store's rows past Sq
//     are not written); the staging tile is rewritten only after the
//     previous store has read it.
#include "hopper.cuh"

namespace {

constexpr int kMaxStages = 6;   // depth of the K/V ring, at most
constexpr int kRow = 128;       // bytes of one 64-column block of a row
constexpr int kBarTurn = 1;     // named barrier kBarTurn + c: consumer c's turn
constexpr int kBarO = 4;        // named barrier kBarO + c: c's epilogue
// a block's shared memory (227 KB), less room for the static mbarriers
constexpr int kSmemMax = 227 * 1024 - 256;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// D and WG, the consumer warpgroups of 64 query rows each
template <int D, int WG>
struct Layout {
  // keys per K/V tile: 128, but 64 at D = 160 (see the design)
  static constexpr int kBK = D == 160 ? 64 : 128;
  static constexpr int kWarpgroups = WG;
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + 128;  // + the producer
  // registers per thread after setmaxnreg (65536 in all on the SM)
  static constexpr int kProducerRegs = WG == 3 ? 24 : 40;
  static constexpr int kConsumerRegs = WG == 3 ? 160 : 232;
  static_assert(regs_balance(kThreads, kWarpgroups, kProducerRegs,
                             kConsumerRegs),
                "setmaxnreg cannot give the consumers these registers");
  static constexpr int kBQ = 64 * kWarpgroups;     // query rows per block
  static constexpr int kBlocks = (D + 63) / 64;    // 64-column blocks per row
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kQ = kBlocks * kBQ * kRow;   // bytes of the Q tile
  static constexpr int kKV = kBlocks * kBK * kRow;  // bytes of a K or V tile
  // bytes of one consumer's O staging tile ([64][D] bf16), 1024-aligned
  static constexpr int kO = (64 * D * 2 + 1023) & ~1023;
  // K/V stages: as many as fit beside Q, the O tiles and the slack that
  // aligns the base to 1024 bytes
  static constexpr int kStages = cmin(
      kMaxStages, (kSmemMax - 1024 - kQ - kWarpgroups * kO) / (2 * kKV));
  static_assert(kStages >= 2, "no two-stage K/V ring fits");
  static constexpr int kSmem =
      kQ + 2 * kStages * kKV + kWarpgroups * kO + 1024;
  static_assert(kSmem <= kSmemMax,
                "Q, the K/V ring and O exceed a block's shared memory");
};

// a compile-time flag passed to the consumer loop's `step`
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <class L>
struct Barriers {
  uint64_t full_q, empty_q;
  uint64_t full_k[L::kStages], full_v[L::kStages];
  uint64_t empty_k[L::kStages], empty_v[L::kStages];
};

template <int D, int WG>
__global__ void __launch_bounds__(Layout<D, WG>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const Params p, int work) {
  using L = Layout<D, WG>;
  constexpr int kBK = L::kBK;
  constexpr int kStages = L::kStages;
  constexpr int kS = kBK / 2;  // score accumulators per thread
  constexpr int kO = D / 2;    // output accumulators per thread
  constexpr int kWG = L::kWarpgroups;

  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers<L> bars;
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;  // [blk][kBQ]
  const uint32_t sK = sQ + L::kQ;               // [stage][blk][kBK][kRow]
  const uint32_t sV = sK + kStages * L::kKV;    // [stage][blk][kBK][kRow]
  const uint32_t sO = sV + kStages * L::kKV;    // [consumer][64][D] bf16

  const int nq = (p.sq + L::kBQ - 1) / L::kBQ;  // query tiles per b*h
  const int ntiles = (p.skv + kBK - 1) / kBK;
  const int kv_end = p.skv;  // keys at or past this are masked
  const float sl2 = p.scale * kLog2e;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&bars.full_q), 1);
    mbar_init(smem_addr(&bars.empty_q), L::kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&bars.full_k[s]), 1);
      mbar_init(smem_addr(&bars.full_v[s]), 1);
      mbar_init(smem_addr(&bars.empty_k[s]), L::kConsumers);
      mbar_init(smem_addr(&bars.empty_v[s]), L::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread issues every TMA load -------------------------
    setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      int g = 0;  // K/V tiles loaded so far, over the block's work tiles
      for (int w = blockIdx.x, i = 0; w < work; w += gridDim.x, ++i) {
        const int bh = w / nq;
        const int b = bh / p.heads;
        const int h = bh - b * p.heads;
        const int q0 = (w - bh * nq) * L::kBQ;
        const uint32_t fq = smem_addr(&bars.full_q);
        mbar_wait(smem_addr(&bars.empty_q), (i & 1) ^ 1);
        mbar_arrive_expect_tx(fq, L::kQ);
        for (int c = 0; c < L::kBlocks; ++c)  // rows past Sq read as zeros
          tma_load_4d(sQ + c * L::kBQ * kRow, &tq, fq, 64 * c, q0, h, b);
        for (int t = 0; t < ntiles; ++t, ++g) {
          const int st = g % kStages;
          const uint32_t free_parity = ((g / kStages) & 1) ^ 1;
          const uint32_t fk = smem_addr(&bars.full_k[st]);
          const uint32_t fv = smem_addr(&bars.full_v[st]);
          mbar_wait(smem_addr(&bars.empty_k[st]), free_parity);
          mbar_arrive_expect_tx(fk, L::kKV);
          for (int c = 0; c < L::kBlocks; ++c)  // keys past S_kv read as 0
            tma_load_4d(sK + st * L::kKV + c * kBK * kRow, &tk, fk, 64 * c,
                        t * kBK, h, b);
          mbar_wait(smem_addr(&bars.empty_v[st]), free_parity);
          mbar_arrive_expect_tx(fv, L::kKV);
          for (int c = 0; c < L::kBlocks; ++c)
            tma_load_4d(sV + st * L::kKV + c * kBK * kRow, &tv, fv, 64 * c,
                        t * kBK, h, b);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows each --------------------------------------
    setmaxnreg_inc<L::kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const uint32_t my_o = sO + c * L::kO;
    if (c == 0) named_arrive(kBarTurn, 256);  // consumer 0 goes first

    float s[kS];     // S: rows lane/4 (+8), 8-key column tiles j: s[4j..]
    float o[kO];     // O: the same layout over D's 8-column tiles
    uint32_t pa[kBK / 16][4];  // P_{t-1} as bf16 A fragments, 16 keys each
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = 0u;

    int g0 = 0;  // K/V tiles consumed before this work tile
    for (int w = blockIdx.x, i = 0; w < work;
         w += gridDim.x, ++i, g0 += ntiles) {
      const int bh = w / nq;
      const int q0 = (w - bh * nq) * L::kBQ;
      const bool last_work = w + (int)gridDim.x >= work;
#pragma unroll
      for (int j = 0; j < kO; ++j) o[j] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float alpha[2] = {1.f, 1.f};

      // one turn of the loop: S_t = Q K_t^T where has_s (t < ntiles), and
      // O += P_{t-1} V_{t-1} where has_pv (t > 0). Both flags are
      // constants of each instantiation, so no wgmma, wait or accumulator
      // write sits in a branch (where ptxas would serialise the products,
      // note C7520).
      auto step = [&](const int t, auto s_flag, auto pv_flag) {
        constexpr bool has_s = decltype(s_flag)::value;
        constexpr bool has_pv = decltype(pv_flag)::value;
        const int g = g0 + t;  // the running count of key tiles
        const int st = g % kStages;
        const int pst = (g + kStages - 1) % kStages;
        if constexpr (has_s)
          mbar_wait(smem_addr(&bars.full_k[st]), (g / kStages) & 1);
        if constexpr (has_pv)
          mbar_wait(smem_addr(&bars.full_v[pst]), ((g - 1) / kStages) & 1);

        // this consumer's turn on the tensor cores: in order 0, 1, ...
        named_sync(kBarTurn + c, 256);
        wgmma_fence();
        if constexpr (has_s) {
#pragma unroll
          for (int ks = 0; ks < L::kSteps; ++ks) {
            const uint32_t blk = ks / 4, off = (ks % 4) * 32;
            wgmma_ss<kBK>(
                s,
                desc_sw128(sQ + blk * L::kBQ * kRow + c * 64 * kRow + off,
                           16, 1024),
                desc_sw128(sK + st * L::kKV + blk * kBK * kRow + off, 16,
                           1024),
                ks > 0);
          }
          wgmma_commit();
        }
        if constexpr (has_pv) {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_rs<D>(o, pa[kk],
                        desc_sw128(sV + pst * L::kKV + kk * 16 * kRow,
                                   kBK * kRow, 1024));
          wgmma_commit();
        }
        // the next consumer's turn; the last consumer's last turn of a
        // work tile hands over to the next work tile's first, or, after
        // the block's last work tile, to no one
        named_arrive_if(kBarTurn + (c + 1) % kWG, 256,
                        has_s || c + 1 < kWG || !last_work);

        if constexpr (has_s) {
          if constexpr (has_pv) {
            wgmma_wait<1>();  // S_t has landed; P V may still run
          } else {
            wgmma_wait<0>();
          }
#pragma unroll
          for (int j = 0; j < kS; ++j) fence_reg(s[j]);
          mbar_arrive(smem_addr(&bars.empty_k[st]));
          // the work tile's last Q K^T: its Q stage may be refilled
          mbar_arrive_if(smem_addr(&bars.empty_q), t == ntiles - 1);

          const int kv0 = t * kBK;
          if (kv0 + kBK > kv_end) {
#pragma unroll
            for (int j = 0; j < kS; ++j)
              if (kv0 + (j >> 2) * 8 + 2 * (lane & 3) + (j & 1) >= kv_end)
                s[j] = -INFINITY;
          }
          // online softmax in the log2 domain; a row's 4 owners are a quad
          float mx[2] = {m[0], m[1]};
#pragma unroll
          for (int j = 0; j < kS / 4; ++j) {
            mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
          }
          float msc[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = ex2((m[r] - mx[r]) * sl2);
            m[r] = mx[r];
            msc[r] = mx[r] * sl2;
          }
#pragma unroll
          for (int j = 0; j < kS; ++j)
            s[j] = ex2(fmaf(s[j], sl2, -msc[(j >> 1) & 1]));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < kS / 4; ++j)
              rs += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
            l[r] = l[r] * alpha[r] + rs;
          }
        }
        if constexpr (has_pv) {
          wgmma_wait<0>();  // P_{t-1} V_{t-1} has landed
#pragma unroll
          for (int j = 0; j < kO; ++j) fence_reg(o[j]);
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);
          mbar_arrive(smem_addr(&bars.empty_v[pst]));
        }
        if constexpr (has_s) {
#pragma unroll
          for (int j = 0; j < kO / 4; ++j) {
            o[4 * j] *= alpha[0];
            o[4 * j + 1] *= alpha[0];
            o[4 * j + 2] *= alpha[1];
            o[4 * j + 3] *= alpha[1];
          }
          // P_t's bf16 A fragments: keys 16kk.. are S's column tiles 2kk,
          // 2kk + 1
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
          }
        }
      };

      mbar_wait(smem_addr(&bars.full_q), i & 1);
      step(0, Flag<true>{}, Flag<false>{});
      for (int t = 1; t < ntiles; ++t) step(t, Flag<true>{}, Flag<true>{});
      step(ntiles, Flag<false>{}, Flag<true>{});

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      // the epilogue: this consumer's previous store must have read its
      // staging tile before the tile is written again
      if (tid == 0) bulk_wait_read<0>();
      named_sync(kBarO + c, 128);
      const int row = 16 * warp + (lane >> 2);
#pragma unroll
      for (int j = 0; j < kO / 4; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           my_o + ((row + 8 * r) * D + col) * 2),
                       "r"(pack_bf16(o[4 * j + 2 * r] / l[r],
                                     o[4 * j + 2 * r + 1] / l[r]))
                       : "memory");
      }
      fence_proxy_async();
      named_sync(kBarO + c, 128);
      // rows past Sq are not written (the map clips them; a store wholly
      // past Sq is not issued)
      if (tid == 0 && q0 + 64 * c < p.sq) {
        tma_store_3d(&to, my_o, 0, q0 + 64 * c, bh);
        bulk_commit();
      }
    }
    // the last store has read its staging tile before the block exits (its
    // writes complete with the grid)
    if (tid == 0) bulk_wait_read<0>();
  }
}

template <int D, int WG>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<D, WG>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D, WG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int bh = batch * p.heads;
  CUtensorMap tq, tk, tv, to;
  int err = encode_map(&tq, p.q, batch, p.heads, p.sq, D, p.q_sb, p.q_sh,
                       p.q_ss, L::kBQ);
  if (err == 0)
    err = encode_map(&tk, p.k, batch, p.heads, p.skv, D, p.k_sb, p.k_sh,
                     p.k_ss, L::kBK);
  if (err == 0)
    err = encode_map(&tv, p.v, batch, p.heads, p.skv, D, p.v_sb, p.v_sh,
                     p.v_ss, L::kBK);
  if (err == 0) err = encode_out_map(&to, p.o, bh, p.sq, D, 64);
  if (err != 0) return err;
  // one persistent block per SM, or per work tile where there are fewer
  // (an int: 2^31 work tiles of 64 rows would not fit in device memory)
  const int work = bh * ((p.sq + L::kBQ - 1) / L::kBQ);
  const int grid = work < sm_count() ? work : sm_count();
  flash_wgmma_kernel<D, WG><<<grid, L::kThreads, L::kSmem, stream>>>(
      tq, tk, tv, to, p, work);
  return (int)cudaGetLastError();
}

// Consumer warpgroups at D = 64: three (192-row tiles) unless they would
// compute 1.2x the rows of two (128-row tiles). Three were 1.06-1.5x
// faster at 1024 to 9216 and 144 query rows, and 1.13x slower at 256,
// where 192-row tiles compute 384 (tools/flash_ablate.py, NVIDIA H100
// 80GB HBM3, 700 W). A query row's arithmetic does not depend on it.
int warpgroups_d64(int sq) {
  const long long rows2 = (sq + 127LL) / 128 * 128;
  const long long rows3 = (sq + 191LL) / 192 * 192;
  return 5 * rows3 <= 6 * rows2 ? 3 : 2;
}

}  // namespace

extern "C" {

// The argument list of arbius_flash_attn_fwd (flash_attn.cu). Takes bf16
// (dtype 1) only, D = 40, 64, 80 or 160, any Sq and Skv >= 1, every B/H/S
// stride a multiple of 8 elements and 16-byte aligned q/k/v/o
// (ops/flash.py's route rule); o: contiguous [B, H, Sq, D]. Launches on
// `stream`, allocates nothing, and returns 0 on success, else a CUDA error
// code, or 1000 plus the driver's code where a tensor map cannot be
// encoded.
int arbius_flash_attn_wgmma_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int sq, int skv, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                                k_ss, v_sb, v_sh, v_ss};
  bool ok = dtype == 1 && (d == 40 || d == 64 || d == 80 || d == 160) &&
            sq > 0 && skv > 0 &&
            ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 ==
                0;
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    heads, sq,   skv,  d,    q_sb,
           q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb, v_sh, v_ss, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // three consumers at D = 40 (two were 1.2x slower at 4096^2), two at
  // D = 80 and 160, where the accumulators of three would spill
  if (d == 40) return launch<40, 3>(p, batch, st);
  if (d == 64)
    return warpgroups_d64(sq) == 3 ? launch<64, 3>(p, batch, st)
                                   : launch<64, 2>(p, batch, st);
  if (d == 80) return launch<80, 2>(p, batch, st);
  return launch<160, 2>(p, batch, st);
}

}  // extern "C"
