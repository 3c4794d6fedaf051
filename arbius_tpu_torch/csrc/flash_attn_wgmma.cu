// Exact softmax attention on Hopper's warpgroup tensor cores (wgmma), fed
// by TMA, for sm_90a: the bf16 route for the UNets' self-attentions, at
// head dims 40, 64, 80 and 160 and any query and key lengths (4096^2 and
// 1024^2 at 512x512, 1600^2 at 640x640, 576^2 and 144^2 at D = 160 at
// 768x768, ...; the video UNet's 1024^2 and 256^2 at D = 64 at 256x256,
// 9216^2 to 144^2 at 1024x576).
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
// tensor cores and the SFU each do in the same time: the two limits are
// level. At D = 80 the two are about level (0.017 ms exp2, 0.022 ms
// products at 1024^2): operations bound it. At D = 160 a score carries
// 640 FLOP of products against one exp2, and the calls are small: bytes
// bound them (144^2: 3.5 us to read q, k, v and write o, 0.9 us of
// products).
//
// Design (FlashAttention-3's shape):
//   - one block per (b*h, query tile): a producer warpgroup and consumer
//     warpgroups of 64 query rows each, three at D = 40 (192-row tiles)
//     and two at D = 64, 80 and 160 (128-row tiles). At D = 40 little of a
//     consumer's time is throughput: its softmax is a chain of dependent
//     steps run by one warp per SM sub-partition, so a third consumer
//     keeps the sub-partitions busy (160 registers each); at D = 80 the
//     accumulators of three would spill. Rows of the last tile past Sq
//     are read as zeros and not stored. The block walks the key/value
//     tiles, ceil(S_kv / kBK) of them, in a fixed order: no split-KV, no
//     atomics, and a query row's arithmetic stays inside the warpgroup
//     that owns it, so results are bit-identical from run to run and
//     invariant to batch position, and do not depend on the number of
//     consumers. The last tile's keys >= S_kv are masked: TMA reads the
//     rows past S_kv as zeros, which would score 0, not -inf.
//   - the key tile is 128 keys at D = 40, 64 and 80, 64 at D = 160: two
//     stages of 128-key K and V tiles at D = 160 would take 192 KB beside
//     Q's 48 KB, more than a block's 227 KB of shared memory.
//   - the producer (one thread; setmaxnreg gives its warpgroup's registers
//     to the consumers) loads Q once and K and V tile by tile with TMA
//     into a ring of two stages, each with its own full and empty
//     mbarriers for K and for V, so K_t can arrive while V_{t-1} is read.
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
//     Within a consumer the softmax of S_t also overlaps its own P V.
#include "hopper.cuh"

namespace {

constexpr int kStages = 2;      // depth of the K/V ring
constexpr int kRow = 128;       // bytes of one 64-column block of a row
constexpr int kBarTurn = 1;     // named barrier kBarTurn + c: consumer c's turn

template <int D>
struct Layout {
  // keys per K/V tile: 128, but 64 at D = 160 (see the design)
  static constexpr int kBK = D == 160 ? 64 : 128;
  // consumer warpgroups of 64 query rows each: three at D = 40, where a
  // third hides more of the softmax's latency, else two
  static constexpr int kWarpgroups = D == 40 ? 3 : 2;
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + 128;  // + the producer
  // registers per thread after setmaxnreg (65536 in all on the SM)
  static constexpr int kProducerRegs = D == 40 ? 24 : 40;
  static constexpr int kConsumerRegs = D == 40 ? 160 : 232;
  static_assert(regs_balance(kThreads, kWarpgroups, kProducerRegs,
                             kConsumerRegs),
                "setmaxnreg cannot give the consumers these registers");
  static constexpr int kBQ = 64 * kWarpgroups;     // query rows per block
  static constexpr int kBlocks = (D + 63) / 64;    // 64-column blocks per row
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kQ = kBlocks * kBQ * kRow;   // bytes of the Q tile
  static constexpr int kKV = kBlocks * kBK * kRow;  // bytes of a K or V tile
  // Q, the K and V rings, and slack to align the base to 1024 bytes
  static constexpr int kSmem = kQ + 2 * kStages * kKV + 1024;
  static_assert(kSmem <= 227 * 1024,
                "Q and the K/V ring exceed a block's shared memory");
};

// a compile-time flag passed to the consumer loop's `step`
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

struct Barriers {
  uint64_t q;
  uint64_t full_k[kStages], full_v[kStages];
  uint64_t empty_k[kStages], empty_v[kStages];
};

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const Params p) {
  using L = Layout<D>;
  constexpr int kBK = L::kBK;
  constexpr int kS = kBK / 2;  // score accumulators per thread
  constexpr int kO = D / 2;    // output accumulators per thread
  constexpr int kWG = L::kWarpgroups;

  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers bars;
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;  // [blk][kBQ]
  const uint32_t sK = sQ + L::kQ;               // [stage][blk][kBK][kRow]
  const uint32_t sV = sK + kStages * L::kKV;    // [stage][blk][kBK][kRow]

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.x * L::kBQ;
  const int ntiles = (p.skv + kBK - 1) / kBK;
  const int kv_end = p.skv;  // keys at or past this are masked
  const float sl2 = p.scale * kLog2e;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&bars.q), 1);
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
      const uint32_t bq = smem_addr(&bars.q);
      mbar_arrive_expect_tx(bq, L::kQ);
      for (int c = 0; c < L::kBlocks; ++c)  // rows past Sq read as zeros
        tma_load_4d(sQ + c * L::kBQ * kRow, &tq, bq, 64 * c, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        const uint32_t free_parity = ((t / kStages) & 1) ^ 1;
        const uint32_t fk = smem_addr(&bars.full_k[st]);
        const uint32_t fv = smem_addr(&bars.full_v[st]);
        mbar_wait(smem_addr(&bars.empty_k[st]), free_parity);
        mbar_arrive_expect_tx(fk, L::kKV);
        for (int c = 0; c < L::kBlocks; ++c)  // keys past S_kv read as zeros
          tma_load_4d(sK + st * L::kKV + c * kBK * kRow, &tk, fk, 64 * c,
                      t * kBK, h, b);
        mbar_wait(smem_addr(&bars.empty_v[st]), free_parity);
        mbar_arrive_expect_tx(fv, L::kKV);
        for (int c = 0; c < L::kBlocks; ++c)
          tma_load_4d(sV + st * L::kKV + c * kBK * kRow, &tv, fv, 64 * c,
                      t * kBK, h, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each --------------------------------------
    setmaxnreg_inc<L::kConsumerRegs>();
    const int c = wg - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    if (c == 0) named_arrive(kBarTurn, 256);  // consumer 0 goes first

    float s[kS];     // S: rows lane/4 (+8), 8-key column tiles j: s[4j..]
    float o[kO];     // O: the same layout over D's 8-column tiles
    uint32_t pa[kBK / 16][4];  // P_{t-1} as bf16 A fragments, 16 keys each
#pragma unroll
    for (int i = 0; i < kS; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = 0u;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};

    // one turn of the loop: S_t = Q K_t^T where has_s (t < ntiles), and
    // O += P_{t-1} V_{t-1} where has_pv (t > 0). Both flags are constants
    // of each instantiation, so no wgmma, wait or accumulator write sits
    // in a branch (where ptxas would serialise the products, note C7520).
    auto step = [&](const int t, auto s_flag, auto pv_flag) {
      constexpr bool has_s = decltype(s_flag)::value;
      constexpr bool has_pv = decltype(pv_flag)::value;
      const int st = t % kStages;
      const int pst = (t + kStages - 1) % kStages;
      if constexpr (has_s)
        mbar_wait(smem_addr(&bars.full_k[st]), (t / kStages) & 1);
      if constexpr (has_pv)
        mbar_wait(smem_addr(&bars.full_v[pst]), ((t - 1) / kStages) & 1);

      // this consumer's turn on the tensor cores: in order 0, 1, ...
      named_sync(kBarTurn + c, 256);
      wgmma_fence();
      if constexpr (has_s) {
#pragma unroll
        for (int ks = 0; ks < L::kSteps; ++ks) {
          const uint32_t blk = ks / 4, off = (ks % 4) * 32;
          wgmma_ss<kBK>(
              s,
              desc_sw128(sQ + blk * L::kBQ * kRow + c * 64 * kRow + off, 16,
                         1024),
              desc_sw128(sK + st * L::kKV + blk * kBK * kRow + off, 16, 1024),
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
      // the next consumer's turn (the last consumer's last turn hands over
      // to no one)
      if (has_s || c + 1 < kWG)
        named_arrive(kBarTurn + (c + 1) % kWG, 256);

      if constexpr (has_s) {
        if constexpr (has_pv) {
          wgmma_wait<1>();  // S_t has landed; P V may still run
        } else {
          wgmma_wait<0>();
        }
#pragma unroll
        for (int i = 0; i < kS; ++i) fence_reg(s[i]);
        mbar_arrive(smem_addr(&bars.empty_k[st]));

        const int kv0 = t * kBK;
        if (kv0 + kBK > kv_end) {
#pragma unroll
          for (int i = 0; i < kS; ++i)
            if (kv0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1) >= kv_end)
              s[i] = -INFINITY;
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
        for (int i = 0; i < kS; ++i)
          s[i] = ex2(fmaf(s[i], sl2, -msc[(i >> 1) & 1]));
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
        for (int i = 0; i < kO; ++i) fence_reg(o[i]);
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
        // P_t's bf16 A fragments: keys 16kk.. are S's column tiles 2kk, 2kk+1
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      }
    };

    mbar_wait(smem_addr(&bars.q), 0);
    step(0, Flag<true>{}, Flag<false>{});
    for (int t = 1; t < ntiles; ++t) step(t, Flag<true>{}, Flag<true>{});
    step(ntiles, Flag<false>{}, Flag<true>{});

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bf16* og = static_cast<bf16*>(p.o) + (long long)bh * p.sq * D;
    const int row = q0 + 64 * c + 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row + 8 * r < p.sq) {  // the last block's rows past Sq
          const __nv_bfloat162 val = __floats2bfloat162_rn(
              o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
          *reinterpret_cast<__nv_bfloat162*>(
              og + (long long)(row + 8 * r) * D + col) = val;
        }
      }
    }
  }
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<D>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, p.q, batch, p.heads, p.sq, D, p.q_sb, p.q_sh,
                       p.q_ss, L::kBQ);
  if (err == 0)
    err = encode_map(&tk, p.k, batch, p.heads, p.skv, D, p.k_sb, p.k_sh,
                     p.k_ss, L::kBK);
  if (err == 0)
    err = encode_map(&tv, p.v, batch, p.heads, p.skv, D, p.v_sb, p.v_sh,
                     p.v_ss, L::kBK);
  if (err != 0) return err;
  const dim3 grid((p.sq + L::kBQ - 1) / L::kBQ, batch * p.heads);
  flash_wgmma_kernel<D>
      <<<grid, L::kThreads, L::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
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
  if (d == 40) return launch<40>(p, batch, st);
  if (d == 64) return launch<64>(p, batch, st);
  if (d == 80) return launch<80>(p, batch, st);
  return launch<160>(p, batch, st);
}

}  // extern "C"
