// Exact softmax attention over short key sequences (S_kv <= 128) on
// Hopper's warpgroup tensor cores (wgmma), fed and drained by TMA, for
// sm_90a: the bf16 route for the UNet's 77-key cross-attentions at every
// bucket and its self-attentions of 128 tokens or fewer, head dims 40, 64,
// 80 and 160 (64: the video UNet's).
//
// Replaces the Pallas TPU kernel `_kernel` launched by `flash_attention`
// in arbius_tpu/ops/flash.py (:34-60): out = softmax(q k^T / sqrt(D)) v
// over [B, H, S, D] tensors, with the softmax statistics and the
// accumulator in float32 and the output cast to q's dtype. It computes
// what the other tensor-core kernels compute: float32 scores, exp2 with
// scale*log2(e) folded into one FMA, keys >= S_kv at -inf, P rounded to
// bf16 before P V, l summed from the unrounded P, acc / l cast to bf16.
// With one key tile there is no running max to rescale by: m is the row's
// max over every key.
//
// What bounds it on this card: bytes. Each query row meets at most 128
// keys, ~4 x 128 x D FLOP against 4D bytes of q read and o written, so
// at 4096 x 77, D = 40 (B*H = 64) reading Q and writing O takes 12.8 us
// at 3.35 TB/s and the products 3.3 us at 989 TFLOP/s. K and V are small
// and read once per block.
//
// Design:
//   - a block per (b*h, run of 64-row query tiles): a producer warpgroup
//     (one thread; setmaxnreg gives its registers to the consumers) and
//     consumer warpgroups (three at D = 40, 64 and 80, two at D = 160) that
//     take the run's tiles in turn. The producer loads K and V of the
//     block's (b, h) once by TMA, and they stay resident; the query tiles
//     stream through TMA stages, each consumer's own (1 to 3 each, as
//     shared memory allows). The host picks the run length so that the
//     blocks fill the SMs in whole waves (`tiles_per_block`); a tile's
//     arithmetic does not depend on it.
//   - the tensor maps are the models' strided views ([B, S, H*D] seen as
//     [B, H, S, D]), read in boxes of 64 columns with the 128-byte
//     swizzle (flash_attn_wgmma.cu says why): columns past D and rows
//     past S_kv or Sq arrive as zeros. A zero key row gives a score of 0,
//     not -inf, so keys >= S_kv are masked in registers.
//   - S = Q K^T: one wgmma m64nNk16 per 16 columns of D, N = S_kv rounded
//     up to 16, 32, 64, 80 or 128 (77 keys: N = 80, 3 masked columns).
//   - O = P V: P packed to bf16 A fragments in registers, V MN-major from
//     shared memory, N/16 steps of wgmma m64nDk16.
//   - the epilogue: O / l as bf16 into the consumer's staging tile in
//     shared memory, written out by a TMA store whose reading of the tile
//     overlaps the consumer's next tile; rows past Sq are not written.
//   - no split-KV, no atomics, and a query row's arithmetic stays inside
//     the warpgroup that owns it: results are bit-identical from run to
//     run and invariant to batch position.
#include "hopper.cuh"

namespace {

constexpr int kRow = 128;       // bytes of one 64-column block of a row
constexpr int kTile = 64;       // query rows per tile (a wgmma's M)
constexpr int kBarO = 1;  // named barrier kBarO + c: consumer c's epilogue
constexpr int kMaxStages = 8;  // query-tile stages in all, at most
constexpr int kBudget = 216 * 1024;  // dynamic shared memory, less the slack

constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int D, int NK>
struct Layout {
  // consumer warpgroups: three at D = 40, 64 and 80, where a third keeps
  // more tiles in flight (tools/flash_ablate.py times two), two at
  // D = 160, whose accumulators need the registers; registers per thread
  // after setmaxnreg (65536 in all on the SM)
  static constexpr int kConsumers = D == 160 ? 2 : 3;
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer
  static constexpr int kProducerRegs = D == 40 ? 24 : 40;
  static constexpr int kConsumerRegs = D == 40 ? 160 : D == 160 ? 232 : 152;
  static_assert(regs_balance(kThreads, kConsumers, kProducerRegs,
                             kConsumerRegs),
                "setmaxnreg cannot give the consumers these registers");
  static constexpr int kBlocks = (D + 63) / 64;    // 64-column blocks per row
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kQ = kBlocks * kTile * kRow;  // bytes of a Q tile
  static constexpr int kKV = kBlocks * NK * kRow;    // bytes of K (or V)
  // bytes of one consumer's O staging tile ([kTile][D] bf16), 1024-aligned
  static constexpr int kO = (kTile * D * 2 + 1023) & ~1023;
  static constexpr int kFree = kBudget - 2 * kKV - kConsumers * kO;
  // query-tile stages per consumer, as many as fit: each consumer has
  // its own, so that it waits on a stage's barrier only for the fill
  // after the one it consumed last (a barrier's parity tells a phase
  // from the next, not from the one after that)
  static constexpr int kPer =
      cmin(kFree / (kQ * kConsumers), kMaxStages / kConsumers);
  static_assert(kPer >= 1, "no query-tile stage fits");
  static constexpr int kStages = kPer * kConsumers;
  // K, V, the Q ring, the O tiles, and slack to align the base to 1024
  static constexpr int kSmem = 2 * kKV + kStages * kQ + kConsumers * kO + 1024;
};

template <int D, int NK>
struct Barriers {
  uint64_t kv;
  uint64_t full[Layout<D, NK>::kStages], empty[Layout<D, NK>::kStages];
};

template <int D, int NK>
__global__ void __launch_bounds__(Layout<D, NK>::kThreads, 1)
    flash_wgmma_short_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to,
                             const Params p, int per_block) {
  using L = Layout<D, NK>;
  constexpr int kS = NK / 2;  // score accumulators per thread
  constexpr int kOut = D / 2;  // output accumulators per thread

  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers<D, NK> bars;
  const uint32_t sK = (smem_addr(smem_raw) + 1023) & ~1023u;  // [blk][NK]
  const uint32_t sV = sK + L::kKV;                            // [blk][NK]
  const uint32_t sQ = sV + L::kKV;            // [stage][blk][kTile][kRow]
  const uint32_t sO = sQ + L::kStages * L::kQ;  // [consumer][kTile][D]

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int first = blockIdx.x * per_block;  // the block's first query tile
  const int tiles = (p.sq + kTile - 1) / kTile;
  const int ntile = min(per_block, tiles - first);
  const int kv_end = p.skv;  // keys at or past this are masked
  const float sl2 = p.scale * kLog2e;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&bars.kv), 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(smem_addr(&bars.full[s]), 1);
      mbar_init(smem_addr(&bars.empty[s]), 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread issues every TMA load -------------------------
    setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint32_t bkv = smem_addr(&bars.kv);
      mbar_arrive_expect_tx(bkv, 2 * L::kKV);
      for (int c = 0; c < L::kBlocks; ++c) {  // keys past S_kv read as zeros
        tma_load_4d(sK + c * NK * kRow, &tk, bkv, 64 * c, 0, h, b);
        tma_load_4d(sV + c * NK * kRow, &tv, bkv, 64 * c, 0, h, b);
      }
      for (int j = 0; j < ntile; ++j) {
        // the i-th tile of consumer j % kConsumers: its stage and fill
        const int i = j / L::kConsumers;
        const int st = (j % L::kConsumers) * L::kPer + i % L::kPer;
        const uint32_t full = smem_addr(&bars.full[st]);
        mbar_wait(smem_addr(&bars.empty[st]), ((i / L::kPer) & 1) ^ 1);
        mbar_arrive_expect_tx(full, L::kQ);
        for (int c = 0; c < L::kBlocks; ++c)  // rows past Sq read as zeros
          tma_load_4d(sQ + st * L::kQ + c * kTile * kRow, &tq, full, 64 * c,
                      (first + j) * kTile, h, b);
      }
    }
  } else {
    // -- consumers: tiles c, c + kConsumers, ... of the block's run --------
    setmaxnreg_inc<L::kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const uint32_t my_o = sO + c * L::kO;

    mbar_wait(smem_addr(&bars.kv), 0);
    for (int j = c; j < ntile; j += L::kConsumers) {
      const int i = j / L::kConsumers;  // this consumer's i-th tile
      const int st = c * L::kPer + i % L::kPer;
      mbar_wait(smem_addr(&bars.full[st]), (i / L::kPer) & 1);

      // S = Q K^T over the whole (padded) key sequence
      float s[kS];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < L::kSteps; ++ks) {
        const uint32_t blk = ks / 4, off = (ks % 4) * 32;
        wgmma_ss<NK>(s,
                     desc_sw128(sQ + st * L::kQ + blk * kTile * kRow + off,
                                16, 1024),
                     desc_sw128(sK + blk * NK * kRow + off, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kS; ++i) fence_reg(s[i]);
      mbar_arrive(smem_addr(&bars.empty[st]));  // the Q stage is free

      // softmax in the log2 domain over one tile; a row's 4 owners are a
      // quad: rows lane/4 (+8), 8-key column tiles j: s[4j..4j+3]
      if (kv_end < NK) {
#pragma unroll
        for (int i = 0; i < kS; ++i)
          if ((i >> 2) * 8 + 2 * (lane & 3) + (i & 1) >= kv_end)
            s[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int q = 0; q < kS / 4; ++q) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * q], s[4 * q + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * q + 2], s[4 * q + 3]));
      }
      float msc[2], l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        msc[r] = mx[r] * sl2;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i)
        s[i] = ex2(fmaf(s[i], sl2, -msc[(i >> 1) & 1]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float rs = 0.f;
#pragma unroll
        for (int q = 0; q < kS / 4; ++q)
          rs += s[4 * q + 2 * r] + s[4 * q + 2 * r + 1];
        l[r] = rs;
      }

      // O = P V: P's bf16 A fragments, keys 16kk.. are S's column tiles
      // 2kk and 2kk + 1
      uint32_t pa[NK / 16][4];
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      float o[kOut];
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    desc_sw128(sV + kk * 16 * kRow, NK * kRow, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kOut; ++i) fence_reg(o[i]);
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      // the epilogue: this consumer's previous store must have read its
      // staging tile before the tile is written again
      if (t == 0) bulk_wait_read<0>();
      named_sync(kBarO + c, 128);
      const int row = 16 * warp + (lane >> 2);
#pragma unroll
      for (int q = 0; q < kOut / 4; ++q) {
        const int col = 8 * q + 2 * (lane & 3);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           my_o + ((row + 8 * r) * D + col) * 2),
                       "r"(pack_bf16(o[4 * q + 2 * r] / l[r],
                                     o[4 * q + 2 * r + 1] / l[r]))
                       : "memory");
      }
      fence_proxy_async();
      named_sync(kBarO + c, 128);
      if (t == 0) {
        tma_store_3d(&to, my_o, 0, (first + j) * kTile, bh);
        bulk_commit();
      }
    }
    if (t == 0) bulk_wait<0>();  // the last store, before the block exits
  }
}

// SMs on the current device, read once
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// Query tiles per block: the run length that finishes soonest with one
// block per SM, counting a block's time as its tile loads plus its K and
// V loads (`kv_tiles`, in tiles' worth of rows) and the blocks in whole
// waves; on a tie the longer run (fewer K/V loads).
int tiles_per_block(int tiles, int bh, int kv_tiles) {
  const long long sms = sm_count();
  int best = tiles;
  long long best_cost = -1;
  for (int per = tiles; per >= 1; --per) {
    const long long blocks = (long long)bh * ((tiles + per - 1) / per);
    const long long cost = (blocks + sms - 1) / sms * (per + kv_tiles);
    if (best_cost < 0 || cost < best_cost) {
      best = per;
      best_cost = cost;
    }
  }
  return best;
}

template <int D, int NK>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<D, NK>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_short_kernel<D, NK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int bh = batch * p.heads;
  CUtensorMap tq, tk, tv, to;
  int err = encode_map(&tq, p.q, batch, p.heads, p.sq, D, p.q_sb, p.q_sh,
                       p.q_ss, kTile);
  if (err == 0)
    err = encode_map(&tk, p.k, batch, p.heads, p.skv, D, p.k_sb, p.k_sh,
                     p.k_ss, NK);
  if (err == 0)
    err = encode_map(&tv, p.v, batch, p.heads, p.skv, D, p.v_sb, p.v_sh,
                     p.v_ss, NK);
  if (err == 0) err = encode_out_map(&to, p.o, bh, p.sq, D, kTile);
  if (err != 0) return err;
  const int tiles = (p.sq + kTile - 1) / kTile;
  const int per = tiles_per_block(tiles, bh, (2 * NK + kTile - 1) / kTile);
  const dim3 grid((tiles + per - 1) / per, bh);
  flash_wgmma_short_kernel<D, NK>
      <<<grid, L::kThreads, L::kSmem, stream>>>(tq, tk, tv, to, p, per);
  return (int)cudaGetLastError();
}

// N of Q K^T: S_kv rounded up to a width with a wgmma_ss wrapper
template <int D>
int launch_d(const Params& p, int batch, cudaStream_t stream) {
  if (p.skv <= 16) return launch<D, 16>(p, batch, stream);
  if (p.skv <= 32) return launch<D, 32>(p, batch, stream);
  if (p.skv <= 64) return launch<D, 64>(p, batch, stream);
  if (p.skv <= 80) return launch<D, 80>(p, batch, stream);
  return launch<D, 128>(p, batch, stream);
}

}  // namespace

extern "C" {

// The argument list of arbius_flash_attn_fwd (flash_attn.cu). Takes bf16
// (dtype 1) only, D = 40, 64, 80 or 160, 1 <= Skv <= 128, every B/H/S stride a
// multiple of 8 elements and 16-byte aligned q/k/v/o (ops/flash.py's route
// rule); o: contiguous [B, H, Sq, D]. Launches on `stream`, allocates
// nothing, and returns 0 on success, else a CUDA error code, or 1000 plus
// the driver's code where a tensor map cannot be encoded.
int arbius_flash_attn_wgmma_short_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int sq, int skv, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                                k_ss, v_sb, v_sh, v_ss};
  bool ok = dtype == 1 && (d == 40 || d == 64 || d == 80 || d == 160) &&
            sq > 0 && skv > 0 && skv <= 128 &&
            ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 ==
                0;
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    heads, sq,   skv,  d,    q_sb,
           q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb, v_sh, v_ss, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 40) return launch_d<40>(p, batch, st);
  if (d == 64) return launch_d<64>(p, batch, st);
  if (d == 80) return launch_d<80>(p, batch, st);
  return launch_d<160>(p, batch, st);
}

}  // extern "C"
