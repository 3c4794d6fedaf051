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
// at 3.35 TB/s and the products 3.3 us at 989 TFLOP/s. What keeps it from
// that bound differs by shape class (tools/flash_ablate.py on an NVIDIA
// H100 80GB HBM3 at 700 W):
//   - many 64-row query tiles a b*h (4096 and 9216 x 77 at D = 40,
//     zeroscopev2xl's 9216 to 576 x 77 at D = 64): each consumer's chain
//     from tile to tile (wait for Q, S, softmax, P V, O's staging and
//     store), with the loads alone at 70% of the time (`loads_only`) and
//     the epilogue's staging and store at ~20% (`no_epilogue`): 38-56% of
//     the bound. A fourth consumer at D = 40 keeps one more tile in
//     flight.
//   - one to four tiles a b*h over thousands of b*h (the video UNet's
//     256, 64 and 16 x 77, 64^2 and 16^2 at D = 64): a block that served
//     one b*h paid its own ramp (barriers, K and V, then Q) and drain
//     (the last store) for those few tiles, with one consumer of three at
//     work (12-45% of the bound). Persistent blocks walk many b*h, and
//     the next b*h's K and V land in a free slot while this one's tiles
//     run.
//   - fewer tiles than SMs (D = 160's 64^2 and 100^2 at 512x512 and
//     640x640): one tile's latency, ramp to drain, ~9-11 us a call.
//
// Design:
//   - persistent blocks over a flat tile schedule: tile w is (b*h, query
//     tile) = (w / nq, w % nq), so the tiles of one b*h are neighbours.
//     The grid is the SM count, or the tiles if fewer (`blocks`: or the
//     b*h's equal parts where those make no consumer's run longer, so
//     that neighbouring heads' blocks read the rows they share together),
//     and each block takes one contiguous range of the tiles: equal
//     ranges, give or take one, which may start or end inside a b*h. A
//     range's runs of one b*h are its segments. Tile j of the range goes
//     to consumer j % kConsumers, across segment boundaries. No atomics
//     and no tile counter in device memory: the kernel allocates nothing
//     and is captured in CUDA graphs.
//   - a producer warpgroup (one thread; setmaxnreg gives its registers to
//     the consumers) issues every TMA load in the order the consumers need
//     them: a segment's K and V into K/V slot s % kKVSlots, as many slots
//     as shared memory holds beside the rest (at most kMaxKVSlots), then
//     the segment's query tiles into TMA stages that are each consumer's
//     own (a shared ring let a consumer pass a barrier a phase early). A
//     slot is refilled once every consumer has moved past its segment:
//     each consumer waits for every segment's fill and frees it once done
//     with it, whether or not it took a tile there. Every barrier parity
//     follows a running count (segments for K/V, a consumer's tiles for
//     its Q stages), never a count inside one segment, and every tile
//     index steps on from the last (no division per tile).
//   - consumer warpgroups: four at D = 40, three at D = 64 and 80, two at
//     D = 160. The consumer's index is broadcast from lane 0, so the
//     compiler builds every wgmma descriptor in uniform registers.
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
//     the warpgroup that owns it and does not depend on the block or
//     consumer that takes its tile, on the slots or on the stages: results
//     are bit-identical from run to run and invariant to batch position.
#include "hopper.cuh"

namespace {

constexpr int kRow = 128;       // bytes of one 64-column block of a row
constexpr int kTile = 64;       // query rows per tile (a wgmma's M)
constexpr int kBarO = 1;  // named barrier kBarO + c: consumer c's epilogue
constexpr int kMaxKVSlots = 8;  // K/V slots, at most
// a block's shared memory (227 KB), less room for the static mbarriers
constexpr int kSmemMax = 227 * 1024 - 256;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int D, int NK>
struct Layout {
  // consumer warpgroups, each with a tile in flight: four at D = 40, whose
  // accumulators fit 112 registers (four were 1.06x faster than three at
  // 4096 and 9216 x 77, tools/flash_ablate.py), three at D = 64 and 80,
  // two at D = 160, whose accumulators need the registers; registers per
  // thread after setmaxnreg (65536 in all on the SM)
  static constexpr int kConsumers = D == 40 ? 4 : D == 160 ? 2 : 3;
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer
  static constexpr int kProducerRegs = D == 40 ? 24 : 40;
  static constexpr int kConsumerRegs = D == 40 ? 112 : D == 160 ? 232 : 152;
  static_assert(regs_balance(kThreads, kConsumers, kProducerRegs,
                             kConsumerRegs),
                "setmaxnreg cannot give the consumers these registers");
  static constexpr int kBlocks = (D + 63) / 64;    // 64-column blocks per row
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kQ = kBlocks * kTile * kRow;  // bytes of a Q tile
  static constexpr int kKV = kBlocks * NK * kRow;    // bytes of K (or V)
  // bytes of one O staging tile ([kTile][D] bf16), 1024-aligned
  static constexpr int kO = (kTile * D * 2 + 1023) & ~1023;
  // Q stages per consumer: two at D = 64, one elsewhere (D = 40 and 80
  // timed faster with one, and at D = 160 a second would leave one K/V
  // slot, none at NK = 128)
  static constexpr int kQStages = D == 64 ? 2 : 1;
  // the Q stages, an O staging tile per consumer and the slack that
  // aligns the base to 1024
  static constexpr int kFixed = kConsumers * (kQStages * kQ + kO) + 1024;
  // K/V slots (K and V of one b*h each), as many as fit beside those
  static constexpr int kKVSlots =
      cmin(kMaxKVSlots, (kSmemMax - kFixed) / (2 * kKV));
  static_assert(kKVSlots >= 1, "no K/V slot fits");
  static constexpr int kSmem = kFixed + kKVSlots * 2 * kKV;
  static_assert(kSmem <= kSmemMax,
                "the K/V slots, Q stages and O tiles exceed a block's "
                "shared memory");
};

template <class L>
struct Barriers {
  uint64_t kv_full[L::kKVSlots], kv_empty[L::kKVSlots];
  uint64_t q_full[L::kConsumers * L::kQStages];
  uint64_t q_empty[L::kConsumers * L::kQStages];
};

template <int D, int NK>
__global__ void __launch_bounds__(Layout<D, NK>::kThreads, 1)
    flash_wgmma_short_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to,
                             const Params p, int per, int extra) {
  using L = Layout<D, NK>;
  constexpr int kS = NK / 2;   // score accumulators per thread
  constexpr int kOut = D / 2;  // output accumulators per thread
  constexpr int kC = L::kConsumers;
  constexpr int kSlots = L::kKVSlots;

  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers<L> bars;
  // [slot][K, V][blk][NK][kRow]
  const uint32_t sKV = (smem_addr(smem_raw) + 1023) & ~1023u;
  // [consumer][stage][blk][kTile][kRow]
  const uint32_t sQ = sKV + kSlots * 2 * L::kKV;
  // [consumer][kTile][D]
  const uint32_t sO = sQ + kC * L::kQStages * L::kQ;

  // the block's tiles [t0, t0 + n) of the flat schedule: `per` each, and
  // one more for the first `extra` blocks; nq a b*h; its segments are b*h
  // bh0, bh0 + 1, ...
  const int nq = (p.sq + kTile - 1) / kTile;
  const int bi = blockIdx.x;
  const int t0 = bi * per + (bi < extra ? bi : extra);
  const int n = per + (bi < extra);
  const int bh0 = t0 / nq;
  const int kv_end = p.skv;  // keys at or past this are masked
  const float sl2 = p.scale * kLog2e;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(smem_addr(&bars.kv_full[s]), 1);
      mbar_init(smem_addr(&bars.kv_empty[s]), 128 * kC);
    }
    for (int s = 0; s < kC * L::kQStages; ++s) {
      mbar_init(smem_addr(&bars.q_full[s]), 1);
      mbar_init(smem_addr(&bars.q_empty[s]), 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread issues every TMA load, in the order the
    // consumers need them: a segment's K and V, then its query tiles
    // (every index steps on from the last; no division per tile)
    setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      // tile j: query tile qt of b*h (b, h) in segment s, the i-th tile of
      // consumer c
      int qt = t0 - bh0 * nq, b = bh0 / p.heads, h = bh0 - b * p.heads;
      for (int j = 0, c = 0, i = 0, s = -1; j < n; ++j) {
        if (j == 0 || qt == 0) {  // a segment's first tile: K and V first
          ++s;
          const uint32_t slot = sKV + (s % kSlots) * 2 * L::kKV;
          const uint32_t full = smem_addr(&bars.kv_full[s % kSlots]);
          mbar_wait(smem_addr(&bars.kv_empty[s % kSlots]),
                    ((s / kSlots) & 1) ^ 1);
          mbar_arrive_expect_tx(full, 2 * L::kKV);
          for (int x = 0; x < L::kBlocks; ++x) {  // keys past S_kv read as 0
            tma_load_4d(slot + x * NK * kRow, &tk, full, 64 * x, 0, h, b);
            tma_load_4d(slot + L::kKV + x * NK * kRow, &tv, full, 64 * x, 0,
                        h, b);
          }
        }
        const int st = c * L::kQStages + i % L::kQStages;
        const uint32_t full = smem_addr(&bars.q_full[st]);
        mbar_wait(smem_addr(&bars.q_empty[st]),
                  ((i / L::kQStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full, L::kQ);
        for (int x = 0; x < L::kBlocks; ++x)  // rows past Sq read as zeros
          tma_load_4d(sQ + st * L::kQ + x * kTile * kRow, &tq, full, 64 * x,
                      qt * kTile, h, b);
        if (++qt == nq) {
          qt = 0;
          if (++h == p.heads) h = 0, ++b;
        }
        if (++c == kC) c = 0, ++i;
      }
    }
  } else {
    // -- consumers: tiles c, c + kC, ... of the block's range --------------
    setmaxnreg_inc<L::kConsumerRegs>();
    // the consumer, broadcast from lane 0 so that the compiler knows it (and
    // every tile index and shared-memory address derived from it) is one
    // value across the warp: the wgmma descriptors are then built in
    // uniform registers, not moved there before each product
    const int c = __shfl_sync(0xffffffffu, wg - 1, 0);
    const int t = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;

    // the segments before s are freed, each after its fill, whether or
    // not this consumer took a tile there: a slot's next fill must not
    // count an arrival meant for this one, and no phase of a fill barrier
    // is skipped (a parity tells a phase from the next, not from the one
    // after that)
    int s = 0;
    auto free_to = [&](int seg) {
      for (; s < seg; ++s) {
        mbar_wait(smem_addr(&bars.kv_full[s % kSlots]), (s / kSlots) & 1);
        mbar_arrive(smem_addr(&bars.kv_empty[s % kSlots]));
      }
    };
    // tile j is query tile qt of b*h bh (qt steps on by kC a tile)
    int bh = bh0, qt = t0 - bh0 * nq + c;
    uint32_t sK = sKV;  // K of segment s; V follows it
    for (int j = c, i = 0; j < n; j += kC, ++i, qt += kC) {
      while (qt >= nq) qt -= nq, ++bh;
      if (j == c || bh - bh0 != s) {  // the first tile of a segment
        free_to(bh - bh0);
        mbar_wait(smem_addr(&bars.kv_full[s % kSlots]), (s / kSlots) & 1);
        sK = sKV + (s % kSlots) * 2 * L::kKV;
      }
      const uint32_t sV = sK + L::kKV;
      const int q0 = qt * kTile;
      const int st = c * L::kQStages + i % L::kQStages;
      mbar_wait(smem_addr(&bars.q_full[st]), (i / L::kQStages) & 1);

      // S = Q K^T over the whole (padded) key sequence
      float s_acc[kS];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < L::kSteps; ++ks) {
        const uint32_t blk = ks / 4, off = (ks % 4) * 32;
        wgmma_ss<NK>(s_acc,
                     desc_sw128(sQ + st * L::kQ + blk * kTile * kRow + off,
                                16, 1024),
                     desc_sw128(sK + blk * NK * kRow + off, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < kS; ++e) fence_reg(s_acc[e]);
      mbar_arrive(smem_addr(&bars.q_empty[st]));  // the Q stage is free

      // softmax in the log2 domain over one tile; a row's 4 owners are a
      // quad: rows lane/4 (+8), 8-key column tiles x: s_acc[4x..4x+3]
      if (kv_end < NK) {
#pragma unroll
        for (int e = 0; e < kS; ++e)
          if ((e >> 2) * 8 + 2 * (lane & 3) + (e & 1) >= kv_end)
            s_acc[e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < kS / 4; ++x) {
        mx[0] = fmaxf(mx[0], fmaxf(s_acc[4 * x], s_acc[4 * x + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s_acc[4 * x + 2], s_acc[4 * x + 3]));
      }
      float msc[2], l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        msc[r] = mx[r] * sl2;
      }
#pragma unroll
      for (int e = 0; e < kS; ++e)
        s_acc[e] = ex2(fmaf(s_acc[e], sl2, -msc[(e >> 1) & 1]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float rs = 0.f;
#pragma unroll
        for (int x = 0; x < kS / 4; ++x)
          rs += s_acc[4 * x + 2 * r] + s_acc[4 * x + 2 * r + 1];
        l[r] = rs;
      }

      // O = P V: P's bf16 A fragments, keys 16kk.. are S's column tiles
      // 2kk and 2kk + 1
      uint32_t pa[NK / 16][4];
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s_acc[8 * kk], s_acc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
      float o[kOut];
#pragma unroll
      for (int e = 0; e < kOut; ++e) o[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    desc_sw128(sV + kk * 16 * kRow, NK * kRow, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < kOut; ++e) fence_reg(o[e]);
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
      // staging tile before O / l is written there as bf16
      const uint32_t my_o = sO + c * L::kO;
      if (t == 0) bulk_wait_read<0>();
      named_sync(kBarO + c, 128);
      const int row = 16 * warp + (lane >> 2);
#pragma unroll
      for (int x = 0; x < kOut / 4; ++x) {
        const int col = 8 * x + 2 * (lane & 3);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           my_o + ((row + 8 * r) * D + col) * 2),
                       "r"(pack_bf16(o[4 * x + 2 * r] / l[r],
                                     o[4 * x + 2 * r + 1] / l[r]))
                       : "memory");
      }
      fence_proxy_async();
      named_sync(kBarO + c, 128);
      if (t == 0) {  // rows past Sq are not written
        tma_store_3d(&to, my_o, 0, q0, bh);
        bulk_commit();
      }
    }
    free_to((t0 + n - 1) / nq - bh0 + 1);  // the segments left
    // the last stores have read their staging tiles before the block
    // exits (their writes complete with the grid)
    if (t == 0) bulk_wait_read<0>();
  }
}

// The blocks of the flat schedule: one per SM, or per tile where there are
// fewer. Where a b*h's nq query tiles split into `parts` equal ranges whose
// longest consumer run is the SM count's, bh * parts blocks of those: the
// blocks of neighbouring heads then start at the same query tile and read
// the rows the heads share together (a D = 40 head's 80-byte row shares
// 32-byte sectors with its neighbours').
int blocks(int bh, int nq, int consumers) {
  const int work = bh * nq;
  const int grid = work < sm_count() ? work : sm_count();
  const int per = (work + grid - 1) / grid;  // the longest range
  const int parts = per < nq ? nq / per : 0;
  const int run = (per + consumers - 1) / consumers;
  if (parts > 0 && nq % parts == 0 &&
      (nq / parts + consumers - 1) / consumers == run)
    return bh * parts;
  return grid;
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
  // each block takes work / grid tiles, the first work % grid one more (an
  // int: 2^31 tiles of 64 rows would not fit in device memory)
  const int nq = (p.sq + kTile - 1) / kTile;
  const int work = bh * nq;
  const int grid = blocks(bh, nq, L::kConsumers);
  flash_wgmma_short_kernel<D, NK><<<grid, L::kThreads, L::kSmem, stream>>>(
      tq, tk, tv, to, p, work / grid, work % grid);
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
