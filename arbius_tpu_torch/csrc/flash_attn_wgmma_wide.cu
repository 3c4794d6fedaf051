// Exact softmax attention at head dim 512 on Hopper's warpgroup tensor
// cores (wgmma), fed by TMA loads that each block of a thread-block
// cluster shares, for sm_90a: the bf16 route for the SD VAE's mid-block
// attention (one head, D = channels = 512, S = 4096 at 512x512, 9216 at
// 768x768) and any other single-head attention at D = 512.
//
// Replaces the Pallas TPU kernel `_kernel` launched by `flash_attention`
// in arbius_tpu/ops/flash.py (:34-60): out = softmax(q k^T / sqrt(D)) v
// over [B, H, S, D] tensors, with the running max m, the normaliser l and
// the accumulator in float32, and the output cast to q's dtype. It computes
// what the other tensor-core kernels compute: float32 scores, exp2 with
// scale*log2(e) folded into one FMA, keys >= S_kv at -inf, P rounded to
// bf16 before P V, l summed from the unrounded P, acc / l cast to bf16.
//
// What bounds it on this card: operations. A call is 4 B H Sq Skv D FLOP
// against 2 B H D (2 Sq + 2 Skv) bytes, ~S/2 FLOP per byte, far above the
// H100's ~295 (0.139 ms of products at S = 4096, B = 4). What stands
// between a kernel and that bound at D = 512 (flash_attn_tc_wide.cu, its
// mma.sync predecessor, reached a fifth of it):
//   - a 64-row query tile's float32 accumulator is 128 KB: no one
//     warpgroup holds it, so two consumer warpgroups split O by columns
//     (64 x 256 each, 128 registers a thread) and each needs all of P;
//   - so a block holds 64 query rows, and every block streams all of K
//     and V into its shared memory: 128 KB per 64-key tile against 8.4
//     MFLOP, 64 FLOP per byte. On the H100 the loads alone (no products)
//     take 0.19 ms at S = 4096: ~47 B/clk into each SM, about what the
//     tensor cores need at this ratio (tools/flash_ablate.py, PERF.md).
//
// Design:
//   - one block per (b*h, 64-row query tile): a producer warpgroup (two
//     threads issue the TMA loads, one Q and the K ring, one the V tile,
//     so neither stream waits on the other's slots; setmaxnreg gives the
//     warpgroup's registers to the consumers) and two consumer
//     warpgroups. Consumer c owns output columns 256c .. 256c + 255 of all
//     64 rows; both compute the whole S = Q K^T of a key tile, so P and l
//     stay in each one's registers and the two never wait on each other
//     (the products of Q K^T are done twice: 1.5x the tensor work of the
//     call, against two barriers and a trip of P through shared memory
//     per tile).
//   - blocks of kCluster adjacent query tiles of the same (b, h) form a
//     cluster. Each K or V box (64 keys x 64 columns, 8 KB, the 128-byte
//     swizzle) is loaded from L2 once per cluster, by the block whose
//     rank is the box's index mod kCluster, and multicast into the same
//     offset of every block's shared memory: the call's L2 reads divided
//     by kCluster. A slot is refilled only after every consumer warp of
//     every block of the cluster has released it (each warp arrives on
//     the slot's empty barrier in every block, lane r in block r). The
//     grid's query tiles are rounded up to whole clusters: a block past Sq
//     loads zeros for Q, takes its part in the loads, and stores nothing.
//     (On the H100 clusters of 1 and 2 measured level and 4 slower: the
//     limit is what each SM takes in, not what L2 gives out.)
//   - shared memory: Q (64 KB, 8 boxes, loaded once), a ring of 12 K-box
//     slots (a tile's 8 boxes and 4 of the next one's) and the tile's 8 V
//     boxes (consumer c reads boxes 4c .. 4c + 3): 224 KB.
//   - S = Q K^T: wgmma m64n64k16, Q and K K-major from shared memory, 32
//     k16 steps, committed as one group per K box, so each box is released
//     as soon as its products are done. O += P V: wgmma m64n256k16, P as
//     the A operand from registers (S's accumulator layout packed to bf16
//     pairs), V's four boxes as B, MN-major (the transpose bit), 64-column
//     blocks 8 KB apart. Each product is issued only once every box it
//     reads has landed, and retired within its tile, with the accumulator
//     registers fenced around it: a wait, a branch or a register copy in
//     the middle makes ptxas serialise the products (its notes C7514 to
//     C7520); serialised, the call took 3x as long at S = 4096.
//   - keys >= S_kv are masked: TMA reads the rows past S_kv as zeros, which
//     would score 0, not -inf. Rows of a query tile past Sq are not stored.
//   - the key tiles are walked in a fixed order: no split-KV, no atomics,
//     and a query row's arithmetic is the same whatever the cluster size,
//     the grid or the block that issued a load, so results are
//     bit-identical from run to run and invariant to batch position.
#include "hopper.cuh"

namespace {

constexpr int kD = 512;            // the head dim this kernel takes
constexpr int kRow = 128;          // bytes of one 64-column block of a row
constexpr int kBQ = 64;            // query rows per block (one wgmma's M)
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kBoxes = kD / 64;    // 64-column boxes of a row: 8
constexpr int kBox = 64 * kRow;    // bytes of a 64-row box: 8 KB
constexpr int kKSlots = 12;        // the ring of K boxes
constexpr int kCluster = 2;        // blocks per cluster, sharing each load
constexpr int kConsumers = 2;      // warpgroups of 256 output columns each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer
// registers per thread after setmaxnreg (65536 in all on the SM)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(regs_balance(kThreads, kConsumers, kProducerRegs,
                           kConsumerRegs),
              "setmaxnreg cannot give the consumers these registers");
constexpr int kQ = kBoxes * kBox;  // bytes of the Q tile
// Q, the K ring, the V tile, and slack to align the base to 1024 bytes
constexpr int kSmem = kQ + (kKSlots + kBoxes) * kBox + 1024;
constexpr uint16_t kMask = (1u << kCluster) - 1;  // every block of a cluster

struct Barriers {
  uint64_t q;
  uint64_t full_k[kKSlots], empty_k[kKSlots];
  uint64_t full_v[kBoxes], empty_v[kBoxes];
};

// one arrival per warp on the barrier at offset `bar` in every block of
// the cluster (lane r arrives in block r, all in one instruction): this
// warp has finished reading the slot
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  mbar_arrive_cluster(bar, lane, lane < kCluster);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params p) {
  constexpr int kS = kBK / 2;                 // score accumulators a thread
  constexpr int kO = kD / kConsumers / 2;     // output accumulators a thread

  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers bars;
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;  // [box][kBQ]
  const uint32_t sK = sQ + kQ;                 // [slot][kBK][kRow]
  const uint32_t sV = sK + kKSlots * kBox;     // [box][kBK][kRow]

  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (p.skv + kBK - 1) / kBK;
  const int kv_end = p.skv;  // keys at or past this are masked
  const float sl2 = p.scale * kLog2e;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&bars.q), 1);
    // every consumer warp of every block reads a K box, consumer c's four
    // warps its V boxes
    for (int s = 0; s < kKSlots; ++s) {
      mbar_init(smem_addr(&bars.full_k[s]), 1);
      mbar_init(smem_addr(&bars.empty_k[s]), 4 * kConsumers * kCluster);
    }
    for (int s = 0; s < kBoxes; ++s) {
      mbar_init(smem_addr(&bars.full_v[s]), 1);
      mbar_init(smem_addr(&bars.empty_v[s]), 4 * kCluster);
    }
    fence_barrier_init();
  }
  // the other blocks multicast into this one and arrive on its barriers
  // only once they are initialised
  cluster_sync();

  if (wg == 0) {
    // -- producer: two threads issue this block's TMA loads, one Q and the
    // K ring, one the V tile, so that neither stream waits on the other's
    // slots. Each box is issued by one block of the cluster into all.
    // Keys past S_kv read as zeros.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint32_t rank = cluster_ctarank();
      const uint32_t bq = smem_addr(&bars.q);
      mbar_arrive_expect_tx(bq, kQ);
      for (int c = 0; c < kBoxes; ++c)  // rows past Sq read as zeros
        tma_load_4d(sQ + c * kBox, &tq, bq, 64 * c, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        for (int c = 0; c < kBoxes; ++c) {
          const int f = t * kBoxes + c;  // the ring's f-th fill
          const int st = f % kKSlots;
          const uint32_t fk = smem_addr(&bars.full_k[st]);
          mbar_wait(smem_addr(&bars.empty_k[st]), ((f / kKSlots) & 1) ^ 1);
          mbar_arrive_expect_tx(fk, kBox);
          if (c % kCluster == (int)rank)
            tma_load_4d_multicast(sK + st * kBox, &tk, fk, kMask, 64 * c,
                                  t * kBK, h, b);
        }
      }
    } else if (threadIdx.x == 32) {
      const uint32_t rank = cluster_ctarank();
      for (int t = 0; t < ntiles; ++t) {
        for (int c = 0; c < kBoxes; ++c) {
          const uint32_t fv = smem_addr(&bars.full_v[c]);
          mbar_wait(smem_addr(&bars.empty_v[c]), (t & 1) ^ 1);
          mbar_arrive_expect_tx(fv, kBox);
          if (c % kCluster == (int)rank)
            tma_load_4d_multicast(sV + c * kBox, &tv, fv, kMask, 64 * c,
                                  t * kBK, h, b);
        }
      }
    }
  } else {
    // -- consumers: all 64 query rows, 256 output columns each --------------
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    float s[kS];     // S: rows lane/4 (+8), 8-key column tiles j: s[4j..]
    float o[kO];     // O: the same layout over the consumer's 256 columns
    uint32_t pa[kBK / 16][4];  // P_t as bf16 A fragments, 16 keys each
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
    float alpha[2];

    // The products' registers: no write of the softmax may move past the
    // wgmma fence, nor a read before the wait that retires a product (an
    // ordinary instruction that reads or defines them inside a product's
    // pipeline stage makes ptxas serialise the products).
    auto fence_all = [&]() {
#pragma unroll
      for (int i = 0; i < kS; ++i) fence_reg(s[i]);
#pragma unroll
      for (int i = 0; i < kO; ++i) fence_reg(o[i]);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_reg(pa[kk][e]);
    };

    mbar_wait(smem_addr(&bars.q), 0);
    for (int t = 0; t < ntiles; ++t) {
      // K_t has landed (a wait between two products would make ptxas
      // serialise them)
#pragma unroll
      for (int box = 0; box < kBoxes; ++box) {
        const int f = t * kBoxes + box;
        mbar_wait(smem_addr(&bars.full_k[f % kKSlots]), (f / kKSlots) & 1);
      }
      // S_t = Q K_t^T
      fence_all();
      wgmma_fence();
#pragma unroll
      for (int box = 0; box < kBoxes; ++box) {
        const uint32_t slot = sK + ((t * kBoxes + box) % kKSlots) * kBox;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss<kBK>(s, desc_sw128(sQ + box * kBox + ks * 32, 16, 1024),
                        desc_sw128(slot + ks * 32, 16, 1024), box + ks > 0);
        wgmma_commit();  // one group per K box
      }

      // the groups retire in order, K box 0, 1, ...: each slot is
      // released as soon as its products are done
#pragma unroll
      for (int box = 0; box < kBoxes; ++box) {
        wgmma_wait_n(kBoxes - 1 - box);
        release(smem_addr(&bars.empty_k[(t * kBoxes + box) % kKSlots]),
                lane);
      }
      fence_all();

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

      // O += P_t V_t, retired before the next tile (a product in flight
      // across the loop's back-edge made ptxas serialise them); the other
      // consumer's products keep the tensor cores busy meanwhile
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mbar_wait(smem_addr(&bars.full_v[4 * c + i]), t & 1);
      fence_all();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<256>(o, pa[kk],
                      desc_sw128(sV + 4 * c * kBox + kk * 16 * kRow, kBox,
                                 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_all();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        release(smem_addr(&bars.empty_v[4 * c + i]), lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bf16* og = static_cast<bf16*>(p.o) + (long long)bh * p.sq * kD;
    const int row = q0 + 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int col = (kD / kConsumers) * c + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row + 8 * r < p.sq) {  // rows past Sq, and blocks past it
          const __nv_bfloat162 val = __floats2bfloat162_rn(
              o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
          *reinterpret_cast<__nv_bfloat162*>(
              og + (long long)(row + 8 * r) * kD + col) = val;
        }
      }
    }
  }
  // no block leaves while another may still arrive on its barriers
  cluster_sync();
}

int launch(const Params& p, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, p.q, batch, p.heads, p.sq, kD, p.q_sb, p.q_sh,
                       p.q_ss, kBQ);
  if (err == 0)
    err = encode_map(&tk, p.k, batch, p.heads, p.skv, kD, p.k_sb, p.k_sh,
                     p.k_ss, kBK);
  if (err == 0)
    err = encode_map(&tv, p.v, batch, p.heads, p.skv, kD, p.v_sb, p.v_sh,
                     p.v_ss, kBK);
  if (err != 0) return err;
  // the query tiles, rounded up to whole clusters
  const int tiles = (p.sq + kBQ - 1) / kBQ;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + kCluster - 1) / kCluster * kCluster,
                     batch * p.heads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  Params args = p;
  void* argv[] = {&tq, &tk, &tv, &args};
  const cudaError_t launched = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(flash_wgmma_wide_kernel), argv);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The argument list of arbius_flash_attn_fwd (flash_attn.cu). Takes bf16
// (dtype 1) only, D = 512, any Sq and Skv >= 1, every B/H/S stride a
// multiple of 8 elements and 16-byte aligned q/k/v/o (ops/flash.py's
// route rule); o: contiguous [B, H, Sq, D]. Launches on `stream`,
// allocates nothing, and returns 0 on success, else a CUDA error code, or
// 1000 plus the driver's code where a tensor map cannot be encoded.
int arbius_flash_attn_wgmma_wide_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int heads, int sq, int skv, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                                k_ss, v_sb, v_sh, v_ss};
  bool ok = dtype == 1 && d == kD && sq > 0 && skv > 0 &&
            ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 ==
                0;
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    heads, sq,   skv,  d,    q_sb,
           q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb, v_sh, v_ss, scale};
  return launch(p, batch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
