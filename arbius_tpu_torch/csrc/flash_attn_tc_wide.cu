// Exact softmax attention on the tensor cores (mma.sync) for wide heads,
// for Hopper (sm_90a): the bf16 route for head dim 512.
//
// Replaces the Pallas TPU kernel `_kernel` launched by `flash_attention`
// in arbius_tpu/ops/flash.py (:34-60): out = softmax(q k^T / sqrt(D)) v
// over [B, H, S, D] tensors, with the running max m, the normaliser l and
// the accumulator in float32, keys past S_kv masked, and the output cast
// to q's dtype. The SD VAE's mid-block attention (one head, D = 512 =
// channels, S = 4096 at 512x512) comes here; flash_attn_tc.cu takes
// bf16 at D <= 160 and flash_attn.cu everything else.
//
// What bounds it on this card: at S = 4096 the call is ~S/2 operations
// per byte of q/k/v, far above the H100's ~295 FLOP/byte ridge, so the
// bound is operations. At D = 512 a 64-row query tile's float32
// accumulator is 128 KB, so it lives split over 8 warps and Q cannot stay
// in registers: every 64-key tile re-reads Q, K, V and P from shared
// memory with ldmatrix (~656 KB a tile against 8.4 MFLOP), and that
// shared-memory traffic, not the tensor cores, is what this design is
// held to; K and V are re-read from L2 once per block.
//
// Design (FlashAttention-2's order on Ampere-style instructions):
//   - one block of 8 warps per (b*h, 64-row query tile), one block per SM
//     (__launch_bounds__(256, 1)): warp w owns query rows 16*(w % 4) ..
//     +15 (its row group) and half w / 4 of the keys of S and of D of O.
//     The block walks 64-key tiles in a fixed order: no split-KV, no
//     atomics, so results are bit-identical from run to run and a row's
//     arithmetic never depends on other rows (batch-position invariant).
//   - shared memory holds the Q tile (loaded once), one K tile and one V
//     tile, each row padded by 16 bytes (an odd number of 16-byte chunks,
//     so the 8 row addresses of an ldmatrix hit 8 distinct bank groups),
//     plus P and the row statistics: 204.5 KB. V(t) is copied with
//     cp.async while S(t) = Q K(t)^T runs, K(t+1) while P V(t) runs. Rows
//     past S are zero-filled by the copy itself (src-size 0).
//   - S: warp (g, c) computes S[16 rows of g, 32 keys of half c] by
//     mma.sync.m16n8k16 (bf16 in, float32 accumulate) over the full
//     512-deep contraction in a fixed order, Q's A fragments re-read with
//     ldmatrix every tile. Keys >= S_kv are -inf.
//   - the two warps of a row group swap their halves' row maxima through
//     shared memory (a 64-thread named barrier), so both rescale with the
//     same m; each sums l from the unrounded probabilities of its own key
//     half (the two halves' l are added once, at the end) and writes its
//     probabilities to shared memory as bf16.
//   - O: warp (g, c) computes O[16 rows of g, D half c] += P[16 rows, 64
//     keys] V[64 keys, D half c], V's B fragments from ldmatrix.trans.
//   - ragged query tiles are masked at the store.
// P is rounded to bf16 before P V and l sums the unrounded P, as in
// flash_attn_tc.cu, so ops/flash.py's tensor-core error bound holds here.
#include "tensor_core.cuh"

namespace {

constexpr int kGroups = 4;              // row groups of 16 query rows
constexpr int kWarps = 2 * kGroups;     // two warps (halves) per group
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kGroups;       // query rows per block
constexpr int kBK = 64;                 // keys per k/v tile
constexpr int kHalfK = kBK / 2;         // keys of S per warp
constexpr int kPPitch = kBK + 8;        // P's row pitch, elements

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Copy rows [row0, row0 + kBQ or kBK) of a [S, D] slab with row stride
// `ss` into shared rows of pitch D + 8; rows at or past `nvalid` are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int row0,
                                          int nvalid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CHUNKS % kThreads == 0, "uneven copy");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / CHUNKS;
    const int c = (e - r * CHUNKS) * 8;
    const bool ok = r < nvalid;
    const bf16* g = src + (ok ? (long long)(row0 + r) * ss : 0) + c;
    cp_async16(smem_addr(dst + r * (D + 8) + c), g, ok);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((kBQ + 2 * kBK) * (D + 8) + kBQ * kPPitch) +
         sizeof(float) * 2 * kBQ;
}

// D: the head dim, a multiple of 32 (each warp's output half is a whole
// number of 16-column ldmatrix steps)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_wide_kernel(const Params p) {
  constexpr int PITCH = D + 8;   // elements: an odd number of 16-byte chunks
  constexpr int KS = D / 16;     // contraction steps of Q K^T
  constexpr int NT = kHalfK / 8; // 8-key column tiles of a warp's S
  constexpr int DH = D / 2;      // output columns per warp
  constexpr int DT = DH / 8;     // 8-wide output tiles per warp
  static_assert(D % 32 == 0, "D must be a multiple of 32");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][PITCH]
  bf16* sK = sQ + kBQ * PITCH;                   // [kBK][PITCH]
  bf16* sV = sK + kBK * PITCH;                   // [kBK][PITCH]
  bf16* sP = sV + kBK * PITCH;                   // [kBQ][kPPitch]
  // [2][kBQ]: per key half, the row maxima of a tile, then l at the end
  float* sStat = reinterpret_cast<float*>(sP + kBQ * kPPitch);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = warp % kGroups;   // query rows 16*grp .. 16*grp + 15
  const int half = warp / kGroups;  // key half of S, D half of O
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (p.skv + kBK - 1) / kBK;
  const int kv_end = p.skv;  // keys at or past this are masked
  const float sl2 = p.scale * kLog2e;
  // block rows of this thread's accumulator elements [0..1] and [2..3]
  const int r0 = grp * 16 + (lane >> 2);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_rows<D, kBQ>(sQ, qg, p.q_ss, q0, min(kBQ, p.sq - q0));
  load_rows<D, kBK>(sK, kg, p.k_ss, 0, min(kBK, p.skv));
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  // rows r0 and r0 + 8: [0] and [1]
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * kBK;
    cp_async_wait<0>();
    // K(t) (and Q) landed for every thread; every warp is done with
    // V(t-1) and P(t-1)
    __syncthreads();
    load_rows<D, kBK>(sV, vg, p.v_ss, kv0, min(kBK, p.skv - kv0));
    cp_async_commit();

    // S = Q K^T for the warp's 16 rows x 32 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* qrow = sQ + (grp * 16 + (lane & 15)) * PITCH + (lane >> 4) * 8;
    const bf16* krow =
        sK + (half * kHalfK + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, smem_addr(qrow + ks * 16));
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_addr(krow + jj * 16 * PITCH + ks * 16));
        mma(s[2 * jj], a, bk[0], bk[1]);
        mma(s[2 * jj + 1], a, bk[2], bk[3]);
      }
    }

    const int key0 = kv0 + half * kHalfK;
    if (key0 + kHalfK > kv_end) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + 2 * (lane & 3) + (e & 1) >= kv_end)
            s[j][e] = -INFINITY;
    }

    // the row max over both key halves, then the online softmax in the
    // log2 domain
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if ((lane & 3) == 0) {
      sStat[half * kBQ + r0] = mx[0];
      sStat[half * kBQ + r0 + 8] = mx[1];
    }
    named_barrier(1 + grp, 64);  // the row group's two warps
    float alpha[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(m[r], mx[r]), sStat[(1 - half) * kBQ + r0 + 8 * r]);
      alpha[r] = ex2((m[r] - mx[r]) * sl2);
      m[r] = mx[r];
      msc[r] = mx[r] * sl2;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = ex2(fmaf(s[j][e], sl2, -msc[e >> 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) rs += s[j][2 * r] + s[j][2 * r + 1];
      l[r] = l[r] * alpha[r] + rs;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // the warp's probabilities, bf16, into the row group's P
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = half * kHalfK + j * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(sP + r0 * kPPitch + col) =
          pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(sP + (r0 + 8) * kPPitch + col) =
          pack_bf16(s[j][2], s[j][3]);
    }

    cp_async_wait<0>();
    // V(t) landed; P is whole; every warp is done with K(t)
    __syncthreads();
    if (t + 1 < ntiles) {
      load_rows<D, kBK>(sK, kg, p.k_ss, kv0 + kBK,
                        min(kBK, p.skv - kv0 - kBK));
      cp_async_commit();
    }

    // O += P V for the warp's 16 rows x D half
    const bf16* prow = sP + (grp * 16 + (lane & 15)) * kPPitch + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_addr(prow + kk * 16));
      const bf16* vrow =
          sV + (kk * 16 + (lane & 15)) * PITCH + half * DH + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_addr(vrow + dp * 16));
        mma(o[2 * dp], a, bv[0], bv[1]);
        mma(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

  // l over both key halves: half 0's sum + half 1's, in that order in
  // both warps (every read of the row maxima was before the last tile's
  // __syncthreads)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if ((lane & 3) == 0) {
    sStat[half * kBQ + r0] = l[0];
    sStat[half * kBQ + r0 + 8] = l[1];
  }
  named_barrier(1 + grp, 64);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = sStat[r0 + 8 * r] + sStat[kBQ + r0 + 8 * r];

  bf16* og = static_cast<bf16*>(p.o) + (long long)bh * p.sq * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = half * DH + dt * 8 + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s_row = q0 + r0 + 8 * r;
      if (s_row < p.sq) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(
            o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)s_row * D + col) =
            val;
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_wide_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.heads);
  flash_tc_wide_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The argument list of arbius_flash_attn_fwd (flash_attn.cu). Takes
// bf16 (dtype 1) only, D = 512, every B/H/S stride a multiple of 8
// elements and 16-byte aligned q/k/v (ops/flash.py's route rule); o:
// contiguous [B, H, Sq, D]. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 on success).
int arbius_flash_attn_tc_wide_fwd(const void* q, const void* k,
                                  const void* v, void* o, int dtype,
                                  int batch, int heads, int sq, int skv,
                                  int d, long long q_sb, long long q_sh,
                                  long long q_ss, long long k_sb,
                                  long long k_sh, long long k_ss,
                                  long long v_sb, long long v_sh,
                                  long long v_ss, float scale, void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                                k_ss, v_sb, v_sh, v_ss};
  bool ok = dtype == 1 && d == 512 &&
            ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 ==
                0;
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    heads, sq,   skv,  d,    q_sb,
           q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb, v_sh, v_ss, scale};
  return (int)launch<512>(p, batch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
