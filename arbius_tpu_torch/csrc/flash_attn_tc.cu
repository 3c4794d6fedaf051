// Exact softmax attention on the tensor cores (mma.sync), for Hopper
// (sm_90a): the bf16 route for head dims 8..160 (multiples of 8).
//
// Replaces the Pallas TPU kernel `_kernel` launched by `flash_attention`
// in arbius_tpu/ops/flash.py (:34-60): out = softmax(q k^T / sqrt(D)) v
// over [B, H, S, D] tensors, with the running max m, the normaliser l and
// the accumulator in float32, keys past S_kv masked, and the output cast
// to q's dtype. The UNet's attentions (D = 40, 80, 160) come here; bf16 at
// D = 512 (the VAE) takes flash_attn_tc_wide.cu, and float32 the CUDA-core
// kernel in flash_attn.cu.
//
// What bounds it on this card: at the large self-attention shapes
// (S = 4096 x 4096, 1024 x 1024) operations, ~S/2 of them per byte of
// q/k/v, far above the H100's ~295 FLOP/byte ridge; at the 77-token
// cross-attention bytes (q read, o written once). Beside the two products
// every score costs one exp2 on the SFU (16 a clock per SM against ~2048
// tensor-core FMAs), so at D = 40, where a score carries only 2 x 40 FMAs,
// the exponentials cost about as much as the products and the 989 TFLOP/s
// bound is out of this design's reach.
//
// Design (FlashAttention-2's shape on Ampere-style instructions):
//   - one block of 4 warps per (b*h, 64-row query tile); warp w owns query
//     rows 16w..16w+15. The block walks key/value tiles of 64 rows in a
//     fixed order: no split-KV, no atomics, so results are bit-identical
//     from run to run and a row's arithmetic never depends on other rows
//     (batch-position invariant).
//   - q, k and v tiles are copied to shared memory with cp.async, 16 bytes
//     a thread; k/v are double-buffered, so tile t+1 loads while tile t
//     computes. Rows are padded by 16 bytes (an odd number of 16-byte
//     chunks per row), so the 8 row addresses of an ldmatrix hit 8
//     distinct bank groups. Rows past S (ragged tails) are zero-filled by
//     the copy itself (src-size 0), so no garbage reaches a product.
//   - S = Q K^T by mma.sync.m16n8k16 with bf16 operands and float32
//     accumulation. The contraction runs over D padded to a multiple of 16
//     (40 -> 48) with zero columns in shared memory, written once; the Q
//     fragments are loaded once per block and kept in registers.
//   - online softmax on the accumulator fragments in registers: a row's
//     4 owners are one quad, so the row max is two xor-shuffles; l is
//     summed per thread and reduced once at the end; exp2 with
//     scale*log2(e) folded into one FMA; keys >= S_kv are -inf.
//   - the float32 probabilities become the bf16 A fragments of P V in
//     registers (never through shared memory); l is summed from the
//     unrounded probabilities. V's B fragments come from ldmatrix.trans;
//     D is the product's n dimension in steps of 8, so D = 40 takes five
//     8-wide tiles and nothing is padded there.
//   - ragged query tiles are masked at the store.
#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per k/v tile
constexpr int kMaxD = 160;

// Copy rows [row0, row0 + rows) of a [S, D] slab with row stride `ss`
// into shared rows of pitch `pitch`; rows at or past `nvalid` are zeros.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int row0, int nvalid,
                                          int rows, int chunks, int pitch) {
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    const bool ok = r < nvalid;
    const bf16* g = src + (ok ? (long long)(row0 + r) * ss : 0) + c;
    cp_async16(smem_addr(dst + r * pitch + c), g, ok);
  }
}

// DP: the head dim rounded up to a multiple of 16 (the contraction step)
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_tc_kernel(const Params p) {
  constexpr int PITCH = DP + 8;  // elements: an odd number of 16-byte chunks
  constexpr int KS = DP / 16;    // contraction steps of Q K^T
  constexpr int NT = kBK / 8;    // 8-key column tiles of S
  constexpr int DT = DP / 8;     // 8-wide column tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][PITCH]
  bf16* sK = sQ + kBQ * PITCH;                   // [2][kBK][PITCH]
  bf16* sV = sK + 2 * kBK * PITCH;               // [2][kBK][PITCH]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.x * kBQ;
  const int D = p.d;
  const int chunks = D / 8;  // 16-byte chunks per row
  const int nd8 = D / 8;     // output column tiles in use
  const int ntiles = (p.skv + kBK - 1) / kBK;
  const int kv_end = p.skv;  // keys at or past this are masked
  const float sl2 = p.scale * kLog2e;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // zero the pad columns D..DP-1 of every shared row once; copies never
  // write them
  if (D < DP) {
    const int pad = (DP - D) / 8;
    for (int e = threadIdx.x; e < (kBQ + 4 * kBK) * pad; e += kThreads) {
      const int r = e / pad;
      const int c = D + 8 * (e - r * pad);
      *reinterpret_cast<uint4*>(sQ + r * PITCH + c) = make_uint4(0, 0, 0, 0);
    }
  }

  auto load_kv = [&](int t, int stage) {
    const int kv0 = t * kBK;
    const int nvalid = min(kBK, p.skv - kv0);
    load_rows(sK + stage * kBK * PITCH, kg, p.k_ss, kv0, nvalid, kBK, chunks,
              PITCH);
    load_rows(sV + stage * kBK * PITCH, vg, p.v_ss, kv0, nvalid, kBK, chunks,
              PITCH);
  };

  load_rows(sQ, qg, p.q_ss, q0, min(kBQ, p.sq - q0), kBQ, chunks, PITCH);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  // rows lane/4 and lane/4 + 8 of the warp's strip: [0] and [1]
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q) landed for every thread

    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], smem_addr(sQ + (warp * 16 + (lane & 15)) * PITCH +
                                  ks * 16 + (lane >> 4) * 8));
    }
    const bf16* kt = sK + stage * kBK * PITCH;
    const bf16* vt = sV + stage * kBK * PITCH;

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_addr(kt +
                              (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  PITCH +
                              ks * 16 + ((lane >> 3) & 1) * 8));
        mma(s[2 * jj], qf[ks], bk[0], bk[1]);
        mma(s[2 * jj + 1], qf[ks], bk[2], bk[3]);
      }
    }

    const int kv0 = t * kBK;
    if (kv0 + kBK > kv_end) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + j * 8 + 2 * (lane & 3) + (e & 1) >= kv_end)
            s[j][e] = -INFINITY;
    }

    // online softmax in the log2 domain
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m[r] - mx[r]) * sl2);
      m[r] = mx[r];
      msc[r] = mx[r] * sl2;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = ex2(fmaf(s[j][e], sl2, -msc[e >> 1]));
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

    // O += P V: P's bf16 A fragments straight from S's accumulators
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vrow = vt + (kk * 16 + (lane & 15)) * PITCH;
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        if (2 * dp + 1 < nd8) {
          ldsm_x4_t(bv, smem_addr(vrow + dp * 16 + (lane >> 4) * 8));
          mma(o[2 * dp], a, bv[0], bv[1]);
          mma(o[2 * dp + 1], a, bv[2], bv[3]);
        } else if (2 * dp < nd8) {
          ldsm_x2_t(bv, smem_addr(vrow + dp * 16));
          mma(o[2 * dp], a, bv[0], bv[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* og = static_cast<bf16*>(p.o) + (long long)bh * p.sq * D;
  const int row = q0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if (dt < nd8) {
      const int col = dt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s_row = row + 8 * r;
        if (s_row < p.sq) {
          const __nv_bfloat162 val = __floats2bfloat162_rn(
              o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
          *reinterpret_cast<__nv_bfloat162*>(og + (long long)s_row * D +
                                             col) = val;
        }
      }
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * (kBQ + 4 * kBK) * (DP + 8);
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.heads);
  flash_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  switch ((p.d + 15) / 16) {
    case 1: return launch<16>(p, batch, stream);
    case 2: return launch<32>(p, batch, stream);
    case 3: return launch<48>(p, batch, stream);
    case 4: return launch<64>(p, batch, stream);
    case 5: return launch<80>(p, batch, stream);
    case 6: return launch<96>(p, batch, stream);
    case 7: return launch<112>(p, batch, stream);
    case 8: return launch<128>(p, batch, stream);
    case 9: return launch<144>(p, batch, stream);
    case 10: return launch<160>(p, batch, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The argument list of arbius_flash_attn_fwd (flash_attn.cu). Takes
// bf16 (dtype 1) only, 8 <= D <= 160 with D % 8 == 0, every B/H/S stride
// a multiple of 8 elements and 16-byte aligned q/k/v (ops/flash.py's
// route rule); o: contiguous [B, H, Sq, D]. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() (0 on success).
int arbius_flash_attn_tc_fwd(const void* q, const void* k, const void* v,
                             void* o, int dtype, int batch, int heads, int sq,
                             int skv, int d, long long q_sb, long long q_sh,
                             long long q_ss, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, float scale, void* stream) {
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                                k_ss, v_sb, v_sh, v_ss};
  bool ok = dtype == 1 && d >= 8 && d <= kMaxD && d % 8 == 0 &&
            ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 ==
                0;
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    heads, sq,   skv,  d,    q_sb,
           q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb, v_sh, v_ss, scale};
  return (int)dispatch(p, batch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
