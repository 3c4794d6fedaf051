// Exact softmax attention, flash-style, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` launched by `flash_attention`
// in arbius_tpu/ops/flash.py: out = softmax(q k^T / sqrt(D)) v over
// [B, H, S, D] tensors, with the row statistics (running max m, normaliser
// l) and the accumulator in float32, and the output cast to q's dtype.
//
// Which calls come here (ops/flash.py's route rule): float32 at every
// head dim, and bf16 at a head dim the tensor-core routes do not take or
// with strides that are not multiples of 8 elements or data that is not
// 16-byte aligned. bf16 at 8 <= D <= 160 (the UNet) takes flash_attn_tc.cu
// and bf16 at D = 512 (the VAE) flash_attn_tc_wide.cu; a caller can still
// force this kernel on any input to check it against them.
//
// What bounds it on this card: at the UNet's self-attention shapes
// (S = 4096, D = 40..160) the work is ~S/2 operations per byte of
// q/k/v, far above the H100's ~295 FLOP/byte ridge, so the kernel is
// bound by arithmetic; the score matrix (S x S per head) is what a naive
// version would move through device memory, and this kernel never writes
// it. This first version does its arithmetic in float32 on the CUDA cores
// (no tensor cores), so it is bounded by the 67 TFLOP/s float32 rate and
// by shared-memory reads, well short of the bf16 tensor-core bound; a
// wgmma/TMA redesign is the follow-up.
//
// Design:
//   - one block of 256 threads (16 x 16) per (b*h, tile of BQ query rows);
//     the block loops over key/value tiles of BK rows in a fixed order, so
//     each output row is made by one block in one order: no split-KV, no
//     atomics. Results are bit-identical from run to run and independent
//     of the batch (a row's arithmetic never depends on other rows).
//   - q, k and v tiles are staged in shared memory in the input dtype,
//     with a row pitch chosen so that 16 threads reading 16 different rows
//     at one column hit 16 different banks.
//   - thread (ty, tx) owns query rows ty + 16*i and, for the scores, key
//     columns tx + 16*j; a row's 16 owners sit in one half-warp, so the
//     row max and row sum are xor-shuffles within it. For the output it
//     owns head-dim columns tx + 16*dj, held in registers (NDJ slots).
//   - the key length is bounds-checked here: no padding in device memory.
//     Masked scores are -inf, so they contribute exp(-inf) = 0.
//   - head dims up to 512: D <= 256 uses 64-row query tiles; D = 512
//     uses 32-row query tiles so the accumulator stays at 64 registers and
//     the tiles fit in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory row pitch in elements: an odd number of 32-bit words, so
// a column walk over 16 rows touches 16 distinct banks.
template <typename T>
__host__ __device__ inline int row_pitch(int d) {
  if (sizeof(T) == 4) return d | 1;
  int p = (d + 1) & ~1;          // even, so rows start on a word
  if ((p / 2) % 2 == 0) p += 2;  // odd number of words
  return p;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, sq, skv, d;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale;
};

template <typename T, int BQ, int BK, int NDJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int TM = BQ / 16;  // query rows per thread
  constexpr int TN = BK / 16;  // key columns per thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.x * BQ;
  const int D = p.d;
  const int P = row_pitch<T>(D);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sP = reinterpret_cast<float*>(smem_raw);          // [BQ][BK + 1]
  T* sQ = reinterpret_cast<T*>(sP + BQ * (BK + 1));        // [BQ][P]
  T* sK = sQ + BQ * P;                                     // [BK][P]
  T* sV = sK + BK * P;                                     // [BK][P]

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T zero = from_f32<T>(0.f);

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    const int s = q0 + r;
    sQ[r * P + c] = (s < p.sq) ? qg[s * p.q_ss + c] : zero;
  }

  float m[TM], l[TM], acc[TM][NDJ];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dj = 0; dj < NDJ; ++dj) acc[i][dj] = 0.f;
  }

  for (int kv0 = 0; kv0 < p.skv; kv0 += BK) {
    const int nvalid = min(BK, p.skv - kv0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const bool ok = r < nvalid;
      const long long s = kv0 + r;
      sK[r * P + c] = ok ? kg[s * p.k_ss + c] : zero;
      sV[r * P + c] = ok ? vg[s * p.v_ss + c] : zero;
    }
    __syncthreads();

    // scores for rows ty + 16i, columns tx + 16j of this tile
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = to_f32(sQ[(ty + 16 * i) * P + c]);
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = to_f32(sK[(tx + 16 * j) * P + c]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: new running max, rescale, exponentiate, row sums
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float val = (tx + 16 * j < nvalid) ? s[i][j] * p.scale
                                                 : -INFINITY;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int dj = 0; dj < NDJ; ++dj) acc[i][dj] *= alpha;
    }
    __syncthreads();

    // acc += P V over the valid rows of the tile
    for (int c = 0; c < nvalid; ++c) {
      float pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = sP[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int dj = 0; dj < NDJ; ++dj) {
        const int d = tx + 16 * dj;
        if (d < D) {
          const float vv = to_f32(sV[c * P + d]);
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][dj] = fmaf(pv[i], vv, acc[i][dj]);
        }
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < p.sq) {
      T* row = og + ((long long)bh * p.sq + s) * D;
#pragma unroll
      for (int dj = 0; dj < NDJ; ++dj) {
        const int d = tx + 16 * dj;
        if (d < D) row[d] = from_f32<T>(acc[i][dj] / l[i]);
      }
    }
  }
}

template <typename T, int BQ, int BK, int NDJ>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int P = row_pitch<T>(p.d);
  const size_t smem = sizeof(float) * BQ * (BK + 1) +
                      sizeof(T) * (size_t)(BQ + 2 * BK) * P;
  static size_t smem_set = 0;  // largest dynamic size granted so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, BQ, BK, NDJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid((p.sq + BQ - 1) / BQ, batch * p.heads);
  flash_fwd_kernel<T, BQ, BK, NDJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, cudaStream_t stream) {
  if (p.d <= 64) return launch<T, 64, 64, 4>(p, batch, stream);
  if (p.d <= 128) return launch<T, 64, 64, 8>(p, batch, stream);
  if (p.d <= 160) return launch<T, 64, 64, 10>(p, batch, stream);
  if (p.d <= 256) return launch<T, 64, 64, 16>(p, batch, stream);
  if (p.d <= 512)
    return launch<T, 32, (sizeof(T) == 2 ? 64 : 32), 32>(p, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v: [B, H, S, D] with any strides on B, H and S and unit stride on
// D; o: contiguous [B, H, Sq, D]. dtype 0 = float32, 1 = bfloat16.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// (0 on success).
int arbius_flash_attn_fwd(const void* q, const void* k, const void* v,
                          void* o, int dtype, int batch, int heads, int sq,
                          int skv, int d, long long q_sb, long long q_sh,
                          long long q_ss, long long k_sb, long long k_sh,
                          long long k_ss, long long v_sb, long long v_sh,
                          long long v_ss, float scale, void* stream) {
  Params p{q,    k,    v,    o,    heads, sq,   skv,  d,    q_sb,
           q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb, v_sh, v_ss, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, batch, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, batch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
