// Prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention.py:
//   sz_flash_attention  <- flash_attention (_kernel)
//
// What it computes: causal or non-causal multi-head attention with grouped
// KV heads (query head h reads KV head h / (H / Hkv)) and a value width that
// may differ from the query/key width (MLA prefill: d 96, dv 64).  q (B, Sq,
// H, d), k (B, Skv, Hkv, d), v (B, Skv, Hkv, dv), bf16 or f32, with any
// strides over (B, S, H) and unit stride over the head dimension; out (B,
// Sq, H, dv) contiguous, in the input type.  Arithmetic as the TPU kernel:
// q, k, v in f32, s = (q . k) * scale, masked scores -1e30 (k_pos >= Skv,
// and k_pos > q_pos when causal, both positions from 0), an online softmax
// over KV tiles with f32 m, l and acc, p kept in f32 for p . v, and
// out = acc / max(l, 1e-30) rounded once to the output type.
//
// Bound.  The function must read q, k and v once and write out once,
// 2 * (B Sq H d + B Skv Hkv (d + dv) + B Sq H dv) bytes in bf16, and do
// 2 B H Sq Skv (d + dv) operations (half of that when causal).  At the
// served prefill shapes (Sq = Skv = 1000 to 2048) the operations outweigh
// the bytes by two orders of magnitude: the kernel is bound by arithmetic.
//
// Design, the simple one (correct first; wgmma, TMA and a split-KV grid
// come later):
//   * one CTA of 256 threads per (64-query block, batch * head), the
//     heaviest causal blocks launched first; the CTA loops over 64-key
//     tiles up to the causal diagonal and never visits the tiles above it
//     (the loop replaces the TPU's sequential KV grid axis);
//   * masks instead of the Pallas wrapper's padding copies: rows past Sq
//     load zeros and are never stored, keys past Skv load zeros and score
//     -1e30;
//   * tiles live in shared memory as f32, rows padded by one float so the
//     column reads of the two products hit distinct banks; K and V share
//     one buffer (V is loaded after the scores are done with K), so at
//     d = 128 a CTA takes 83 KB and two fit on an SM;
//   * each thread owns a 4 x 4 block of the 64 x 64 score tile (rows
//     ty + 16 i, keys tx + 16 j) and 4 rows x CPT columns of acc in
//     registers; the 16 threads of a row group reduce its max and sum with
//     warp shuffles;
//   * the products run on the f32 CUDA cores (fused multiply-adds), which
//     keeps f32 inputs exact to f32 rounding; no atomics, so the same
//     inputs give the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // queries per CTA
constexpr int BK = 64;          // keys per tile
static_assert(BQ == BK, "load_tile loads BK rows for q and K/V alike");
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int MAX_D = 256;      // widest d and dv
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;   // element strides over (B, S, H)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, Sq, Skv, H, Hkv, d, dv, causal;
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_out(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// rows [0, n) x columns [0, w) of a (B, S, H, w) operand into dst (ld floats
// a row), zeros past row n_valid
template <typename T>
__device__ __forceinline__ void load_tile(const T* src, long long s_stride,
                                          int n_valid, int w, float* dst,
                                          int ld) {
  for (int i = threadIdx.x; i < BK * w; i += THREADS) {
    const int r = i / w, c = i - r * w;
    dst[r * ld + c] = r < n_valid ? load_f32(src, (long long)r * s_stride + c) : 0.f;
  }
}

// the row-group (16 lanes of one half warp) reductions
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS) flash_kernel(FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = a.d + 1;
  const int ldkv = max(a.d, a.dv) + 1;
  float* q_s = smem;                  // BQ x ldq
  float* kv_s = q_s + BQ * ldq;       // BK x ldkv: K, then V
  float* p_s = kv_s + BK * ldkv;      // BQ x (BK + 1)
  constexpr int LDP = BK + 1;

  const int qb = gridDim.x - 1 - blockIdx.x;   // heaviest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + q0 * a.q_ss;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  load_tile(q, a.q_ss, a.Sq - q0, a.d, q_s, ldq);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's p . v is done with kv_s and p_s
    load_tile(k + k0 * a.k_ss, a.k_ss, a.Skv - k0, a.d, kv_s, ldkv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < a.d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * ldq + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * ldkv + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool ok = k_pos < a.Skv && (!a.causal || q_pos >= k_pos);
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();   // scores done with K
    load_tile(v + k0 * a.v_ss, a.v_ss, a.Skv - k0, a.dv, kv_s, ldkv);
    __syncthreads();

    const int nk = min(BK, a.Skv - k0);
    for (int t = 0; t < nk; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * LDP + t];
      const float* vr = kv_s + t * ldkv;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        if (c < a.dv) {
          const float vv = vr[c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + ty + 16 * i;
    if (q_pos >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    const long long row = (((long long)b * a.Sq + q_pos) * a.H + h) * a.dv;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c < a.dv) store_out(o, row + c, acc[i][j] / den);
    }
  }
}

template <typename T, int CPT>
int launch(const FlashArgs& a, int smem, cudaStream_t s) {
  auto kernel = flash_kernel<T, CPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((a.Sq + BQ - 1) / BQ), (unsigned)(a.B * a.H));
  kernel<<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cpt(const FlashArgs& a, int smem, cudaStream_t s) {
  if (a.dv <= 64) return launch<T, 4>(a, smem, s);
  if (a.dv <= 128) return launch<T, 8>(a, smem, s);
  return launch<T, 16>(a, smem, s);
}

}  // namespace

// dtype: 0 = bf16, 1 = f32.  Pointers are device memory; strides are in
// elements over (B, S, H) of each operand, the head dimension contiguous.
// Returns the cudaError_t of the launch.
extern "C" int sz_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int Sq, int Skv, int H, int Hkv, int d, int dv,
    int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || H % Hkv || d <= 0 || dv <= 0 || d > MAX_D ||
      dv > MAX_D || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.Hkv = Hkv;
  a.d = d;
  a.dv = dv;
  a.causal = causal;
  a.scale = scale;
  const int ldkv = (d > dv ? d : dv) + 1;
  const int smem = 4 * (BQ * (d + 1) + BK * ldkv + BQ * (BK + 1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_cpt<__nv_bfloat16>(a, smem, s);
    case 1: return launch_cpt<float>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
