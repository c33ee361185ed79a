// Prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention.py:
//   sz_flash_attention_tc  <- flash_attention (_kernel), bf16 operands whose
//                             d and dv are multiples of 16 (every served
//                             prefill: d 64, d 96 / dv 64, d 128, and
//                             recurrentgemma's windowed d 256)
//   sz_flash_attention     <- the same, f32 operands and any other bf16 width
//
// What it computes: causal or non-causal multi-head attention with grouped
// KV heads (query head h reads KV head h / (H / Hkv)) and a value width that
// may differ from the query/key width (MLA prefill: d 96, dv 64), and an
// optional sliding window (recurrentgemma's local attention).  q (B, Sq,
// H, d), k (B, Skv, Hkv, d), v (B, Skv, Hkv, dv), bf16 or f32, with any
// strides over (B, S, H) and unit stride over the head dimension; out (B,
// Sq, H, dv) contiguous, in the input type.  Arithmetic as the TPU kernel:
// q, k, v in f32, s = (q . k) * scale, masked scores -1e30 (k_pos >= Skv,
// k_pos > q_pos when causal, and q_pos - k_pos >= window when window > 0,
// the JAX models' chunked_attention mask; positions from 0), an online softmax
// over KV tiles with f32 m, l and acc, p kept in f32 for p . v, and
// out = acc / max(l, 1e-30) rounded once to the output type.
//
// Bound.  The function must read q, k and v once and write out once,
// 2 * (B Sq H d + B Skv Hkv (d + dv) + B Sq H dv) bytes in bf16, and do
// 2 B H Sq Skv (d + dv) operations (half of that when causal; with a window,
// 2 B H (d + dv) times the (query, key) pairs inside it).  At the
// served prefill shapes (Sq = Skv = 1000 to 2048) the operations outweigh
// the bytes by two orders of magnitude: the kernel is bound by arithmetic,
// and only the tensor cores (989 TFLOP/s bf16, against 67 TFLOP/s on the
// f32 CUDA cores) come near that bound.
//
// sz_flash_attention_tc, the tensor-core kernel (wgmma):
//   * one CTA of one warpgroup (128 threads) per (64-query block, batch *
//     head), the heaviest causal blocks launched first; it loops over
//     64-key tiles up to the causal diagonal and never loads the tiles
//     above it, nor, with a window, the tiles below the first key any of
//     its rows sees (max(0, q0 - window + 1), rounded down to a tile);
//     only the diagonal tile, the ragged last tile and the tiles the
//     window's lower edge crosses are masked.  A row that sees no key of a
//     masked tile scores p = exp(0) = 1 there (its running max is still
//     -1e30); the first key it does see rescales l and acc by
//     exp(-1e30 - m) = 0 exactly, so such a tile adds nothing;
//   * S = Q K^T with wgmma.mma_async m64n64k16, both operands bf16 from
//     shared memory, f32 accumulators in registers.  Products of two bf16
//     values are exact in f32, so only the order of the sums differs from
//     the plain version;
//   * the online softmax runs on the accumulator fragment: a thread holds
//     two rows (g and g + 8 of its warp's 16) x 16 keys, a row lives in a
//     quad of lanes, so each row reduction is two shuffles;
//   * O += P V with P from registers as the A operand (the S fragment is
//     the A fragment of the next product) and V from shared memory as a
//     transposed (MN-major) B operand.  p stays f32 as the TPU kernel
//     keeps it: p = p_hi + p_lo with p_hi = bf16(p), p_lo = bf16(p - p_hi),
//     two wgmma into the same accumulator.  That carries about 16 bits of
//     p (relative error <= 2^-17), so the f32 result agrees with the plain
//     version to about 1e-6 before the one rounding to bf16; it costs 1.5x
//     the tensor-core work of rounding p once;
//   * operands arrive by TMA (cp.async.bulk.tensor, 4-d tensor maps over
//     (head dim, head, sequence, batch) with the caller's strides, 64 x 64
//     boxes, 128-byte swizzle, zeros past the sequence and head-dim ends),
//     every operand by the same route: q once, K and V tiles into a ring of
//     two stages with one mbarrier each, the next tile in flight while the
//     current one is multiplied.  Ring stage and mbarrier phase count loop
//     iterations from the CTA's first tile, not absolute tile indices.  The MLA v, a head slice of kv (row stride
//     256 bytes, offset 128 bytes), is one such tensor map; the wrapper
//     copies an operand only if its base or strides are not 16-byte
//     multiples (or a stride is 0), which no served prefill has;
//   * shared memory holds bf16 in the swizzled layout the wgmma
//     descriptors name: 64-row x 128-byte blocks (64 columns of d or dv),
//     1024-byte aligned; a k-step of 16 columns moves the descriptor's
//     start 32 bytes inside a block.  At d = dv = 128: 80 KB a CTA; at
//     d = dv = 256: 161 KB, and 241 registers a thread for the 64 x 256
//     f32 accumulator;
//   * cuTensorMapEncodeTiled comes from the runtime's driver entry point,
//     so the library needs no link against libcuda.
//
// sz_flash_attention, the CUDA-core kernel (f32 operands, and bf16 whose d
// or dv is not a multiple of 16):
//   * one CTA of 256 threads per (64-query block, batch * head), the
//     heaviest causal blocks launched first; the CTA loops over 64-key
//     tiles from the first its rows see through the window up to the
//     causal diagonal and never visits the others (the loop replaces the
//     TPU's sequential KV grid axis);
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
//     keeps f32 inputs exact to f32 rounding.
// Neither kernel uses atomics: the same inputs give the same bits on every
// run.
#include <cuda.h>          // CUtensorMap and its enums (no libcuda link)
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
  int B, Sq, Skv, H, Hkv, d, dv, causal, window;  // window 0: none
  float scale;
};

// The first key tile a 64-query block starting at q0 needs: the tile of
// max(0, q0 - window + 1), the first key its first row sees (tile 0
// without a window).
__device__ __forceinline__ int first_tile(int q0, int window, int bk) {
  return window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / bk : 0;
}

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
  for (int kt = first_tile(q0, a.window, BK); kt < n_tiles; ++kt) {
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
        const bool ok = k_pos < a.Skv && (!a.causal || q_pos >= k_pos) &&
                        (a.window <= 0 || q_pos - k_pos < a.window);
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
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || H % Hkv || d <= 0 || dv <= 0 || d > MAX_D ||
      dv > MAX_D || (long long)B * H > 65535 || window < 0)
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
  a.window = window;
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

// ---------------------------------------------------------------------------
// sz_flash_attention_tc: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;             // queries per CTA: the warpgroup's wgmma M
constexpr int BK = 64;             // keys per tile: the score product's N
constexpr int THREADS = 128;       // one warpgroup
constexpr int STAGES = 2;          // K/V ring
constexpr int ATOM = 64;           // bf16 columns in one 128-byte swizzle row
constexpr int ATOM_BYTES = 64 * 128;  // one 64-row block of 128-byte rows
constexpr int SMEM_ALIGN = 1024;   // the 128-byte swizzle repeats every 1 KB

struct Args {
  void* o;
  int B, Sq, Skv, H, Hkv, d, dv, causal, window;  // window 0: none
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase `parity` has completed.  A copy that never
// lands traps (the launch then fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 24)) __trap();
  }
}

// One 64 x 64 box of a 4-d tensor map (coordinates innermost first) into
// shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// K and V tile rows [row, row + 64) of KV head hk into one ring stage: ka
// blocks of K, then nv blocks of V; one thread issues every copy.
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t dst, uint32_t bar, int ka, int nv,
                                        int hk, int row, int b) {
  mbar_expect_tx(bar, (ka + nv) * ATOM_BYTES);
  for (int j = 0; j < ka; ++j) tma_load(dst + j * ATOM_BYTES, tk, bar, j * ATOM, hk, row, b);
  for (int j = 0; j < nv; ++j)
    tma_load(dst + (ka + j) * ATOM_BYTES, tv, bar, j * ATOM, hk, row, b);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes of a wgmma
// operand across the fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16, shared, K-major) . B (16 x 64,
// bf16, shared, K-major: 64 rows of 16 keys' columns).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16, registers) . B (16 x 64, bf16,
// shared, MN-major: 16 rows of 64 columns).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Shared memory: the 1 KB alignment slack, q (ka blocks), STAGES x (K: ka
// blocks, V: nv blocks), then STAGES + 1 mbarriers.
__host__ __device__ inline int smem_bytes(int ka, int nv) {
  return SMEM_ALIGN + (ka + STAGES * (ka + nv)) * ATOM_BYTES + 8 * (STAGES + 1);
}

// WINDOW is a template flag, not only the runtime a.window: the kernels
// without a window compile to the code they had before windows existed
// (the runtime test alone cost them up to 7 registers a thread).
template <int NV, bool WINDOW>
__global__ void __launch_bounds__(THREADS)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~(SMEM_ALIGN - 1u);
  const int ka = (a.d + ATOM - 1) / ATOM;
  const uint32_t q_s = base;
  const uint32_t ring = q_s + ka * ATOM_BYTES;
  const uint32_t stage_bytes = (ka + NV) * ATOM_BYTES;
  const uint32_t bar_q = ring + STAGES * stage_bytes;  // then one a stage

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qb * BQ;
  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  // tiles [kt0, kt0 + n_tiles); iteration i holds tile kt0 + i in ring
  // stage i % STAGES, whose mbarrier completes phase (i / STAGES) & 1
  const int kt0 = WINDOW ? first_tile(q0, a.window, BK) : 0;
  const int n_tiles = (kv_end + BK - 1) / BK - kt0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0) {
    mbar_expect_tx(bar_q, ka * ATOM_BYTES);
    for (int j = 0; j < ka; ++j)
      tma_load(q_s + j * ATOM_BYTES, &tq, bar_q, j * ATOM, h, q0, b);
    for (int t = 0; t < min(STAGES, n_tiles); ++t)
      load_kv(&tk, &tv, ring + t * stage_bytes, bar_q + 8 * (1 + t), ka, NV, hk,
              (kt0 + t) * BK, b);
  }

  // this thread's rows of the block and the first of its column pairs
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  float o[NV][32];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int ksteps = a.d / 16;

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % STAGES;
    const uint32_t k_s = ring + st * stage_bytes, v_s = k_s + ka * ATOM_BYTES;
    mbar_wait(bar_q + 8 * (1 + st), (kt / STAGES) & 1);

    // S = Q K^T: k-step kk reads columns 16 kk.. of block kk / 4
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      const uint32_t off = (kk >> 2) * ATOM_BYTES + (kk & 3) * 32;
      wgmma_ss(s, desc_sw128(q_s + off, 16, 1024), desc_sw128(k_s + off, 16, 1024),
               kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // online softmax on the fragment: s[4j + e] is row (e < 2 ? r0 : r1),
    // key k0 + 8 j + cq + (e & 1)
    const int k0 = (kt0 + kt) * BK;
    const bool edge = k0 + BK > a.Skv || (a.causal && k0 + BK - 1 > q0) ||
                      (WINDOW && q0 + BQ - 1 - k0 >= a.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * a.scale;
        if (edge) {
          const int col = k0 + 8 * j + cq + (e & 1), row = e < 2 ? r0 : r1;
          if (col >= a.Skv || (a.causal && col > row) ||
              (WINDOW && row - col >= a.window))
            x = NEG_INF;
        }
        s[4 * j + e] = x;
      }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = expf(s[4 * j] - mn0);
      s[4 * j + 1] = expf(s[4 * j + 1] - mn0);
      s[4 * j + 2] = expf(s[4 * j + 2] - mn1);
      s[4 * j + 3] = expf(s[4 * j + 3] - mn1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      sum0 += __shfl_xor_sync(FULL, sum0, sh);
      sum1 += __shfl_xor_sync(FULL, sum1, sh);
    }
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= corr0;
        o[c][4 * j + 1] *= corr0;
        o[c][4 * j + 2] *= corr1;
        o[c][4 * j + 3] *= corr1;
      }

    // p as the A fragment of 16-key k-step kk: register r holds the pair
    // s[8 kk + 2 r], s[8 kk + 2 r + 1]; hi = bf16(p), lo = bf16(p - hi)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
        const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
        ph[kk][r] = pack_bf16(hx, hy);
        pl[kk][r] = pack_bf16(__float2bfloat16_rn(x - __bfloat162float(hx)),
                              __float2bfloat16_rn(y - __bfloat162float(hy)));
      }

    // O += P V: V block c (64 columns of dv), k-step kk = keys 16 kk..
#pragma unroll
    for (int c = 0; c < NV; ++c) fence_regs(o[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    wg_fence();
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vd =
            desc_sw128(v_s + c * ATOM_BYTES + kk * 16 * 128, 1024, 1024);
        wgmma_rs_tb(o[c], ph[kk], vd);
        wgmma_rs_tb(o[c], pl[kk], vd);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < NV; ++c) fence_regs(o[c]);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && kt + STAGES < n_tiles)
      load_kv(&tk, &tv, k_s, bar_q + 8 * (1 + st), ka, NV, hk,
              (kt0 + kt + STAGES) * BK, b);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * 64 + 8 * j + cq;
      if (col >= a.dv) continue;
      if (r0 < a.Sq) {
        const long long i = (((long long)b * a.Sq + r0) * a.H + h) * a.dv + col;
        *reinterpret_cast<uint32_t*>(out + i) =
            pack_bf16(__float2bfloat16_rn(o[c][4 * j] / den0),
                      __float2bfloat16_rn(o[c][4 * j + 1] / den0));
      }
      if (r1 < a.Sq) {
        const long long i = (((long long)b * a.Sq + r1) * a.H + h) * a.dv + col;
        *reinterpret_cast<uint32_t*>(out + i) =
            pack_bf16(__float2bfloat16_rn(o[c][4 * j + 2] / den1),
                      __float2bfloat16_rn(o[c][4 * j + 3] / den1));
      }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (no libcuda at link time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, width) bf16 operand as a 4-d tensor map over (width,
// heads, S, B), element strides sh, ss, sb; 64-column x 64-row boxes.
int make_map(CUtensorMap* map, const void* ptr, int width, int heads, int S,
             int B, long long sh, long long ss, long long sb) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {ATOM, 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NV, bool WINDOW>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Args& a, cudaStream_t s) {
  auto kernel = flash_tc_kernel<NV, WINDOW>;
  static bool opted_in = false;  // the widest d's shared memory, set once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(MAX_D / ATOM, NV));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int smem = smem_bytes((a.d + ATOM - 1) / ATOM, NV);
  const dim3 grid((unsigned)((a.Sq + BQ - 1) / BQ), (unsigned)(a.B * a.H));
  kernel<<<grid, THREADS, smem, s>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// bf16 only; d and dv multiples of 16 up to 256; pointers 16-byte aligned
// and strides (elements over (B, S, H) of each operand) multiples of 8 and
// not 0, the head dimension contiguous.  Returns the cudaError_t of the
// tensor-map encoding or of the launch.
extern "C" int sz_flash_attention_tc(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int B,
    int Sq, int Skv, int H, int Hkv, int d, int dv, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || H % Hkv || d <= 0 || dv <= 0 || d % 16 ||
      dv % 16 || d > MAX_D || dv > MAX_D || (long long)B * H > 65535 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  for (long long st : strides)
    if (st <= 0 || st % 8) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = tc::make_map(&tq, q, d, H, Sq, B, q_sh, q_ss, q_sb);
  if (!err) err = tc::make_map(&tk, k, d, Hkv, Skv, B, k_sh, k_ss, k_sb);
  if (!err) err = tc::make_map(&tv, v, dv, Hkv, Skv, B, v_sh, v_ss, v_sb);
  if (err) return err;
  tc::Args a;
  a.o = out;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.Hkv = Hkv;
  a.d = d;
  a.dv = dv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = window > 0;
  switch ((dv + tc::ATOM - 1) / tc::ATOM) {
    case 1: return w ? tc::launch<1, true>(tq, tk, tv, a, s) : tc::launch<1, false>(tq, tk, tv, a, s);
    case 2: return w ? tc::launch<2, true>(tq, tk, tv, a, s) : tc::launch<2, false>(tq, tk, tv, a, s);
    case 3: return w ? tc::launch<3, true>(tq, tk, tv, a, s) : tc::launch<3, false>(tq, tk, tv, a, s);
    default: return w ? tc::launch<4, true>(tq, tk, tv, a, s) : tc::launch<4, false>(tq, tk, tv, a, s);
  }
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
