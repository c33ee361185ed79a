// Paged attention over SplitZip-compressed KV pages for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/splitzip_attention.py:
//   sz_paged_gqa     <- paged_gqa_attention (_paged_gqa_kernel)
//   sz_paged_mla     <- paged_mla_attention (_paged_mla_kernel)
//   sz_decode_pages  <- _decode_page_tile, run over whole pages on its own so
//                       the in-kernel page decode can be held BITWISE against
//                       the plain page decoder (the attention outputs can
//                       only be compared within f32 tolerance)
//
// What the attention kernels compute: a decode worker keeps its KV cache as
// fixed-size pages of SplitZip streams (per page and leaf: sign-mantissa
// bytes, nibble-packed exponent codes, a page-level escape list).  For each
// row b, over its full pages p < min(cache_len[b] / Tp, P) in order, read
// through the page table, the kernel decodes the page's tiles on chip and
// runs the flash online softmax in f32, returning UN-normalized partials
// (acc, m, l); the raw tail page merges outside.  GQA: score q.k over one KV
// head's slice of the K page, context over the same slice of the V page.
// MLA (absorbed form): score q_lat.ckv + q_rope.krope over the latent pages,
// context over ckv.  Causal mask t_pos <= q_pos with queries at
// cache_len - nq + 1 + j.  The raw bf16 K/V never exists in device memory.
//
// One page decoder serves every entry (tile_dense + tile_escapes +
// tile_to_f32): a tile is rows [t0, t0 + nt) x columns [c0, c0 + w) of a
// page whose rows are m elements long.  Dense phase, all threads: nibble
// code -> exponent through a 16-entry table in shared memory, bits =
// sign << (BITS-1) | e << MBITS | mantissa.  Escape phase, one warp: the
// page's slots j < min(count, cap) that fall in the tile overwrite the
// exponent field, in slot order (32 slots a round; a round in which two
// slots hit one element runs slot by slot); padding (pos == page_elems)
// never matches.  Then bits -> f32: bf16 is its bits << 16, fp8 goes
// through cuda_fp8.h.
//
// Bound.  Per row and leaf the kernel must read the compressed bytes of
// its full pages, 1.5 * page_elems + 3 * cap + 4 per page, plus q and the
// f32 partials; the arithmetic is nq * H * Tp * (hd + dv) multiply-adds per
// page, 2 * nq * H * Tp * (hd + dv) operations (MLA: r + rope for the score
// and r for the context).  GQA is bound by the bytes; MLA, whose 40 heads
// share one latent page, by the f32 operations.  The design is the simple one: one CTA per
// (row, KV head) for GQA and per (row, group of up to 8 heads) for MLA, so
// each CTA decodes its page tiles once for all the query heads that share
// them and walks its pages in order with m, l, acc in shared memory (the
// loop replaces the TPU's sequential page axis).  Token sub-tiles keep the
// tiles in shared memory for any page geometry.  At decode batch sizes the
// grid is a few dozen CTAs on 132 SMs, so the kernel runs far from its
// bound; splitting a row's pages across CTAs (flash-decoding) is the next
// step.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr float NEG_INF = -1e30f;

struct DecodeLut {
  unsigned char t[16];  // code -> exponent
};

template <int BITS_, int MBITS_, int EBITS_, int KIND_>
struct Fmt {
  static constexpr int BITS = BITS_;
  static constexpr int MBITS = MBITS_;
  static constexpr int KIND = KIND_;  // 0 bf16, 1 e5m2, 2 e4m3
  static constexpr unsigned CMASK = (1u << BITS_) - 1u;
  static constexpr unsigned MMASK = (1u << MBITS_) - 1u;
  static constexpr unsigned KEEP = CMASK ^ (((1u << EBITS_) - 1u) << MBITS_);
};
using Bf16 = Fmt<16, 7, 8, 0>;
using E5m2 = Fmt<8, 2, 5, 1>;
using E4m3 = Fmt<8, 3, 4, 2>;

// One leaf's page pool: the five streams indexed by physical page id.
struct Pool {
  const uint8_t* sm;       // (n_pages, page_elems)
  const uint8_t* packed;   // (n_pages, page_elems / 2)
  const uint16_t* pos;     // (n_pages, cap), page-relative, pad = page_elems
  const uint8_t* val;      // (n_pages, cap)
  const int32_t* cnt;      // (n_pages,)
  int page_elems, cap, n_pages;
};

// ---------------------------------------------------------------------------
// the shared page decoder
// ---------------------------------------------------------------------------

// Dense phase: container bits of the tile into dst[r * ld + c]; every thread.
template <class F>
__device__ void tile_dense(const Pool& pl, int pid, int m, int t0, int nt,
                           int c0, int w, unsigned* dst, int ld,
                           const unsigned char* s_lut) {
  const uint8_t* sm = pl.sm + (size_t)pid * pl.page_elems;
  const uint8_t* packed = pl.packed + (size_t)pid * (pl.page_elems / 2);
  const int n = nt * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / w, c = i - r * w;
    const int e = (t0 + r) * m + c0 + c;
    const unsigned a = sm[e];
    const unsigned code = (packed[e >> 1] >> (4 * (e & 1))) & 0xFu;
    const unsigned ex = s_lut[code];
    dst[r * ld + c] = (((a >> F::MBITS) & 1u) << (F::BITS - 1) |
                       (ex << F::MBITS) | (a & F::MMASK)) & F::CMASK;
  }
}

// Escape phase: the calling warp applies the page's slots j < min(cnt, cap)
// that fall in the tile, in slot order.
template <class F>
__device__ void tile_escapes(const Pool& pl, int pid, int m, int t0, int nt,
                             int c0, int w, unsigned* dst, int ld) {
  const int lane = threadIdx.x & 31;
  const int n = min(max(pl.cnt[pid], 0), pl.cap);
  const uint16_t* pos = pl.pos + (size_t)pid * pl.cap;
  const uint8_t* val = pl.val + (size_t)pid * pl.cap;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    int at = -1;
    unsigned v = 0;
    if (j < n) {
      const int p = pos[j];
      if (p < pl.page_elems) {
        const int r = p / m - t0, c = p % m - c0;
        if (r >= 0 && r < nt && c >= 0 && c < w) {
          at = r * ld + c;
          v = val[j];
        }
      }
    }
    const unsigned key = at >= 0 ? (unsigned)at : FULL;
    const unsigned peers = __match_any_sync(FULL, key);
    if (__any_sync(FULL, at >= 0 && __popc(peers) > 1)) {
      // two slots of this round hit one element: apply them in slot order
      for (int k = 0; k < 32; ++k) {
        const int a = __shfl_sync(FULL, at, k);
        const unsigned vk = __shfl_sync(FULL, v, k);
        if (lane == 0 && a >= 0)
          dst[a] = ((dst[a] & F::KEEP) | (vk << F::MBITS)) & F::CMASK;
        __syncwarp();
      }
    } else if (at >= 0) {
      dst[at] = ((dst[at] & F::KEEP) | (v << F::MBITS)) & F::CMASK;
    }
    __syncwarp();
  }
}

template <class F>
__device__ __forceinline__ float to_f32(unsigned b) {
  if constexpr (F::KIND == 0) {
    return __uint_as_float(b << 16);
  } else {
    const __half_raw hr = __nv_cvt_fp8_to_halfraw(
        (__nv_fp8_storage_t)b, F::KIND == 1 ? __NV_E5M2 : __NV_E4M3);
    return __half2float(__half(hr));
  }
}

// Bits -> f32 in place; every thread.
template <class F>
__device__ void tile_to_f32(unsigned* t, int nt, int w, int ld) {
  for (int i = threadIdx.x; i < nt * w; i += blockDim.x) {
    const int r = i / w, c = i - r * w;
    const unsigned b = t[r * ld + c];
    reinterpret_cast<float*>(t)[r * ld + c] = to_f32<F>(b);
  }
}

__device__ __forceinline__ void load_lut(unsigned char* s_lut,
                                         const DecodeLut& lut) {
  if (threadIdx.x < 16) s_lut[threadIdx.x] = lut.t[threadIdx.x];
}

// ---------------------------------------------------------------------------
// sz_decode_pages: whole pages -> container bits
// ---------------------------------------------------------------------------

template <class F, typename T>
__global__ void decode_pages_kernel(Pool pl, T* __restrict__ out, int chunk,
                                    int tile_rows, DecodeLut lut) {
  __shared__ unsigned char s_lut[16];
  extern __shared__ __align__(16) unsigned char s_raw[];
  unsigned* tile = reinterpret_cast<unsigned*>(s_raw);
  load_lut(s_lut, lut);
  __syncthreads();
  const int pid = blockIdx.x;
  const int rows = pl.page_elems / chunk;
  const int t0 = blockIdx.y * tile_rows;
  const int nt = min(tile_rows, rows - t0);
  if (nt <= 0) return;
  tile_dense<F>(pl, pid, chunk, t0, nt, 0, chunk, tile, chunk, s_lut);
  __syncthreads();
  if (threadIdx.x < 32) tile_escapes<F>(pl, pid, chunk, t0, nt, 0, chunk, tile, chunk);
  __syncthreads();
  T* dst = out + (size_t)pid * pl.page_elems + (size_t)t0 * chunk;
  for (int i = threadIdx.x; i < nt * chunk; i += blockDim.x) dst[i] = (T)tile[i];
}

// ---------------------------------------------------------------------------
// the paged attention kernel (GQA and absorbed MLA)
// ---------------------------------------------------------------------------

struct AttnArgs {
  const uint16_t* q0;      // bf16 (B, nq, H, w0): GQA q, MLA q_lat
  const uint16_t* q1;      // bf16 (B, nq, H, w1): MLA q_rope (unused for GQA)
  Pool p0, p1;             // GQA: K, V.  MLA: ckv, krope
  const int32_t* table0;   // (B, P) logical -> physical page id
  const int32_t* table1;
  const int32_t* cache_len;  // (B,)
  float* acc;              // (B, nq, H, dv)
  float* m;                // (B, nq, H)
  float* l;
  int nq, H, hpc;          // hpc: query heads per CTA (GQA: H / hkv)
  int w0, w1, m0, m1;      // tile widths; page row lengths (elements/token)
  int P, tp, tile, causal;
  float scale;
  DecodeLut lut;
};

// MLA: score q0.t0 + q1.t1, context over t0.  GQA: score q0.t0, context
// over t1; the CTA's KV head picks the column slice of both pages.
template <class F, bool MLA>
__global__ void paged_attn_kernel(AttnArgs a) {
  __shared__ unsigned char s_lut[16];
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, grp = blockIdx.y;
  const int R = a.nq * a.hpc;               // query rows of this CTA
  const int dv = MLA ? a.w0 : a.w1;         // context width
  const int ld0 = a.w0 + 1, ld1 = a.w1 + 1;  // padded tile rows: no bank clash
  float* q0_s = smem;                       // R * w0
  float* q1_s = q0_s + R * a.w0;            // R * w1 (MLA only)
  float* t0_s = q1_s + (MLA ? R * a.w1 : 0);  // tile * ld0
  float* t1_s = t0_s + a.tile * ld0;        // tile * ld1
  float* p_s = t1_s + a.tile * ld1;         // R * tile
  float* acc_s = p_s + R * a.tile;          // R * dv
  float* m_s = acc_s + R * dv;              // R
  float* l_s = m_s + R;                     // R
  float* c_s = l_s + R;                     // R
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const int col0 = MLA ? 0 : grp * a.w0, col1 = MLA ? 0 : grp * a.w1;
  load_lut(s_lut, a.lut);

  // queries: row r = qi * hpc + hi is head grp * hpc + hi of query qi
  for (int i = tid; i < R * a.w0; i += nthr) {
    const int r = i / a.w0, d = i - r * a.w0;
    const int qi = r / a.hpc, head = grp * a.hpc + r % a.hpc;
    q0_s[i] = __uint_as_float(
        (unsigned)a.q0[(((size_t)b * a.nq + qi) * a.H + head) * a.w0 + d] << 16);
  }
  if (MLA) {
    for (int i = tid; i < R * a.w1; i += nthr) {
      const int r = i / a.w1, d = i - r * a.w1;
      const int qi = r / a.hpc, head = grp * a.hpc + r % a.hpc;
      q1_s[i] = __uint_as_float(
          (unsigned)a.q1[(((size_t)b * a.nq + qi) * a.H + head) * a.w1 + d] << 16);
    }
  }
  for (int i = tid; i < R * dv; i += nthr) acc_s[i] = 0.f;
  for (int r = tid; r < R; r += nthr) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int clen = a.cache_len[b];
  const int n_full = min(clen / a.tp, a.P);
  for (int p = 0; p < n_full; ++p) {
    const int pid0 = min(max(a.table0[(size_t)b * a.P + p], 0), a.p0.n_pages - 1);
    const int pid1 = min(max(a.table1[(size_t)b * a.P + p], 0), a.p1.n_pages - 1);
    for (int t0 = 0; t0 < a.tp; t0 += a.tile) {
      const int nt = min(a.tile, a.tp - t0);
      unsigned* u0 = reinterpret_cast<unsigned*>(t0_s);
      unsigned* u1 = reinterpret_cast<unsigned*>(t1_s);
      tile_dense<F>(a.p0, pid0, a.m0, t0, nt, col0, a.w0, u0, ld0, s_lut);
      tile_dense<F>(a.p1, pid1, a.m1, t0, nt, col1, a.w1, u1, ld1, s_lut);
      __syncthreads();
      if (warp == 0) tile_escapes<F>(a.p0, pid0, a.m0, t0, nt, col0, a.w0, u0, ld0);
      if (warp == 1) tile_escapes<F>(a.p1, pid1, a.m1, t0, nt, col1, a.w1, u1, ld1);
      __syncthreads();
      tile_to_f32<F>(u0, nt, a.w0, ld0);
      tile_to_f32<F>(u1, nt, a.w1, ld1);
      __syncthreads();

      // scores (scaled, masked) into p_s
      for (int i = tid; i < R * nt; i += nthr) {
        const int r = i / nt, t = i - r * nt;
        const float* qr = q0_s + r * a.w0;
        const float* kt = t0_s + t * ld0;
        float s0 = 0.f;
        for (int d = 0; d < a.w0; ++d) s0 = fmaf(qr[d], kt[d], s0);
        if (MLA) {
          const float* q1r = q1_s + r * a.w1;
          const float* k1 = t1_s + t * ld1;
          float s1 = 0.f;
          for (int d = 0; d < a.w1; ++d) s1 = fmaf(q1r[d], k1[d], s1);
          s0 += s1;
        }
        float s = s0 * a.scale;
        if (a.causal) {
          const int q_pos = clen - (a.nq - 1) + r / a.hpc;
          const int t_pos = p * a.tp + t0 + t;
          if (t_pos > q_pos) s = NEG_INF;
        }
        p_s[r * a.tile + t] = s;
      }
      __syncthreads();

      // online softmax: one warp per query row
      for (int r = warp; r < R; r += nwarps) {
        float mx = -3.0e38f;
        for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, p_s[r * a.tile + t]);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < nt; t += 32) {
          const float e = expf(p_s[r * a.tile + t] - m_new);
          p_s[r * a.tile + t] = e;
          sum += e;
        }
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          c_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // context: acc = acc * corr + p @ v
      const float* vt = MLA ? t0_s : t1_s;
      const int ldv = MLA ? ld0 : ld1;
      for (int i = tid; i < R * dv; i += nthr) {
        const int r = i / dv, d = i - r * dv;
        const float* pr = p_s + r * a.tile;
        float pv = 0.f;
        for (int t = 0; t < nt; ++t) pv = fmaf(pr[t], vt[t * ldv + d], pv);
        acc_s[i] = acc_s[i] * c_s[r] + pv;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < R * dv; i += nthr) {
    const int r = i / dv, d = i - r * dv;
    const int qi = r / a.hpc, head = grp * a.hpc + r % a.hpc;
    a.acc[(((size_t)b * a.nq + qi) * a.H + head) * dv + d] = acc_s[i];
  }
  for (int r = tid; r < R; r += nthr) {
    const int qi = r / a.hpc, head = grp * a.hpc + r % a.hpc;
    a.m[((size_t)b * a.nq + qi) * a.H + head] = m_s[r];
    a.l[((size_t)b * a.nq + qi) * a.H + head] = l_s[r];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

Pool make_pool(const void* sm, const void* packed, const void* pos,
               const void* val, const void* cnt, int page_elems, int cap,
               int n_pages) {
  Pool p;
  p.sm = static_cast<const uint8_t*>(sm);
  p.packed = static_cast<const uint8_t*>(packed);
  p.pos = static_cast<const uint16_t*>(pos);
  p.val = static_cast<const uint8_t*>(val);
  p.cnt = static_cast<const int32_t*>(cnt);
  p.page_elems = page_elems;
  p.cap = cap;
  p.n_pages = n_pages;
  return p;
}

template <typename K>
int launch_with_smem(K kernel, dim3 grid, dim3 block, int smem, cudaStream_t s,
                     const AttnArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, block, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool MLA>
int launch_attn(int fmt, const AttnArgs& a, int B, int groups, int threads,
                int smem, const void* lut, void* stream) {
  if (B <= 0 || groups <= 0) return 0;
  if (threads < 64 || threads % 32 || a.tile < 1 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  AttnArgs args = a;
  memcpy(args.lut.t, lut, sizeof(args.lut.t));
  const dim3 grid((unsigned)B, (unsigned)groups), block((unsigned)threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_with_smem(paged_attn_kernel<Bf16, MLA>, grid, block, smem, s, args);
    case 1: return launch_with_smem(paged_attn_kernel<E5m2, MLA>, grid, block, smem, s, args);
    case 2: return launch_with_smem(paged_attn_kernel<E4m3, MLA>, grid, block, smem, s, args);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fmt: 0 = bf16, 1 = fp8_e5m2, 2 = fp8_e4m3.  Every pointer is device memory
// except ``lut`` (16 host bytes: code -> exponent).  Each entry returns the
// cudaError_t of its launch.

extern "C" int sz_decode_pages(int fmt, const void* sm, const void* packed,
                               const void* pos, const void* val,
                               const void* cnt, void* out, int n_pages,
                               int page_elems, int cap, int chunk,
                               int tile_rows, const void* lut, void* stream) {
  if (n_pages <= 0) return 0;
  if (chunk <= 0 || page_elems % chunk || tile_rows < 1 ||
      tile_rows * chunk * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  DecodeLut table;
  memcpy(table.t, lut, sizeof(table.t));
  const Pool pl = make_pool(sm, packed, pos, val, cnt, page_elems, cap, n_pages);
  const int rows = page_elems / chunk;
  const dim3 grid((unsigned)n_pages, (unsigned)((rows + tile_rows - 1) / tile_rows));
  const dim3 block(256);
  const int smem = tile_rows * chunk * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0:
      decode_pages_kernel<Bf16, uint16_t><<<grid, block, smem, s>>>(
          pl, static_cast<uint16_t*>(out), chunk, tile_rows, table);
      break;
    case 1:
      decode_pages_kernel<E5m2, uint8_t><<<grid, block, smem, s>>>(
          pl, static_cast<uint8_t*>(out), chunk, tile_rows, table);
      break;
    case 2:
      decode_pages_kernel<E4m3, uint8_t><<<grid, block, smem, s>>>(
          pl, static_cast<uint8_t*>(out), chunk, tile_rows, table);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int sz_paged_gqa(
    int fmt, const void* q, const void* k_sm, const void* k_packed,
    const void* k_pos, const void* k_val, const void* k_cnt, const void* v_sm,
    const void* v_packed, const void* v_pos, const void* v_val,
    const void* v_cnt, const void* table_k, const void* table_v,
    const void* cache_len, void* acc, void* m, void* l, int B, int nq, int H,
    int hkv, int hd, int dv, int P, int tokens_per_page, int pe_k, int cap_k,
    int n_pages_k, int pe_v, int cap_v, int n_pages_v, int causal,
    float scale, int tile, int threads, int smem, const void* lut,
    void* stream) {
  if (hkv <= 0 || H % hkv) return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q0 = static_cast<const uint16_t*>(q);
  a.q1 = nullptr;
  a.p0 = make_pool(k_sm, k_packed, k_pos, k_val, k_cnt, pe_k, cap_k, n_pages_k);
  a.p1 = make_pool(v_sm, v_packed, v_pos, v_val, v_cnt, pe_v, cap_v, n_pages_v);
  a.table0 = static_cast<const int32_t*>(table_k);
  a.table1 = static_cast<const int32_t*>(table_v);
  a.cache_len = static_cast<const int32_t*>(cache_len);
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.nq = nq;
  a.H = H;
  a.hpc = H / hkv;
  a.w0 = hd;
  a.w1 = dv;
  a.m0 = hkv * hd;
  a.m1 = hkv * dv;
  a.P = P;
  a.tp = tokens_per_page;
  a.tile = tile;
  a.causal = causal;
  a.scale = scale;
  return launch_attn<false>(fmt, a, B, hkv, threads, smem, lut, stream);
}

extern "C" int sz_paged_mla(
    int fmt, const void* q_lat, const void* q_rope, const void* c_sm,
    const void* c_packed, const void* c_pos, const void* c_val,
    const void* c_cnt, const void* r_sm, const void* r_packed,
    const void* r_pos, const void* r_val, const void* r_cnt,
    const void* table_c, const void* table_r, const void* cache_len,
    void* acc, void* m, void* l, int B, int nq, int H, int heads_per_cta,
    int kv_rank, int rope_dim, int P, int tokens_per_page, int pe_c,
    int cap_c, int n_pages_c, int pe_r, int cap_r, int n_pages_r, int causal,
    float scale, int tile, int threads, int smem, const void* lut,
    void* stream) {
  if (heads_per_cta <= 0 || H % heads_per_cta) return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.q0 = static_cast<const uint16_t*>(q_lat);
  a.q1 = static_cast<const uint16_t*>(q_rope);
  a.p0 = make_pool(c_sm, c_packed, c_pos, c_val, c_cnt, pe_c, cap_c, n_pages_c);
  a.p1 = make_pool(r_sm, r_packed, r_pos, r_val, r_cnt, pe_r, cap_r, n_pages_r);
  a.table0 = static_cast<const int32_t*>(table_c);
  a.table1 = static_cast<const int32_t*>(table_r);
  a.cache_len = static_cast<const int32_t*>(cache_len);
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.nq = nq;
  a.H = H;
  a.hpc = heads_per_cta;
  a.w0 = kv_rank;
  a.w1 = rope_dim;
  a.m0 = kv_rank;
  a.m1 = rope_dim;
  a.P = P;
  a.tp = tokens_per_page;
  a.tile = tile;
  a.causal = causal;
  a.scale = scale;
  return launch_attn<true>(fmt, a, B, H / heads_per_cta, threads, smem, lut,
                           stream);
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
