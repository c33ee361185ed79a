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
// One page decoder serves every entry: a tile is rows [t0, t0 + nt) x
// columns [c0, c0 + w) of a page whose rows are m elements long.  Dense
// phase, all threads: nibble code -> exponent through a 16-entry table,
// bits = sign << (BITS-1) | e << MBITS | mantissa.  Escape phase, one warp
// (tile_escapes): the page's slots j < min(count, cap) that fall in the
// tile overwrite the exponent field, in slot order (32 slots a round; a
// round in which two slots hit one element runs slot by slot); padding
// (pos == page_elems) never matches.  Then bits -> f32: bf16 is its bits
// << 16, fp8 goes through cuda_fp8.h.
//
// Bound.  Per row and leaf the kernel must read the compressed bytes of
// its full pages, 1.5 * page_elems + 3 * cap + 4 per page, plus q and the
// f32 partials; the arithmetic is nq * H * Tp * (hd + dv) multiply-adds per
// page, 2 * nq * H * Tp * (hd + dv) operations (MLA: r + rope for the score
// and r for the context).  GQA is bound by the bytes; MLA, whose 40 heads
// share one latent page, by the f32 operations.
//
// GQA (sz_paged_gqa), split across the card (flash-decoding): a decode
// batch has a few dozen (row, KV head) pairs against 132 SMs, so each
// row's full pages are cut into n_split contiguous ranges, split s taking
// pages [s P / n, (s + 1) P / n) of the page table's P (capped at the
// row's own count; the wrapper picks n to cover the SMs twice).  One CTA
// per (row, KV head, split) runs the page-ordered online softmax over its
// range and writes un-normalized partials; a split with no visible token
// writes m = -1e30, l = 0, acc = 0.  A second kernel merges the splits in
// order (m the maximum, l and acc weighted by exp(m_s - m)): the unsplit
// partials.  Inside a CTA, per token tile: each thread cp.asyncs 16 bytes
// of sign-mantissa and 8 of codes a chunk of 16 elements for the NEXT tile
// while it decodes its own chunks of this one (no barrier between its copy
// and its decode), one barrier, the escape warps, one barrier, then each
// warp scores, softmaxes and accumulates its own query rows (lanes over
// tokens for the scores, over value columns for the context) with no
// barrier; the tiles hold container bits (rows padded 4 bytes so a warp
// reading one column of 32 rows hits 32 banks), converted as they are read.
//
// MLA (sz_paged_mla), unsplit, as first ported: one CTA per (row, group of
// up to 8 heads) decodes its page tiles once for all the query heads that
// share them and walks its pages in order with m, l, acc in shared memory
// (the loop replaces the TPU's sequential page axis); token sub-tiles keep
// the tiles in shared memory for any page geometry.  At decode batch
// sizes its grid is a few dozen CTAs on 132 SMs, so it runs far from its
// bound; tensor cores over the latent and the split are its next step.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

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
// that fall in the tile, in slot order.  dst holds container bits in T
// (32-bit for the unsplit kernel and sz_decode_pages, the container's own
// width for the GQA split kernel).
template <class F, typename T>
__device__ void tile_escapes(const Pool& pl, int pid, int m, int t0, int nt,
                             int c0, int w, T* dst, int ld) {
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
// the paged MLA kernel (absorbed form)
// ---------------------------------------------------------------------------

struct AttnArgs {
  const uint16_t* q0;      // bf16 (B, nq, H, w0): q_lat
  const uint16_t* q1;      // bf16 (B, nq, H, w1): q_rope
  Pool p0, p1;             // ckv, krope
  const int32_t* table0;   // (B, P) logical -> physical page id
  const int32_t* table1;
  const int32_t* cache_len;  // (B,)
  float* acc;              // (B, nq, H, dv)
  float* m;                // (B, nq, H)
  float* l;
  int nq, H, hpc;          // hpc: query heads per CTA
  int w0, w1, m0, m1;      // tile widths; page row lengths (elements/token)
  int P, tp, tile, causal;
  float scale;
  DecodeLut lut;
};

// One CTA per (row, group of hpc heads) walks the row's full pages in
// order: score q0.t0 + q1.t1, context over t0.
template <class F>
__global__ void paged_mla_kernel(AttnArgs a) {
  __shared__ unsigned char s_lut[16];
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, grp = blockIdx.y;
  const int R = a.nq * a.hpc;               // query rows of this CTA
  const int dv = a.w0;                      // context width: the latent
  const int ld0 = a.w0 + 1, ld1 = a.w1 + 1;  // padded tile rows: no bank clash
  float* q0_s = smem;                       // R * w0
  float* q1_s = q0_s + R * a.w0;            // R * w1
  float* t0_s = q1_s + R * a.w1;            // tile * ld0
  float* t1_s = t0_s + a.tile * ld0;        // tile * ld1
  float* p_s = t1_s + a.tile * ld1;         // R * tile
  float* acc_s = p_s + R * a.tile;          // R * dv
  float* m_s = acc_s + R * dv;              // R
  float* l_s = m_s + R;                     // R
  float* c_s = l_s + R;                     // R
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  load_lut(s_lut, a.lut);

  // queries: row r = qi * hpc + hi is head grp * hpc + hi of query qi
  for (int i = tid; i < R * a.w0; i += nthr) {
    const int r = i / a.w0, d = i - r * a.w0;
    const int qi = r / a.hpc, head = grp * a.hpc + r % a.hpc;
    q0_s[i] = __uint_as_float(
        (unsigned)a.q0[(((size_t)b * a.nq + qi) * a.H + head) * a.w0 + d] << 16);
  }
  for (int i = tid; i < R * a.w1; i += nthr) {
    const int r = i / a.w1, d = i - r * a.w1;
    const int qi = r / a.hpc, head = grp * a.hpc + r % a.hpc;
    q1_s[i] = __uint_as_float(
        (unsigned)a.q1[(((size_t)b * a.nq + qi) * a.H + head) * a.w1 + d] << 16);
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
      tile_dense<F>(a.p0, pid0, a.m0, t0, nt, 0, a.w0, u0, ld0, s_lut);
      tile_dense<F>(a.p1, pid1, a.m1, t0, nt, 0, a.w1, u1, ld1, s_lut);
      __syncthreads();
      if (warp == 0) tile_escapes<F>(a.p0, pid0, a.m0, t0, nt, 0, a.w0, u0, ld0);
      if (warp == 1) tile_escapes<F>(a.p1, pid1, a.m1, t0, nt, 0, a.w1, u1, ld1);
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
        const float* q1r = q1_s + r * a.w1;
        const float* k1 = t1_s + t * ld1;
        float s1 = 0.f;
        for (int d = 0; d < a.w1; ++d) s1 = fmaf(q1r[d], k1[d], s1);
        s0 += s1;
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
      const float* vt = t0_s;
      const int ldv = ld0;
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
// the GQA split kernel (flash-decoding) and its merge
// ---------------------------------------------------------------------------

constexpr int GQA_THREADS = 128;
constexpr int GQA_WARPS = GQA_THREADS / 32;
constexpr int VEC = 16;        // elements a copy: 16 B of sign-mantissa, 8 B of codes
constexpr int MERGE_THREADS = 256;

struct GqaArgs {
  const uint16_t* q;       // bf16 (B, nq, H, hd)
  Pool pk, pv;             // K and V pools
  const int32_t* table_k;  // (B, P)
  const int32_t* table_v;
  const int32_t* cache_len;  // (B,)
  float* acc;              // (n_split, B, nq, H, dv)
  float* m;                // (n_split, B, nq, H)
  float* l;
  int B, nq, H, G, hd, dv, mk, mv;  // mk, mv: page row lengths (Hkv hd, Hkv dv)
  int P, tp, tile, causal, n_split;
  float scale;
  DecodeLut lut;
};

// Shared memory of one CTA: two raw stages (a tile's sign-mantissa copies,
// then its packed-code copies), two container-bit stages (K tile, V tile;
// rows padded by 4 bytes so lanes reading one column of 32 token rows hit
// 32 banks), then q (f32), p, acc, m, l for the CTA's query rows.
struct GqaSmem {
  int codes;     // offset of the packed codes in a raw stage
  int raw;       // bytes of a raw stage
  int ldk, ldv;  // bit-tile rows, in 32-bit words
  int bits;      // bytes of a bits stage
  int total;
};

__host__ __device__ inline GqaSmem gqa_smem(int tile, int rows, int hd, int dv,
                                            int sz) {
  GqaSmem g;
  const int chunks = tile * (hd + dv) / VEC;
  g.codes = chunks * 16;
  g.raw = (chunks * 24 + 15) / 16 * 16;
  g.ldk = (hd * sz + 4) / 4;
  g.ldv = (dv * sz + 4) / 4;
  g.bits = tile * (g.ldk + g.ldv) * 4;
  g.total = 2 * g.raw + 2 * g.bits + 4 * rows * (hd + tile + dv + 2);
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ int page_id(const int32_t* table, int P, int b, int p,
                                       int n_pages) {
  return min(max(table[(size_t)b * P + p], 0), n_pages - 1);
}

// Chunk c of a tile (nt tokens): K chunks first (ck a token), then V (cv a
// token).  Element offset in its page, and the pool it reads.
__device__ __forceinline__ size_t chunk_elem(const GqaArgs& a, int hk, int t0,
                                             int nk, int ck, int cv, int c,
                                             bool& is_v, int& t, int& col) {
  is_v = c >= nk;
  const int cc = is_v ? c - nk : c, per = is_v ? cv : ck;
  t = cc / per;
  col = (cc - t * per) * VEC;
  return is_v ? (size_t)(t0 + t) * a.mv + hk * a.dv + col
              : (size_t)(t0 + t) * a.mk + hk * a.hd + col;
}

// Tile i of the CTA's page range into raw stage `raw`: this thread's chunks
// c = tid, tid + 128, ... (the same thread decodes them), cp.async.
__device__ void gqa_issue(const GqaArgs& a, const GqaSmem& L, unsigned char* raw,
                          int b, int hk, int lo, int tpp, int i) {
  const int page = lo + i / tpp, t0 = (i % tpp) * a.tile;
  const int nt = min(a.tile, a.tp - t0);
  const int pid_k = page_id(a.table_k, a.P, b, page, a.pk.n_pages);
  const int pid_v = page_id(a.table_v, a.P, b, page, a.pv.n_pages);
  const int ck = a.hd / VEC, cv = a.dv / VEC, nk = nt * ck;
  for (int c = threadIdx.x; c < nk + nt * cv; c += GQA_THREADS) {
    bool is_v;
    int t, col;
    const size_t e = chunk_elem(a, hk, t0, nk, ck, cv, c, is_v, t, col);
    const Pool& pl = is_v ? a.pv : a.pk;
    const size_t at = (size_t)(is_v ? pid_v : pid_k) * pl.page_elems + e;
    cp_async16(raw + c * 16, pl.sm + at);
    cp_async8(raw + L.codes + c * 8, pl.packed + at / 2);
  }
}

// 16 elements (sign-mantissa bytes + packed codes) -> container bits, as
// 32-bit words (bf16: two a word, fp8: four) at dst.
template <class F>
__device__ __forceinline__ void decode_vec(uint4 smv, uint2 pkv, uint64_t lut_lo,
                                           uint64_t lut_hi, uint32_t* dst) {
  const uint32_t sm[4] = {smv.x, smv.y, smv.z, smv.w};
  const uint32_t pk[2] = {pkv.x, pkv.y};
  uint32_t bits[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const uint32_t a = (sm[i >> 2] >> (8 * (i & 3))) & 0xFFu;
    const uint32_t code = (pk[i >> 3] >> (4 * (i & 7))) & 0xFu;
    const uint32_t ex =
        (uint32_t)(((code & 8u) ? lut_hi : lut_lo) >> (8 * (code & 7u))) & 0xFFu;
    bits[i] = (((a >> F::MBITS) & 1u) << (F::BITS - 1) | (ex << F::MBITS) |
               (a & F::MMASK)) &
              F::CMASK;
  }
  if constexpr (F::BITS == 16) {
#pragma unroll
    for (int w = 0; w < VEC / 2; ++w) dst[w] = bits[2 * w] | (bits[2 * w + 1] << 16);
  } else {
#pragma unroll
    for (int w = 0; w < VEC / 4; ++w)
      dst[w] = bits[4 * w] | (bits[4 * w + 1] << 8) | (bits[4 * w + 2] << 16) |
               (bits[4 * w + 3] << 24);
  }
}

// One 32-bit word of container bits -> its 2 (bf16) or 4 (fp8) values.
template <class F>
__device__ __forceinline__ void unpack_word(uint32_t x, float* f) {
  if constexpr (F::BITS == 16) {
    f[0] = __uint_as_float(x << 16);
    f[1] = __uint_as_float(x & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = to_f32<F>((x >> (8 * e)) & 0xFFu);
  }
}

// One CTA per (row b, KV head hk, split): the page-ordered online softmax of
// the unsplit kernel over this split's contiguous range of the row's full
// pages, un-normalized partials out.  Per tile: cp.async of the next tile's
// streams, this thread's chunks decoded from shared memory, a barrier, the
// escape warps (0: K, 1: V) in slot order, a barrier; then each warp runs
// scores, softmax and context for its own query rows with no barrier.
template <class F>
__global__ void __launch_bounds__(GQA_THREADS) paged_gqa_split_kernel(GqaArgs a) {
  using T = typename std::conditional<F::BITS == 16, uint16_t, uint8_t>::type;
  constexpr int EPW = 4 / (int)sizeof(T);  // elements a 32-bit word
  extern __shared__ __align__(16) unsigned char gsmem[];
  const int b = blockIdx.x, hk = blockIdx.y, split = blockIdx.z;
  const int R = a.nq * a.G;
  const GqaSmem L = gqa_smem(a.tile, R, a.hd, a.dv, (int)sizeof(T));
  unsigned char* raw0 = gsmem;
  uint32_t* bits0 = reinterpret_cast<uint32_t*>(gsmem + 2 * L.raw);
  float* q_s = reinterpret_cast<float*>(gsmem + 2 * L.raw + 2 * L.bits);
  float* p_s = q_s + R * a.hd;
  float* acc_s = p_s + R * a.tile;
  float* m_s = acc_s + R * a.dv;
  float* l_s = m_s + R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint64_t lut_lo = 0, lut_hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lut_lo |= (uint64_t)a.lut.t[i] << (8 * i);
    lut_hi |= (uint64_t)a.lut.t[8 + i] << (8 * i);
  }

  // query rows: row r = qi * G + gi is head hk * G + gi of query qi
  for (int i = tid; i < R * a.hd; i += GQA_THREADS) {
    const int r = i / a.hd, d = i - r * a.hd;
    const int qi = r / a.G, head = hk * a.G + r % a.G;
    q_s[i] = __uint_as_float(
        (unsigned)a.q[(((size_t)b * a.nq + qi) * a.H + head) * a.hd + d] << 16);
  }
  for (int i = tid; i < R * a.dv; i += GQA_THREADS) acc_s[i] = 0.f;
  for (int r = tid; r < R; r += GQA_THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  const int clen = a.cache_len[b];
  const int n_full = min(clen / a.tp, a.P);
  const int lo = (int)((long long)split * a.P / a.n_split);
  const int hi = min((int)((long long)(split + 1) * a.P / a.n_split), n_full);
  const int tpp = (a.tp + a.tile - 1) / a.tile;  // tiles a page
  const int n_tiles = hi > lo ? (hi - lo) * tpp : 0;
  const int ck = a.hd / VEC, cv = a.dv / VEC;
  if (n_tiles > 0) gqa_issue(a, L, raw0, b, hk, lo, tpp, 0);
  cp_async_commit();
  __syncthreads();

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) gqa_issue(a, L, raw0 + (st ^ 1) * L.raw, b, hk, lo, tpp, i + 1);
    cp_async_commit();
    cp_async_wait1();  // this thread's copies of tile i have landed

    const int page = lo + i / tpp, t0 = (i % tpp) * a.tile;
    const int nt = min(a.tile, a.tp - t0), nk = nt * ck;
    const unsigned char* raw = raw0 + st * L.raw;
    uint32_t* kb = bits0 + st * (L.bits / 4);
    uint32_t* vb = kb + a.tile * L.ldk;
    for (int c = tid; c < nk + nt * cv; c += GQA_THREADS) {
      bool is_v;
      int t, col;
      chunk_elem(a, hk, t0, nk, ck, cv, c, is_v, t, col);
      uint32_t* dst = (is_v ? vb + t * L.ldv : kb + t * L.ldk) + col / EPW;
      decode_vec<F>(*reinterpret_cast<const uint4*>(raw + c * 16),
                    *reinterpret_cast<const uint2*>(raw + L.codes + c * 8), lut_lo,
                    lut_hi, dst);
    }
    __syncthreads();
    if (warp == 0)
      tile_escapes<F>(a.pk, page_id(a.table_k, a.P, b, page, a.pk.n_pages), a.mk, t0,
                      nt, hk * a.hd, a.hd, reinterpret_cast<T*>(kb), L.ldk * EPW);
    if (warp == 1)
      tile_escapes<F>(a.pv, page_id(a.table_v, a.P, b, page, a.pv.n_pages), a.mv, t0,
                      nt, hk * a.dv, a.dv, reinterpret_cast<T*>(vb), L.ldv * EPW);
    __syncthreads();

    const int tok0 = page * a.tp + t0;
    for (int r = warp; r < R; r += GQA_WARPS) {
      const int q_pos = clen - (a.nq - 1) + r / a.G;
      const float* qr = q_s + r * a.hd;
      float* pr = p_s + r * a.tile;
      // scores, a lane a token
      float mx = -3.0e38f;
      for (int t = lane; t < nt; t += 32) {
        const uint32_t* kr = kb + t * L.ldk;
        float dot = 0.f;
#pragma unroll 8
        for (int w = 0; w < a.hd / EPW; ++w) {
          float f[EPW];
          unpack_word<F>(kr[w], f);
#pragma unroll
          for (int e = 0; e < EPW; ++e) dot = fmaf(qr[w * EPW + e], f[e], dot);
        }
        float sc = dot * a.scale;
        if (a.causal && tok0 + t > q_pos) sc = NEG_INF;
        pr[t] = sc;
        mx = fmaxf(mx, sc);
      }
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float corr = expf(m_prev - m_new);
      __syncwarp();
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
      // context, a lane a word of the V rows
      float* ar = acc_s + r * a.dv;
      for (int w = lane; w < a.dv / EPW; w += 32) {
        float pv[EPW];
#pragma unroll
        for (int e = 0; e < EPW; ++e) pv[e] = 0.f;
#pragma unroll 4
        for (int t = 0; t < nt; ++t) {
          float f[EPW];
          unpack_word<F>(vb[t * L.ldv + w], f);
          const float pt = pr[t];
#pragma unroll
          for (int e = 0; e < EPW; ++e) pv[e] = fmaf(pt, f[e], pv[e]);
        }
#pragma unroll
        for (int e = 0; e < EPW; ++e) ar[w * EPW + e] = ar[w * EPW + e] * corr + pv[e];
      }
      __syncwarp();
    }
  }

  // a split with no visible token (an empty range, or every key above the
  // causal diagonal) leaves m = -1e30 and gives l = 0, acc = 0
  for (int r = warp; r < R; r += GQA_WARPS) {
    const int qi = r / a.G, head = hk * a.G + r % a.G;
    const size_t row = (((size_t)split * a.B + b) * a.nq + qi) * a.H + head;
    const bool dead = m_s[r] <= NEG_INF;
    for (int d = lane; d < a.dv; d += 32)
      a.acc[row * a.dv + d] = dead ? 0.f : acc_s[r * a.dv + d];
    if (lane == 0) {
      a.m[row] = m_s[r];
      a.l[row] = dead ? 0.f : l_s[r];
    }
  }
}

// The splits' partials of `rows` query rows -> the unsplit partials: m the
// maximum over the splits, l and acc rescaled by exp(m_s - m) and summed in
// split order.  One warp a row; the row's weights exp(m_s - m) are computed
// once into shared memory, so the sums only stream acc.
__global__ void __launch_bounds__(MERGE_THREADS)
    gqa_merge_kernel(const float* __restrict__ acc_p, const float* __restrict__ m_p,
                     const float* __restrict__ l_p, float* __restrict__ acc,
                     float* __restrict__ m, float* __restrict__ l, int rows, int dv,
                     int n_split) {
  extern __shared__ float w_s[];  // (MERGE_THREADS / 32, n_split)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (MERGE_THREADS / 32) + warp;
  if (row >= rows) return;
  float* w = w_s + warp * n_split;
  float mx = NEG_INF;
  for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, m_p[(size_t)s * rows + row]);
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  for (int s = lane; s < n_split; s += 32) w[s] = expf(m_p[(size_t)s * rows + row] - mx);
  __syncwarp();
  for (int d = lane; d < dv; d += 32) {
    const float* src = acc_p + (size_t)row * dv + d;
    const size_t step = (size_t)rows * dv;
    float x = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) x += src[s * step] * w[s];
    acc[(size_t)row * dv + d] = x;
  }
  if (lane == 0) {
    float y = 0.f;
    for (int s = 0; s < n_split; ++s) y += l_p[(size_t)s * rows + row] * w[s];
    m[row] = mx;
    l[row] = y;
  }
}

template <class F>
int launch_gqa(const GqaArgs& a, int smem, cudaStream_t s) {
  auto kernel = paged_gqa_split_kernel<F>;
  static bool opted_in = false;  // the most shared memory a block may take
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)a.B, (unsigned)(a.H / a.G), (unsigned)a.n_split);
  kernel<<<grid, GQA_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
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

int launch_mla(int fmt, const AttnArgs& a, int B, int groups, int threads,
                int smem, const void* lut, void* stream) {
  if (B <= 0 || groups <= 0) return 0;
  if (threads < 64 || threads % 32 || a.tile < 1 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  AttnArgs args = a;
  memcpy(args.lut.t, lut, sizeof(args.lut.t));
  const dim3 grid((unsigned)B, (unsigned)groups), block((unsigned)threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch_with_smem(paged_mla_kernel<Bf16>, grid, block, smem, s, args);
    case 1: return launch_with_smem(paged_mla_kernel<E5m2>, grid, block, smem, s, args);
    case 2: return launch_with_smem(paged_mla_kernel<E4m3>, grid, block, smem, s, args);
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

// GQA: the split kernel over n_split contiguous ranges of each row's full
// pages, then (n_split > 1) the merge kernel; with n_split == 1 the split
// kernel writes acc, m, l itself and the *_part scratch is not used.
// hd and dv must be multiples of 16, the sign-mantissa and packed pools
// 16-byte aligned.
extern "C" int sz_paged_gqa(
    int fmt, const void* q, const void* k_sm, const void* k_packed,
    const void* k_pos, const void* k_val, const void* k_cnt, const void* v_sm,
    const void* v_packed, const void* v_pos, const void* v_val,
    const void* v_cnt, const void* table_k, const void* table_v,
    const void* cache_len, void* acc, void* m, void* l, void* acc_part,
    void* m_part, void* l_part, int B, int nq, int H, int hkv, int hd, int dv,
    int P, int tokens_per_page, int pe_k, int cap_k, int n_pages_k, int pe_v,
    int cap_v, int n_pages_v, int causal, float scale, int tile, int n_split,
    const void* lut, void* stream) {
  if (B <= 0) return 0;
  if (hkv <= 0 || H % hkv || hd <= 0 || dv <= 0 || hd % VEC || dv % VEC ||
      tile < 1 || n_split < 1 || nq < 1 || pe_k != tokens_per_page * hkv * hd ||
      pe_v != tokens_per_page * hkv * dv ||
      ((uintptr_t)k_sm | (uintptr_t)k_packed | (uintptr_t)v_sm |
       (uintptr_t)v_packed) % 16)
    return (int)cudaErrorInvalidValue;
  const int sz = fmt == 0 ? 2 : 1;
  const int smem = gqa_smem(tile, nq * (H / hkv), hd, dv, sz).total;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const bool split = n_split > 1;
  GqaArgs a;
  a.q = static_cast<const uint16_t*>(q);
  a.pk = make_pool(k_sm, k_packed, k_pos, k_val, k_cnt, pe_k, cap_k, n_pages_k);
  a.pv = make_pool(v_sm, v_packed, v_pos, v_val, v_cnt, pe_v, cap_v, n_pages_v);
  a.table_k = static_cast<const int32_t*>(table_k);
  a.table_v = static_cast<const int32_t*>(table_v);
  a.cache_len = static_cast<const int32_t*>(cache_len);
  a.acc = static_cast<float*>(split ? acc_part : acc);
  a.m = static_cast<float*>(split ? m_part : m);
  a.l = static_cast<float*>(split ? l_part : l);
  a.B = B;
  a.nq = nq;
  a.H = H;
  a.G = H / hkv;
  a.hd = hd;
  a.dv = dv;
  a.mk = hkv * hd;
  a.mv = hkv * dv;
  a.P = P;
  a.tp = tokens_per_page;
  a.tile = tile;
  a.causal = causal;
  a.n_split = n_split;
  a.scale = scale;
  memcpy(a.lut.t, lut, sizeof(a.lut.t));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (fmt) {
    case 0: err = launch_gqa<Bf16>(a, smem, s); break;
    case 1: err = launch_gqa<E5m2>(a, smem, s); break;
    case 2: err = launch_gqa<E4m3>(a, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err || !split) return err;
  const int rows = B * nq * H;
  const int merge_smem = (MERGE_THREADS / 32) * n_split * 4;
  if (merge_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  gqa_merge_kernel<<<(rows + MERGE_THREADS / 32 - 1) / (MERGE_THREADS / 32),
                     MERGE_THREADS, merge_smem, s>>>(
      static_cast<const float*>(acc_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), rows, dv, n_split);
  return (int)cudaGetLastError();
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
  return launch_mla(fmt, a, B, H / heads_per_cta, threads, smem, lut,
                           stream);
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
