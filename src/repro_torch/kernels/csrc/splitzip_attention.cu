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
// << 16, fp8 goes through cuda_fp8.h.  The MLA kernel stores bf16 values
// instead, and its escape warps rebuild an escaped element from its
// sign-mantissa byte, still in the copy stage, and the slot's exponent.
//
// Bound.  Per row and leaf the kernel must read the compressed bytes of
// its full pages, 1.5 * page_elems + 3 * cap + 4 per page, plus q and the
// f32 partials; the arithmetic is nq * H * Tp * (hd + dv) multiply-adds per
// page, 2 * nq * H * Tp * (hd + dv) operations (MLA: r + rope for the score
// and r for the context).  GQA, on the f32 CUDA cores, is bound by the
// bytes; so is MLA, whose 40 heads share one latent page, once its
// products run on the bf16 tensor cores (989 TFLOP/s against 67 on the
// f32 ALUs).
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
// MLA (sz_paged_mla), split the same way, on the tensor cores: one CTA per
// (row, group of hpc heads, split), hpc the largest divisor of H with
// nq * hpc <= 64, so at decode (nq 1) all of a row's heads share one CTA
// and each page is decoded once per row.  The CTA's query rows [q_lat |
// q_rope] sit in shared memory as bf16 (rows padded to 16 with zeros),
// each token tile of [ckv | krope] is decoded straight to bf16 (every
// e5m2 and e4m3 value is a bf16 value), and both products run as
// mma.sync m16n8k16 bf16 -> f32 from ldmatrix fragments: S = Q [ckv |
// krope]^T, then acc += P ckv with ckv read transposed (ldmatrix.trans).
// mma.sync rather than wgmma: a decode CTA has 1 to 4 M tiles of 16 rows,
// under wgmma's 64, and its operands are decoded into shared memory by
// the same threads, so the register-level instruction needs no
// descriptors, swizzle or warpgroup fences, and the work (about 167 MFLOP
// a call at minicpm3-4b's decode) is not what bounds the kernel.  Warps are
// (M tile, half of the latent columns): each recomputes its M tile's
// scores (cheap) and keeps 16 x r/2 f32 of acc in registers; the online
// softmax runs on the score fragment (rows reduced over a quad of lanes),
// and p enters P.V as bf16(p) + bf16(p - bf16(p)), two MMAs into one
// accumulator, so about 16 bits of the TPU kernel's f32 p survive.
// Stream loads, the next tile's cp.async during this tile's decode, the
// split ranges and the merge kernel are the GQA kernel's.
#include <cuda_bf16.h>
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
// that fall in the tile, in slot order, as put(key, exponent) with key =
// row * w + column inside the tile.
template <class Put>
__device__ void page_escapes(const Pool& pl, int pid, int m, int t0, int nt,
                             int c0, int w, Put put) {
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
          at = r * w + c;
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
        if (lane == 0 && a >= 0) put(a, vk);
        __syncwarp();
      }
    } else if (at >= 0) {
      put(at, v);
    }
    __syncwarp();
  }
}

// The escapes on container bits held in T at dst[row * ld + column]
// (32-bit for sz_decode_pages, the container's own width for the GQA split
// kernel): the slot's exponent replaces the exponent field.
template <class F, typename T>
__device__ void tile_escapes(const Pool& pl, int pid, int m, int t0, int nt,
                             int c0, int w, T* dst, int ld) {
  page_escapes(pl, pid, m, t0, nt, c0, w, [=](int key, unsigned v) {
    T& d = dst[(key / w) * ld + key % w];
    d = (T)(((d & F::KEEP) | (v << F::MBITS)) & F::CMASK);
  });
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

// Container bits -> the same value's bf16 bits (exact: every e5m2 and e4m3
// value is a bf16 value).
template <class F>
__device__ __forceinline__ uint32_t to_bf16_bits(uint32_t b) {
  if constexpr (F::KIND == 0) {
    return b;
  } else {
    return __float_as_uint(to_f32<F>(b)) >> 16;
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
// the GQA split kernel (flash-decoding) and its merge
// ---------------------------------------------------------------------------

constexpr int GQA_THREADS = 128;
constexpr int GQA_WARPS = GQA_THREADS / 32;
constexpr int VEC = 16;        // elements a copy: 16 B of sign-mantissa, 8 B of codes
constexpr int MERGE_THREADS = 128;

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

// 16 elements (sign-mantissa bytes + packed codes) -> their container bits.
template <class F>
__device__ __forceinline__ void decode_bits(uint4 smv, uint2 pkv, uint64_t lut_lo,
                                            uint64_t lut_hi, uint32_t (&bits)[VEC]) {
  const uint32_t sm[4] = {smv.x, smv.y, smv.z, smv.w};
  const uint32_t pk[2] = {pkv.x, pkv.y};
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
}

// 16 elements -> container bits, as 32-bit words (bf16: two a word, fp8:
// four) at dst.
template <class F>
__device__ __forceinline__ void decode_vec(uint4 smv, uint2 pkv, uint64_t lut_lo,
                                           uint64_t lut_hi, uint32_t* dst) {
  uint32_t bits[VEC];
  decode_bits<F>(smv, pkv, lut_lo, lut_hi, bits);
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
// split order.  One CTA a row, its warps over the row's columns, so a
// decode batch's few hundred rows spread over the card; each warp computes
// the row's weights exp(m_s - m) into its own shared memory, so the sums
// only stream acc and no barrier joins the warps.  GQA and MLA alike.
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_splits_kernel(const float* __restrict__ acc_p, const float* __restrict__ m_p,
                        const float* __restrict__ l_p, float* __restrict__ acc,
                        float* __restrict__ m, float* __restrict__ l, int rows,
                        int dv, int n_split) {
  extern __shared__ float w_s[];  // (MERGE_THREADS / 32, n_split)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  float* w = w_s + warp * n_split;
  float mx = NEG_INF;
  for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, m_p[(size_t)s * rows + row]);
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  for (int s = lane; s < n_split; s += 32) w[s] = expf(m_p[(size_t)s * rows + row] - mx);
  __syncwarp();
  for (int d = threadIdx.x; d < dv; d += MERGE_THREADS) {
    const float* src = acc_p + (size_t)row * dv + d;
    const size_t step = (size_t)rows * dv;
    float x = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) x += src[s * step] * w[s];
    acc[(size_t)row * dv + d] = x;
  }
  if (threadIdx.x == 0) {
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
// the MLA split kernel (absorbed form, tensor cores)
// ---------------------------------------------------------------------------

constexpr int MLA_THREADS = 256;
constexpr int MLA_WARPS = MLA_THREADS / 32;
constexpr int MLA_MAX_ROWS = 64;   // query rows a CTA: M tiles of 16, two warps each
constexpr int MLA_MAX_TILE = 64;   // tokens a tile: the score fragment's 8 n-tiles
constexpr int MLA_MAX_HALF = 128;  // latent columns a warp accumulates: 16 n-tiles
static_assert(2 * MLA_MAX_ROWS / 16 <= MLA_WARPS, "two warps an M tile");

struct MlaArgs {
  const uint16_t* q_lat;   // bf16 (B, nq, H, r)
  const uint16_t* q_rope;  // bf16 (B, nq, H, rope)
  Pool pc, pr;             // ckv and krope pools
  const int32_t* table_c;  // (B, P)
  const int32_t* table_r;
  const int32_t* cache_len;  // (B,)
  float* acc;              // (n_split, B, nq, H, r)
  float* m;                // (n_split, B, nq, H)
  float* l;
  int B, nq, H, hpc, r, rope;
  int P, tp, tile, causal, n_split;
  float scale;
  DecodeLut lut;
};

// Shared memory of one CTA: the query rows (bf16, rows padded to 16), two
// bf16 tile stages of [ckv | krope] (a tile's tokens padded to 16 with zero
// rows), two raw stages (a tile's sign-mantissa copies, then its codes).
// Rows of Q and of a tile are ld = r + rope + 8 elements: an odd number of
// 16-byte units, so the 8 row addresses of an ldmatrix hit 32 banks.
struct MlaSmem {
  int ld;     // bf16 elements a row
  int q;      // bytes of Q
  int tile;   // bytes of a tile stage
  int codes;  // offset of the packed codes in a raw stage
  int raw;    // bytes of a raw stage
  int total;
};

__host__ __device__ inline MlaSmem mla_smem(int tile, int rows, int r, int rope) {
  MlaSmem g;
  const int chunks = tile * (r + rope) / VEC;
  g.ld = r + rope + 8;
  g.q = (rows + 15) / 16 * 16 * g.ld * 2;
  g.tile = (tile + 15) / 16 * 16 * g.ld * 2;
  g.codes = chunks * 16;
  g.raw = (chunks * 24 + 15) / 16 * 16;
  g.total = g.q + 2 * g.tile + 2 * g.raw;
  return g;
}

__device__ __forceinline__ void ldsm4(uint32_t (&x)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t (&x)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(addr));
}
// d += a (16 x 16, row) b (16 x 8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x, y) -> hi = bf16 pair, lo = bf16 pair of what rounding left (x low)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// Chunk c of a tile of nt tokens: ckv chunks first (ck a token), then
// krope (cr a token).  Its token t and its column in a tile row (krope
// after the r ckv columns); true for krope.
__device__ __forceinline__ bool mla_chunk(int c, int nk, int ck, int cr, int r,
                                          int& t, int& col) {
  if (c < nk) {
    t = c / ck;
    col = (c - t * ck) * VEC;
    return false;
  }
  const int cc = c - nk;
  t = cc / cr;
  col = r + (cc - t * cr) * VEC;
  return true;
}

// Tile i of the CTA's page range into raw stage `raw`: this thread's chunks
// c = tid, tid + 256, ... (the same thread decodes them), cp.async.
__device__ void mla_issue(const MlaArgs& a, const MlaSmem& L, unsigned char* raw,
                          int b, int lo, int tpp, int i) {
  const int page = lo + i / tpp, t0 = (i % tpp) * a.tile;
  const int nt = min(a.tile, a.tp - t0);
  const int pid_c = page_id(a.table_c, a.P, b, page, a.pc.n_pages);
  const int pid_r = page_id(a.table_r, a.P, b, page, a.pr.n_pages);
  const int ck = a.r / VEC, cr = a.rope / VEC, nk = nt * ck;
  for (int c = threadIdx.x; c < nk + nt * cr; c += MLA_THREADS) {
    int t, col;
    const bool rope = mla_chunk(c, nk, ck, cr, a.r, t, col);
    const Pool& pl = rope ? a.pr : a.pc;
    const size_t at = (size_t)(rope ? pid_r : pid_c) * pl.page_elems +
                      (size_t)(t0 + t) * (rope ? a.rope : a.r) + (rope ? col - a.r : col);
    cp_async16(raw + c * 16, pl.sm + at);
    cp_async8(raw + L.codes + c * 8, pl.packed + at / 2);
  }
}

// This thread's chunks of raw stage `raw` -> bf16 values of the tile
// (nt tokens, zero rows up to ntp).
template <class F>
__device__ void mla_decode(const MlaArgs& a, const MlaSmem& L,
                           const unsigned char* raw, uint16_t* tl, int nt, int ntp,
                           uint64_t lut_lo, uint64_t lut_hi) {
  const int ck = a.r / VEC, cr = a.rope / VEC, nk = nt * ck;
  for (int c = threadIdx.x; c < nk + nt * cr; c += MLA_THREADS) {
    int t, col;
    mla_chunk(c, nk, ck, cr, a.r, t, col);
    uint32_t bits[VEC];
    decode_bits<F>(*reinterpret_cast<const uint4*>(raw + c * 16),
                   *reinterpret_cast<const uint2*>(raw + L.codes + c * 8), lut_lo,
                   lut_hi, bits);
    uint32_t w[VEC / 2];
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e)
      w[e] = to_bf16_bits<F>(bits[2 * e]) | (to_bf16_bits<F>(bits[2 * e + 1]) << 16);
    uint4* dst = reinterpret_cast<uint4*>(tl + t * L.ld + col);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  const int rv = (a.r + a.rope) / 8;  // 16-byte units a row
  for (int i = threadIdx.x; i < (ntp - nt) * rv; i += MLA_THREADS) {
    const int t = nt + i / rv;
    *reinterpret_cast<uint4*>(tl + t * L.ld + (i % rv) * 8) = make_uint4(0, 0, 0, 0);
  }
}

// The escape warp of one leaf (w elements a token): an escaped element is
// rebuilt from its sign-mantissa byte, which the raw stage holds at
// sm[row * w + column] (the leaf's chunks are a token's 16-element runs in
// order), and the slot's exponent, then stored as bf16 at dst[row * ld +
// column].  The bits are those tile_escapes would leave: the sign and
// mantissa of the dense decode, the slot's exponent.
template <class F>
__device__ void mla_escapes(const Pool& pl, int pid, int w, int t0, int nt,
                            const unsigned char* sm, uint16_t* dst, int ld) {
  page_escapes(pl, pid, w, t0, nt, 0, w, [=](int key, unsigned v) {
    const unsigned x = sm[key];
    const unsigned bits = ((((x >> F::MBITS) & 1u) << (F::BITS - 1)) |
                           (x & F::MMASK) | (v << F::MBITS)) &
                          F::CMASK;
    dst[(key / w) * ld + key % w] = (uint16_t)to_bf16_bits<F>(bits);
  });
}

// One CTA per (row b, head group, split) over the split's contiguous range
// of the row's full pages.  Per tile: cp.async of the next tile's streams,
// this thread's chunks decoded to bf16, a barrier, the escape warps (0:
// ckv, 1: krope), a barrier; then warp w < 2 * MT takes M tile w / 2 (query
// rows 16 (w / 2) ..) and latent columns [(w % 2) r / 2, ...): S = Q T^T
// over r + rope, the online softmax on the fragment, acc += P V.  Fragment
// rows: a lane holds rows g = lane / 4 and g + 8 of its M tile, tokens or
// columns 8 j + 2 (lane % 4) and + 1 of each n-tile j.
template <class F>
__global__ void __launch_bounds__(MLA_THREADS, 1) paged_mla_split_kernel(MlaArgs a) {
  extern __shared__ __align__(16) unsigned char msmem[];
  const int b = blockIdx.x, grp = blockIdx.y, split = blockIdx.z;
  const int R = a.nq * a.hpc, MT = (R + 15) / 16;
  const int K = a.r + a.rope, half = a.r / 2;
  const MlaSmem L = mla_smem(a.tile, R, a.r, a.rope);
  uint16_t* q_s = reinterpret_cast<uint16_t*>(msmem);
  uint16_t* tile0 = reinterpret_cast<uint16_t*>(msmem + L.q);
  unsigned char* raw0 = msmem + L.q + 2 * L.tile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint64_t lut_lo = 0, lut_hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lut_lo |= (uint64_t)a.lut.t[i] << (8 * i);
    lut_hi |= (uint64_t)a.lut.t[8 + i] << (8 * i);
  }

  const int clen = a.cache_len[b];
  const int n_full = min(clen / a.tp, a.P);
  const int lo = (int)((long long)split * a.P / a.n_split);
  const int hi = min((int)((long long)(split + 1) * a.P / a.n_split), n_full);
  const int tpp = (a.tp + a.tile - 1) / a.tile;  // tiles a page
  const int n_tiles = hi > lo ? (hi - lo) * tpp : 0;
  if (n_tiles > 0) mla_issue(a, L, raw0, b, lo, tpp, 0);
  cp_async_commit();

  // query rows, while the first tile's streams are in flight: row i = qi *
  // hpc + hi is head grp * hpc + hi of query qi, [q_lat | q_rope]; rows R
  // .. 16 MT are zero
  const int rv = K / 8, lv = a.r / 8;  // 16-byte units a row, of q_lat
  for (int i = tid; i < MT * 16 * rv; i += MLA_THREADS) {
    const int row = i / rv, c = i - row * rv;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < R) {
      const size_t q = ((size_t)b * a.nq + row / a.hpc) * a.H + grp * a.hpc + row % a.hpc;
      x = c < lv ? reinterpret_cast<const uint4*>(a.q_lat + q * a.r)[c]
                 : reinterpret_cast<const uint4*>(a.q_rope + q * a.rope)[c - lv];
    }
    *reinterpret_cast<uint4*>(q_s + row * L.ld + c * 8) = x;
  }

  const bool mma_warp = warp < 2 * MT;
  const int mt = warp >> 1, col0 = (warp & 1) * half;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = mt * 16 + g;  // and row0 + 8
  const int qpos0 = clen - (a.nq - 1) + row0 / a.hpc;
  const int qpos1 = clen - (a.nq - 1) + (row0 + 8) / a.hpc;
  float acc[MLA_MAX_HALF / 8][4];
#pragma unroll
  for (int n = 0; n < MLA_MAX_HALF / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  // ldmatrix row addresses (a lane gives one row of one 8 x 8 matrix):
  // A = Q rows 16 mt + lane % 16, columns k0 + 8 (lane / 16); B of S = tile
  // tokens 16 j + 8 (lane / 16) + lane % 8, columns k0 + 8 (lane / 8 % 2);
  // B of P.V (transposed) = tile tokens 16 kk + 8 (lane / 8 % 2) + lane % 8,
  // columns col0 + 16 n + 8 (lane / 16)
  const uint32_t q_addr =
      smem_u32(q_s) + ((mt * 16 + (lane & 15)) * L.ld + (lane >> 4) * 8) * 2;
  const int s_row = (lane >> 4) * 8 + (lane & 7), s_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = col0 + (lane >> 4) * 8;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) mla_issue(a, L, raw0 + (st ^ 1) * L.raw, b, lo, tpp, i + 1);
    cp_async_commit();
    cp_async_wait1();  // this thread's copies of tile i have landed

    const int page = lo + i / tpp, t0 = (i % tpp) * a.tile;
    const int nt = min(a.tile, a.tp - t0), ntp = (nt + 15) & ~15;
    const unsigned char* raw = raw0 + st * L.raw;
    uint16_t* tl = tile0 + st * (L.tile / 2);
    mla_decode<F>(a, L, raw, tl, nt, ntp, lut_lo, lut_hi);
    __syncthreads();
    if (warp == 0)
      mla_escapes<F>(a.pc, page_id(a.table_c, a.P, b, page, a.pc.n_pages), a.r, t0, nt,
                     raw, tl, L.ld);
    if (warp == 1)
      mla_escapes<F>(a.pr, page_id(a.table_r, a.P, b, page, a.pr.n_pages), a.rope, t0,
                     nt, raw + nt * a.r, tl + a.r, L.ld);
    __syncthreads();
    if (!mma_warp) continue;

    // S = Q T^T over the r + rope columns
    const uint32_t t_addr = smem_u32(tl);
    float s[MLA_MAX_TILE / 8][4];
#pragma unroll
    for (int j = 0; j < MLA_MAX_TILE / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t qa[4];
      ldsm4(qa, q_addr + k0 * 2);
#pragma unroll
      for (int j = 0; j < MLA_MAX_TILE / 16; ++j) {
        if (16 * j < ntp) {
          uint32_t kb[4];
          ldsm4(kb, t_addr + ((16 * j + s_row) * L.ld + k0 + s_col) * 2);
          mma_bf16(s[2 * j], qa, kb[0], kb[1]);
          mma_bf16(s[2 * j + 1], qa, kb[2], kb[3]);
        }
      }
    }

    // scale, mask (tokens past nt, and above the causal diagonal), online
    // softmax over the tile for rows row0 (e 0, 1) and row0 + 8 (e 2, 3)
    const int tok0 = page * a.tp + t0;
    float mx0 = -3.0e38f, mx1 = -3.0e38f;
#pragma unroll
    for (int j = 0; j < MLA_MAX_TILE / 8; ++j) {
      if (8 * j < ntp) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * j + 2 * tq + (e & 1);
          float x = s[j][e] * a.scale;
          if (t >= nt || (a.causal && tok0 + t > (e < 2 ? qpos0 : qpos1))) x = NEG_INF;
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < MLA_MAX_TILE / 8; ++j) {
      if (8 * j < ntp) {
        s[j][0] = expf(s[j][0] - mn0);
        s[j][1] = expf(s[j][1] - mn0);
        s[j][2] = expf(s[j][2] - mn1);
        s[j][3] = expf(s[j][3] - mn1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
    }
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 = l0 * c0 + quad_sum(sum0);
    l1 = l1 * c1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < MLA_MAX_HALF / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // acc += P V, V the tile's ckv columns [col0, col0 + r / 2); the score
    // fragment of n-tiles 2 kk, 2 kk + 1 is the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < MLA_MAX_TILE / 16; ++kk) {
      if (16 * kk < ntp) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        const uint32_t v_addr = t_addr + ((16 * kk + v_row) * L.ld + v_col) * 2;
#pragma unroll
        for (int n = 0; n < MLA_MAX_HALF / 16; ++n) {
          if (16 * n < half) {
            uint32_t vb[4];
            ldsm4_trans(vb, v_addr + 32 * n);
            mma_bf16(acc[2 * n], ph, vb[0], vb[1]);
            mma_bf16(acc[2 * n], pl, vb[0], vb[1]);
            mma_bf16(acc[2 * n + 1], ph, vb[2], vb[3]);
            mma_bf16(acc[2 * n + 1], pl, vb[2], vb[3]);
          }
        }
      }
    }
  }

  // a split with no visible token (an empty range, or every key above the
  // causal diagonal) leaves m = -1e30 and gives l = 0, acc = 0
  if (!mma_warp) return;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = row0 + 8 * h2;
    if (row < R) {
      const size_t o = (((size_t)split * a.B + b) * a.nq + row / a.hpc) * a.H +
                       grp * a.hpc + row % a.hpc;
      const float mr = h2 ? m1 : m0;
      const bool dead = mr <= NEG_INF;
      float* dst = a.acc + o * a.r + col0 + 2 * tq;
#pragma unroll
      for (int n = 0; n < MLA_MAX_HALF / 8; ++n)
        if (8 * n < half)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              dead ? make_float2(0.f, 0.f)
                   : make_float2(acc[n][2 * h2], acc[n][2 * h2 + 1]);
      if ((warp & 1) == 0 && tq == 0) {
        a.m[o] = mr;
        a.l[o] = dead ? 0.f : (h2 ? l1 : l0);
      }
    }
  }
}

template <class F>
int launch_mla(const MlaArgs& a, int smem, cudaStream_t s) {
  auto kernel = paged_mla_split_kernel<F>;
  static bool opted_in = false;  // the most shared memory a block may take
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)a.B, (unsigned)(a.H / a.hpc), (unsigned)a.n_split);
  kernel<<<grid, MLA_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The merge of n_split > 1 splits' partials (B nq H rows of dv) into acc,
// m, l.
int launch_merge(const void* acc_part, const void* m_part, const void* l_part,
                 void* acc, void* m, void* l, int rows, int dv, int n_split,
                 cudaStream_t s) {
  const int merge_smem = (MERGE_THREADS / 32) * n_split * 4;
  if (merge_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  merge_splits_kernel<<<rows, MERGE_THREADS, merge_smem, s>>>(
      static_cast<const float*>(acc_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), rows, dv, n_split);
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
  return launch_merge(acc_part, m_part, l_part, acc, m, l, B * nq * H, dv, n_split, s);
}

// MLA: the split kernel over n_split contiguous ranges of each row's full
// pages, then (n_split > 1) the merge kernel, as for GQA.  heads_per_cta
// divides H with nq * heads_per_cta <= 64; kv_rank a multiple of 32 up to
// 256, rope_dim a multiple of 16; q_lat, q_rope and the sign-mantissa and
// packed pools 16-byte aligned.
extern "C" int sz_paged_mla(
    int fmt, const void* q_lat, const void* q_rope, const void* c_sm,
    const void* c_packed, const void* c_pos, const void* c_val,
    const void* c_cnt, const void* r_sm, const void* r_packed,
    const void* r_pos, const void* r_val, const void* r_cnt,
    const void* table_c, const void* table_r, const void* cache_len,
    void* acc, void* m, void* l, void* acc_part, void* m_part, void* l_part,
    int B, int nq, int H, int heads_per_cta, int kv_rank, int rope_dim, int P,
    int tokens_per_page, int pe_c, int cap_c, int n_pages_c, int pe_r,
    int cap_r, int n_pages_r, int causal, float scale, int tile, int n_split,
    const void* lut, void* stream) {
  if (B <= 0) return 0;
  if (nq < 1 || heads_per_cta < 1 || H % heads_per_cta ||
      nq * heads_per_cta > MLA_MAX_ROWS || kv_rank < 32 || kv_rank % 32 ||
      kv_rank / 2 > MLA_MAX_HALF || rope_dim < VEC || rope_dim % VEC || tile < 1 ||
      tile > MLA_MAX_TILE || n_split < 1 || pe_c != tokens_per_page * kv_rank ||
      pe_r != tokens_per_page * rope_dim ||
      ((uintptr_t)q_lat | (uintptr_t)q_rope | (uintptr_t)c_sm | (uintptr_t)c_packed |
       (uintptr_t)r_sm | (uintptr_t)r_packed) % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = mla_smem(tile, nq * heads_per_cta, kv_rank, rope_dim).total;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const bool split = n_split > 1;
  MlaArgs a;
  a.q_lat = static_cast<const uint16_t*>(q_lat);
  a.q_rope = static_cast<const uint16_t*>(q_rope);
  a.pc = make_pool(c_sm, c_packed, c_pos, c_val, c_cnt, pe_c, cap_c, n_pages_c);
  a.pr = make_pool(r_sm, r_packed, r_pos, r_val, r_cnt, pe_r, cap_r, n_pages_r);
  a.table_c = static_cast<const int32_t*>(table_c);
  a.table_r = static_cast<const int32_t*>(table_r);
  a.cache_len = static_cast<const int32_t*>(cache_len);
  a.acc = static_cast<float*>(split ? acc_part : acc);
  a.m = static_cast<float*>(split ? m_part : m);
  a.l = static_cast<float*>(split ? l_part : l);
  a.B = B;
  a.nq = nq;
  a.H = H;
  a.hpc = heads_per_cta;
  a.r = kv_rank;
  a.rope = rope_dim;
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
    case 0: err = launch_mla<Bf16>(a, smem, s); break;
    case 1: err = launch_mla<E5m2>(a, smem, s); break;
    case 2: err = launch_mla<E4m3>(a, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err || !split) return err;
  return launch_merge(acc_part, m_part, l_part, acc, m, l, B * nq * H, kv_rank,
                      n_split, s);
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
