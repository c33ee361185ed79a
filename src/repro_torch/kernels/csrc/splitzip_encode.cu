// SplitZip encode kernels for Hopper (sm_90a): fused and dense.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/splitzip_encode.py:
//   sz_encode_fused  <- encode_fused (_encode_fused_kernel)
//   sz_encode_dense  <- encode_dense (_encode_kernel)
//
// What it computes, per 1024-element row (one escape chunk) of container
// bits (u16 for bf16, u8 for fp8):
//   sign_mantissa  u8[chunk]     exact sign + mantissa byte per element
//   packed         u8[chunk/2]   4-bit exponent codes, element 2i low nibble
//   fused: esc_pos u16[cap], esc_val u8[cap], count i32 — the escapes of the
//          row in position order; slots >= min(count, cap) hold the padding
//          (pos = chunk, val = 0); count is the TRUE escape count (may
//          exceed cap, extra escapes are dropped)
//   dense: is_escape u8[chunk]  (the compaction runs outside)
//
// Bound: memory traffic.  bf16 reads 2 B/element and writes 1.5 B/element of
// dense streams, plus (3*cap + 4)/chunk B/element of escape buffers (fused)
// or 1 B/element of escape mask (dense); the arithmetic is a few integer ops
// per element, far below the card's integer rate.  The code lookup is a
// 256-entry (bf16) / 32- or 16-entry (fp8) byte table in shared memory,
// copied from the launch parameters, instead of the TPU kernel's 16
// broadcast compares (bit 7 = escape flag, low nibble = code).
//
// Dense kernel: one CTA per row, chunk/8 threads, each thread owning 8
// contiguous elements (one 16-byte load for bf16, 8 bytes for fp8).
//
// Fused kernel: a persistent grid (as many 256-thread CTAs as fit on the
// card, no more than the rows need) in which each warp encodes whole rows,
// w, w + W, ... for warp w of W.  The table is copied to shared memory once
// per CTA; nothing in the row loop waits on the block.  A row is walked in
// steps of 32 * E elements, E contiguous ones a lane: E = 16 where the chunk
// is a multiple of 512 (bf16: two 16-byte loads, a 16-byte sign-mantissa
// store and an 8-byte code word a lane), else 8.  Each warp keeps the loads
// of its next 32 / E steps in flight in registers (a whole row ahead at
// chunk 1024, 2 KB a warp for bf16) while it encodes the current one.  The
// persistence is what keeps the memory busy: a CTA per row would spend a
// launch, a table fill and a barrier on every row.  Loads bypass L1 (each
// byte is read once) and the streams go out as streaming stores.  Escape
// ranks come from a warp-level exclusive scan in position order: the
// per-lane count (0..E) bit-sliced through __ballot_sync / __popc, with the
// row's running total carried across steps; a step without escapes costs
// one vote.
// Escape slots are written by the lanes that own them, the padding slots as
// the widest stores the row stride allows.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "codec_stream.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

struct EncodeLut {
  unsigned char t[256];  // exponent -> code | 0x80 if the exponent escapes
};

// ---------------------------------------------------------------------------
// dense kernel: one CTA per row
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(const uint16_t* p, unsigned (&x)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  x[0] = v.x & 0xFFFFu; x[1] = v.x >> 16;
  x[2] = v.y & 0xFFFFu; x[3] = v.y >> 16;
  x[4] = v.z & 0xFFFFu; x[5] = v.z >> 16;
  x[6] = v.w & 0xFFFFu; x[7] = v.w >> 16;
}

__device__ __forceinline__ void load8(const uint8_t* p, unsigned (&x)[8]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = (v.x >> (8 * i)) & 0xFFu;
    x[4 + i] = (v.y >> (8 * i)) & 0xFFu;
  }
}

__device__ __forceinline__ uint2 pack_bytes8(const unsigned (&b)[8]) {
  uint2 v;
  v.x = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  v.y = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24);
  return v;
}

template <typename T, int MBITS, int EBITS>
__global__ void encode_dense_kernel(const T* __restrict__ bits,
                                    uint8_t* __restrict__ sign_mantissa,
                                    uint8_t* __restrict__ packed,
                                    uint8_t* __restrict__ is_escape,
                                    int chunk, EncodeLut lut) {
  constexpr int NLUT = 1 << EBITS;
  constexpr unsigned EMASK = (1u << EBITS) - 1u;
  constexpr unsigned MMASK = (1u << MBITS) - 1u;
  __shared__ unsigned char s_lut[NLUT];

  const int t = threadIdx.x;
  for (int i = t; i < NLUT; i += blockDim.x) s_lut[i] = lut.t[i];
  __syncthreads();

  const size_t row = blockIdx.x;
  const size_t first = row * (size_t)chunk + 8 * (size_t)t;

  unsigned x[8];
  load8(bits + first, x);
  unsigned a[8], e[8];
  unsigned codes = 0, esc_mask = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    e[i] = (x[i] >> MBITS) & EMASK;
    a[i] = ((x[i] >> EBITS) & (1u << MBITS)) | (x[i] & MMASK);
    const unsigned c = s_lut[e[i]];
    codes |= (c & 0xFu) << (4 * i);
    esc_mask |= ((c >> 7) & 1u) << i;
  }
  *reinterpret_cast<uint2*>(sign_mantissa + first) = pack_bytes8(a);
  *reinterpret_cast<unsigned*>(packed + first / 2) = codes;

  unsigned flags[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) flags[i] = (esc_mask >> i) & 1u;
  *reinterpret_cast<uint2*>(is_escape + first) = pack_bytes8(flags);
}

// ---------------------------------------------------------------------------
// fused kernel: persistent, a warp per row
// ---------------------------------------------------------------------------

// element i (a compile-time index after unrolling) of T-wide elements
template <typename T, int NB>
__device__ __forceinline__ unsigned element(const Words<NB>& x, int i) {
  constexpr int PER = 4 / sizeof(T);
  constexpr unsigned MASK = sizeof(T) == 2 ? 0xFFFFu : 0xFFu;
  return (x.w[i / PER] >> (8 * sizeof(T) * (i % PER))) & MASK;
}

template <typename V>
__device__ __forceinline__ V splat(unsigned fill);
template <>
__device__ __forceinline__ uint4 splat<uint4>(unsigned f) {
  return make_uint4(f, f, f, f);
}
template <>
__device__ __forceinline__ uint2 splat<uint2>(unsigned f) {
  return make_uint2(f, f);
}
template <>
__device__ __forceinline__ unsigned splat<unsigned>(unsigned f) { return f; }
template <>
__device__ __forceinline__ uint16_t splat<uint16_t>(unsigned f) {
  return (uint16_t)f;
}
template <>
__device__ __forceinline__ uint8_t splat<uint8_t>(unsigned f) {
  return (uint8_t)f;
}

// slots [lo, cap) of one row's buffer <- the fill pattern (the slot value
// repeated through 32 bits), as V-wide stores; the V word that holds slot lo
// is finished slot by slot.  The warp's lanes take the words in turn.
template <typename V, typename U>
__device__ __forceinline__ void pad_words(U* slots, int lo, int cap,
                                          unsigned fill, unsigned lane) {
  constexpr int PER = sizeof(V) / sizeof(U);
  for (int g = lo / PER + (int)lane; g < cap / PER; g += 32) {
    if (g * PER >= lo) {
      reinterpret_cast<V*>(slots)[g] = splat<V>(fill);
    } else {
      for (int k = lo; k < (g + 1) * PER; ++k) slots[k] = (U)fill;
    }
  }
}

// the widest stores the row stride (cap * sizeof(U) bytes) allows; the
// buffers' bases are 16-byte aligned, so every row start is V-aligned
template <typename U>
__device__ __forceinline__ void pad_slots(U* slots, int lo, int cap,
                                          unsigned fill, unsigned lane) {
  const int bytes = cap * (int)sizeof(U);
  if (bytes % 16 == 0) {
    pad_words<uint4>(slots, lo, cap, fill, lane);
  } else if (bytes % 8 == 0) {
    pad_words<uint2>(slots, lo, cap, fill, lane);
  } else if (bytes % 4 == 0) {
    pad_words<unsigned>(slots, lo, cap, fill, lane);
  } else if (bytes % 2 == 0) {
    pad_words<uint16_t>(slots, lo, cap, fill, lane);
  } else {
    pad_words<U>(slots, lo, cap, fill, lane);
  }
}

template <typename T, int MBITS, int EBITS, int E>
__global__ void __launch_bounds__(FUSED_THREADS)
encode_fused_kernel(const T* __restrict__ bits,
                    uint8_t* __restrict__ sign_mantissa,
                    uint8_t* __restrict__ packed,
                    uint16_t* __restrict__ esc_pos,
                    uint8_t* __restrict__ esc_val,
                    int32_t* __restrict__ esc_count, long long rows,
                    int chunk, int cap, EncodeLut lut) {
  constexpr int NLUT = 1 << EBITS;
  constexpr unsigned EMASK = (1u << EBITS) - 1u;
  constexpr unsigned MMASK = (1u << MBITS) - 1u;
  constexpr int NB = E * sizeof(T);
  constexpr int STEP = 32 * E;
  constexpr int RING = ring_steps(E);
  constexpr int SCAN_BITS = E < 16 ? 4 : 5;  // bits of a count 0..E
  __shared__ unsigned char s_lut[NLUT];
  for (int i = threadIdx.x; i < NLUT; i += blockDim.x) s_lut[i] = lut.t[i];
  __syncthreads();

  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long warps = (long long)gridDim.x * FUSED_WARPS;
  const long long warp =
      (long long)blockIdx.x * FUSED_WARPS + (threadIdx.x >> 5);
  const int steps = chunk / STEP;
  // the warp's (row, step) items: rows warp, warp + warps, ..., each in steps
  const long long items =
      warp < rows ? ((rows - 1 - warp) / warps + 1) * steps : 0;
  const T* src = bits + lane * E;

  Words<NB> ring[RING];
  long long lrow = warp;  // the next item to load
  int lstep = 0;
#pragma unroll
  for (int k = 0; k < RING; ++k) {
    if (k < items) {
      ring[k] = ld_stream<NB>(src + lrow * chunk + lstep * STEP);
      if (++lstep == steps) { lstep = 0; lrow += warps; }
    }
  }

  long long row = warp;   // the item being encoded
  int step = 0, total = 0;
  for (long long base = 0; base < items; base += RING) {
#pragma unroll
    for (int k = 0; k < RING; ++k) {
      if (base + k >= items) break;
      const Words<NB> x = ring[k];
      if (base + k + RING < items) {
        ring[k] = ld_stream<NB>(src + lrow * chunk + lstep * STEP);
        if (++lstep == steps) { lstep = 0; lrow += warps; }
      }

      const int at = step * STEP + (int)lane * E;  // in the row
      const size_t first = (size_t)row * chunk + at;
      Words<E> a = {};
      Words<E / 2> codes = {};
      unsigned esc = 0;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const unsigned xi = element<T>(x, i);
        const unsigned e = (xi >> MBITS) & EMASK;
        const unsigned c = s_lut[e];
        a.w[i / 4] |= (((xi >> EBITS) & (1u << MBITS)) | (xi & MMASK))
                      << (8 * (i % 4));
        codes.w[i / 8] |= (c & 0xFu) << (4 * (i % 8));
        esc |= ((c >> 7) & 1u) << i;
      }
      st_stream<E>(sign_mantissa + first, a);
      st_stream<E / 2>(packed + first / 2, codes);

      if (__any_sync(FULL, esc)) {
        // exclusive scan of the lanes' counts, lane order == position order
        const int mine = __popc(esc);
        int rank = total;
#pragma unroll
        for (int b = 0; b < SCAN_BITS; ++b)
          rank += __popc(__ballot_sync(FULL, (mine >> b) & 1) & below) << b;
        total = __shfl_sync(FULL, rank + mine, 31);
        if (esc) {
          uint16_t* rpos = esc_pos + (size_t)row * cap;
          uint8_t* rval = esc_val + (size_t)row * cap;
#pragma unroll
          for (int i = 0; i < E; ++i) {
            if ((esc >> i) & 1u) {
              if (rank < cap) {
                rpos[rank] = (uint16_t)(at + i);
                rval[rank] = (uint8_t)((element<T>(x, i) >> MBITS) & EMASK);
              }
              ++rank;
            }
          }
        }
      }

      if (++step == steps) {  // the row is done: padding and count
        const int lo = min(total, cap);
        pad_slots(esc_pos + (size_t)row * cap, lo, cap,
                  (unsigned)chunk * 0x10001u, lane);
        pad_slots(esc_val + (size_t)row * cap, lo, cap, 0u, lane);
        if (lane == 0) esc_count[row] = total;
        total = 0;
        step = 0;
        row += warps;
      }
    }
  }
}

// The fused kernel for a format at 16 (wide) or 8 elements a lane.
template <int E>
const void* fused_kernel(int fmt) {
  return fmt == 0 ? (const void*)encode_fused_kernel<uint16_t, 7, 8, E>
       : fmt == 1 ? (const void*)encode_fused_kernel<uint8_t, 2, 5, E>
                  : (const void*)encode_fused_kernel<uint8_t, 3, 4, E>;
}

const void* fused_kernel_of(int fmt, int wide) {
  return wide ? fused_kernel<16>(fmt) : fused_kernel<8>(fmt);
}

template <int E>
void launch_fused_kernel(int fmt, int ctas, cudaStream_t s, const void* bits,
                         uint8_t* sm, uint8_t* pk, uint16_t* pos, uint8_t* val,
                         int32_t* cnt, long long rows, int chunk, int cap,
                         const EncodeLut& table) {
  switch (fmt) {
    case 0:
      encode_fused_kernel<uint16_t, 7, 8, E><<<ctas, FUSED_THREADS, 0, s>>>(
          static_cast<const uint16_t*>(bits), sm, pk, pos, val, cnt, rows,
          chunk, cap, table);
      break;
    case 1:
      encode_fused_kernel<uint8_t, 2, 5, E><<<ctas, FUSED_THREADS, 0, s>>>(
          static_cast<const uint8_t*>(bits), sm, pk, pos, val, cnt, rows,
          chunk, cap, table);
      break;
    default:
      encode_fused_kernel<uint8_t, 3, 4, E><<<ctas, FUSED_THREADS, 0, s>>>(
          static_cast<const uint8_t*>(bits), sm, pk, pos, val, cnt, rows,
          chunk, cap, table);
      break;
  }
}

int launch_encode_fused(int fmt, const void* bits, void* sign_mantissa,
                        void* packed, void* esc_pos, void* esc_val,
                        void* esc_count, long long rows, int chunk, int cap,
                        const void* lut, void* stream) {
  if (rows <= 0) return 0;
  if (chunk % 256 != 0 || chunk > 8192 || cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int ctas = 0;
  const int err = persistent_ctas(fused_kernel_of, fmt, rows, chunk, &ctas);
  if (err != 0) return err;
  EncodeLut table;
  memcpy(table.t, lut, sizeof(table.t));
  auto launch = lane_elems(chunk) == 16 ? &launch_fused_kernel<16>
                                        : &launch_fused_kernel<8>;
  launch(fmt, ctas, static_cast<cudaStream_t>(stream), bits,
         static_cast<uint8_t*>(sign_mantissa), static_cast<uint8_t*>(packed),
         static_cast<uint16_t*>(esc_pos), static_cast<uint8_t*>(esc_val),
         static_cast<int32_t*>(esc_count), rows, chunk, cap, table);
  return (int)cudaGetLastError();
}

int launch_encode_dense(int fmt, const void* bits, void* sign_mantissa,
                        void* packed, void* is_escape, long long rows,
                        int chunk, const void* lut, void* stream) {
  if (rows <= 0) return 0;
  if (chunk % 256 != 0 || chunk > 8192) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeLut table;
  memcpy(table.t, lut, sizeof(table.t));
  const dim3 grid((unsigned)rows), block((unsigned)(chunk / 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* sm = static_cast<uint8_t*>(sign_mantissa);
  uint8_t* pk = static_cast<uint8_t*>(packed);
  uint8_t* esc = static_cast<uint8_t*>(is_escape);
  switch (fmt) {
    case 0:
      encode_dense_kernel<uint16_t, 7, 8><<<grid, block, 0, s>>>(
          static_cast<const uint16_t*>(bits), sm, pk, esc, chunk, table);
      break;
    case 1:
      encode_dense_kernel<uint8_t, 2, 5><<<grid, block, 0, s>>>(
          static_cast<const uint8_t*>(bits), sm, pk, esc, chunk, table);
      break;
    case 2:
      encode_dense_kernel<uint8_t, 3, 4><<<grid, block, 0, s>>>(
          static_cast<const uint8_t*>(bits), sm, pk, esc, chunk, table);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = bf16, 1 = fp8_e5m2, 2 = fp8_e4m3.  Every pointer is device memory
// except ``lut`` (256 host bytes); esc_pos and esc_val are 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int sz_encode_fused(int fmt, const void* bits, void* sign_mantissa,
                               void* packed, void* esc_pos, void* esc_val,
                               void* esc_count, long long rows, int chunk,
                               int cap, const void* lut, void* stream) {
  return launch_encode_fused(fmt, bits, sign_mantissa, packed, esc_pos,
                             esc_val, esc_count, rows, chunk, cap, lut,
                             stream);
}

// The CTAs (of 8 warps) sz_encode_fused launches for ``rows`` rows of
// ``chunk`` on the current device, into ``*ctas``.  Returns a cudaError_t.
extern "C" int sz_encode_fused_grid(int fmt, long long rows, int chunk,
                                    int* ctas) {
  return persistent_ctas(fused_kernel_of, fmt, rows, chunk, ctas);
}

extern "C" int sz_encode_dense(int fmt, const void* bits, void* sign_mantissa,
                               void* packed, void* is_escape, long long rows,
                               int chunk, const void* lut, void* stream) {
  return launch_encode_dense(fmt, bits, sign_mantissa, packed, is_escape,
                             rows, chunk, lut, stream);
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
