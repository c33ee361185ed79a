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
// per element, far below the card's integer rate.  So the design spends
// nothing it does not have to on the memory side:
//   * one CTA per row, chunk/8 threads, each thread owning 8 contiguous
//     elements: one 16-byte load (bf16; 8 bytes for fp8) and 8/4-byte stores,
//     neighbouring threads on neighbouring addresses;
//   * the code lookup is a 256-entry (bf16) / 32- or 16-entry (fp8) byte table
//     in shared memory, copied from the launch parameters, instead of the TPU
//     kernel's 16 broadcast compares (bit 7 = escape flag, low nibble = code);
//   * escape ranks come from a block-wide exclusive scan: each thread's escape
//     count (0..8) is scanned within the warp by bit-sliced __ballot_sync /
//     __popc, warp totals meet in shared memory — no Hillis-Steele passes, no
//     per-slot masked reductions;
//   * every escape is written straight to its slot; the slot buffers are the
//     only scattered writes and are tiny (about 2 escapes per row at the
//     paper's escape rate).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

struct EncodeLut {
  unsigned char t[256];  // exponent -> code | 0x80 if the exponent escapes
};

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

template <typename T, int MBITS, int EBITS, bool FUSED>
__global__ void encode_kernel(const T* __restrict__ bits,
                              uint8_t* __restrict__ sign_mantissa,
                              uint8_t* __restrict__ packed,
                              uint16_t* __restrict__ esc_pos,
                              uint8_t* __restrict__ esc_val,
                              int32_t* __restrict__ esc_count,
                              uint8_t* __restrict__ is_escape,
                              int chunk, int cap, EncodeLut lut) {
  constexpr int NLUT = 1 << EBITS;
  constexpr unsigned EMASK = (1u << EBITS) - 1u;
  constexpr unsigned MMASK = (1u << MBITS) - 1u;
  __shared__ unsigned char s_lut[NLUT];
  __shared__ int s_warp[32];

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

  if (!FUSED) {
    unsigned flags[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) flags[i] = (esc_mask >> i) & 1u;
    *reinterpret_cast<uint2*>(is_escape + first) = pack_bytes8(flags);
    return;
  }

  // exclusive scan of the per-thread escape counts (0..8, four bits) in
  // thread order == position order: bit-sliced ballot + popc within the
  // warp, warp totals through shared memory
  const int mine = __popc(esc_mask);
  const unsigned lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  int before = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    before += __popc(__ballot_sync(FULL, (mine >> b) & 1) & below) << b;
  const int warp_total = __shfl_sync(FULL, before + mine, 31);
  if (lane == 0) s_warp[t >> 5] = warp_total;
  __syncthreads();
  int offset = 0, total = 0;
  const int warp = t >> 5;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int v = s_warp[w];
    offset += (w < warp) ? v : 0;
    total += v;
  }

  uint16_t* rpos = esc_pos + row * (size_t)cap;
  uint8_t* rval = esc_val + row * (size_t)cap;
  int rank = offset + before;
  while (esc_mask) {
    const int i = __ffs(esc_mask) - 1;
    esc_mask &= esc_mask - 1;
    if (rank < cap) {
      rpos[rank] = (uint16_t)(8 * t + i);
      rval[rank] = (uint8_t)e[i];
    }
    ++rank;
  }
  for (int j = min(total, cap) + t; j < cap; j += blockDim.x) {
    rpos[j] = (uint16_t)chunk;
    rval[j] = 0;
  }
  if (t == 0) esc_count[row] = total;
}

template <bool FUSED>
int launch_encode(int fmt, const void* bits, void* sign_mantissa, void* packed,
                  void* esc_pos, void* esc_val, void* esc_count, void* is_escape,
                  long long rows, int chunk, int cap, const void* lut,
                  void* stream) {
  if (rows <= 0) return 0;
  if (chunk % 256 != 0 || chunk > 8192 || (FUSED && cap < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeLut table;
  memcpy(table.t, lut, sizeof(table.t));
  const dim3 grid((unsigned)rows), block((unsigned)(chunk / 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* sm = static_cast<uint8_t*>(sign_mantissa);
  uint8_t* pk = static_cast<uint8_t*>(packed);
  uint16_t* pos = static_cast<uint16_t*>(esc_pos);
  uint8_t* val = static_cast<uint8_t*>(esc_val);
  int32_t* cnt = static_cast<int32_t*>(esc_count);
  uint8_t* esc = static_cast<uint8_t*>(is_escape);
  switch (fmt) {
    case 0:
      encode_kernel<uint16_t, 7, 8, FUSED><<<grid, block, 0, s>>>(
          static_cast<const uint16_t*>(bits), sm, pk, pos, val, cnt, esc,
          chunk, cap, table);
      break;
    case 1:
      encode_kernel<uint8_t, 2, 5, FUSED><<<grid, block, 0, s>>>(
          static_cast<const uint8_t*>(bits), sm, pk, pos, val, cnt, esc,
          chunk, cap, table);
      break;
    case 2:
      encode_kernel<uint8_t, 3, 4, FUSED><<<grid, block, 0, s>>>(
          static_cast<const uint8_t*>(bits), sm, pk, pos, val, cnt, esc,
          chunk, cap, table);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = bf16, 1 = fp8_e5m2, 2 = fp8_e4m3.  Every pointer is device memory
// except ``lut`` (256 host bytes).  Returns the cudaError_t of the launch.
extern "C" int sz_encode_fused(int fmt, const void* bits, void* sign_mantissa,
                               void* packed, void* esc_pos, void* esc_val,
                               void* esc_count, long long rows, int chunk,
                               int cap, const void* lut, void* stream) {
  return launch_encode<true>(fmt, bits, sign_mantissa, packed, esc_pos,
                             esc_val, esc_count, nullptr, rows, chunk, cap,
                             lut, stream);
}

extern "C" int sz_encode_dense(int fmt, const void* bits, void* sign_mantissa,
                               void* packed, void* is_escape, long long rows,
                               int chunk, const void* lut, void* stream) {
  return launch_encode<false>(fmt, bits, sign_mantissa, packed, nullptr,
                              nullptr, nullptr, is_escape, rows, chunk, 0,
                              lut, stream);
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
