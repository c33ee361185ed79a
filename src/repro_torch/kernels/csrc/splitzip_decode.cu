// SplitZip decode kernels for Hopper (sm_90a): fused and dense.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/splitzip_decode.py:
//   sz_decode_fused  <- decode_fused (_decode_fused_kernel)
//   sz_decode_dense  <- decode_dense (_decode_kernel)
//
// What it computes, per 1024-element row (one escape chunk):
//   bits = sign << (BITS-1) | codebook[code] << MBITS | mantissa
// from the nibble-packed codes and the sign-mantissa bytes; the fused kernel
// then overwrites the exponent field at the row's escape slots j < count, in
// slot order, skipping padding slots (pos >= chunk).  The dense kernel leaves
// escaped exponents at code 0's value (the correction runs outside).
//
// Bound: memory traffic.  bf16 reads 1.5 B/element of dense streams plus
// 3 B per applied escape and 4 B of count per row, and writes 2 B/element;
// the arithmetic is a table lookup and a few shifts per element.  The design:
//   * one CTA per row, chunk/8 threads, each thread on 8 contiguous
//     elements: a 4-byte code load, an 8-byte sign-mantissa load and one
//     16-byte store (bf16);
//   * the 16-entry decode table lives in shared memory, copied from the
//     launch parameters, instead of the TPU kernel's one-hot select chain;
//   * a row without escapes (the common case) stores straight from
//     registers; a row with escapes is assembled in shared memory, warp 0
//     applies its slots 32 at a time (slots of one round hit distinct
//     elements unless the buffer repeats a position, detected with
//     __match_any_sync, in which case that round runs in slot order), and
//     the row is stored coalesced — no per-slot pass over the whole row.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

struct DecodeLut {
  unsigned char t[16];  // code -> exponent
};

template <typename T>
__device__ __forceinline__ void store8(T* p, const unsigned (&y)[8]);

template <>
__device__ __forceinline__ void store8<uint16_t>(uint16_t* p,
                                                 const unsigned (&y)[8]) {
  uint4 v;
  v.x = y[0] | (y[1] << 16);
  v.y = y[2] | (y[3] << 16);
  v.z = y[4] | (y[5] << 16);
  v.w = y[6] | (y[7] << 16);
  *reinterpret_cast<uint4*>(p) = v;
}

template <>
__device__ __forceinline__ void store8<uint8_t>(uint8_t* p,
                                                const unsigned (&y)[8]) {
  uint2 v;
  v.x = y[0] | (y[1] << 8) | (y[2] << 16) | (y[3] << 24);
  v.y = y[4] | (y[5] << 8) | (y[6] << 16) | (y[7] << 24);
  *reinterpret_cast<uint2*>(p) = v;
}

template <typename T, int MBITS, int EBITS, bool FUSED>
__global__ void decode_kernel(const uint8_t* __restrict__ packed,
                              const uint8_t* __restrict__ sign_mantissa,
                              const uint16_t* __restrict__ esc_pos,
                              const uint8_t* __restrict__ esc_val,
                              const int32_t* __restrict__ esc_count,
                              T* __restrict__ out, int chunk, int cap,
                              DecodeLut lut) {
  constexpr int BITS = 8 * sizeof(T);
  constexpr unsigned CMASK = (1u << BITS) - 1u;
  constexpr unsigned MMASK = (1u << MBITS) - 1u;
  constexpr unsigned KEEP = CMASK ^ (((1u << EBITS) - 1u) << MBITS);
  __shared__ unsigned char s_dec[16];
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s_row = reinterpret_cast<T*>(s_raw);

  const int t = threadIdx.x;
  if (t < 16) s_dec[t] = lut.t[t];
  __syncthreads();

  const size_t row = blockIdx.x;
  const size_t first = row * (size_t)chunk + 8 * (size_t)t;
  const unsigned codes = __ldg(reinterpret_cast<const unsigned*>(packed + first / 2));
  const uint2 av = __ldg(reinterpret_cast<const uint2*>(sign_mantissa + first));
  unsigned y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned a = ((i < 4 ? av.x : av.y) >> (8 * (i & 3))) & 0xFFu;
    const unsigned e = s_dec[(codes >> (4 * i)) & 0xFu];
    const unsigned sign = (a >> MBITS) & 1u;
    y[i] = ((sign << (BITS - 1)) | (e << MBITS) | (a & MMASK)) & CMASK;
  }

  int n = 0;
  if (FUSED) n = min(max(esc_count[row], 0), cap);  // uniform over the CTA
  if (n == 0) {
    store8<T>(out + first, y);
    return;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) s_row[8 * t + i] = (T)y[i];
  __syncthreads();
  if (t < 32) {
    const uint16_t* rpos = esc_pos + row * (size_t)cap;
    const uint8_t* rval = esc_val + row * (size_t)cap;
    for (int base = 0; base < n; base += 32) {
      const int j = base + t;
      unsigned pos = (unsigned)chunk, val = 0;
      if (j < n) {
        pos = rpos[j];
        val = rval[j];
      }
      const bool valid = pos < (unsigned)chunk;
      const unsigned peers = __match_any_sync(FULL, valid ? pos : 0xFFFFFFFFu);
      const bool repeated = valid && __popc(peers) > 1;
      if (__any_sync(FULL, repeated)) {
        // a position repeats within this round: apply it in slot order
        for (int k = 0; k < 32; ++k) {
          const unsigned p = __shfl_sync(FULL, pos, k);
          const unsigned v = __shfl_sync(FULL, val, k);
          if (t == 0 && p < (unsigned)chunk)
            s_row[p] = (T)(((s_row[p] & KEEP) | (v << MBITS)) & CMASK);
        }
      } else if (valid) {
        s_row[pos] = (T)(((s_row[pos] & KEEP) | (val << MBITS)) & CMASK);
      }
      __syncwarp();
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = s_row[8 * t + i];
  store8<T>(out + first, y);
}

template <bool FUSED>
int launch_decode(int fmt, const void* packed, const void* sign_mantissa,
                  const void* esc_pos, const void* esc_val,
                  const void* esc_count, void* out, long long rows, int chunk,
                  int cap, const void* lut, void* stream) {
  if (rows <= 0) return 0;
  if (chunk % 256 != 0 || chunk > 8192 || (FUSED && cap < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeLut table;
  memcpy(table.t, lut, sizeof(table.t));
  const dim3 grid((unsigned)rows), block((unsigned)(chunk / 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const uint8_t* sm = static_cast<const uint8_t*>(sign_mantissa);
  const uint16_t* pos = static_cast<const uint16_t*>(esc_pos);
  const uint8_t* val = static_cast<const uint8_t*>(esc_val);
  const int32_t* cnt = static_cast<const int32_t*>(esc_count);
  switch (fmt) {
    case 0:
      decode_kernel<uint16_t, 7, 8, FUSED>
          <<<grid, block, FUSED ? chunk * 2 : 0, s>>>(
              pk, sm, pos, val, cnt, static_cast<uint16_t*>(out), chunk, cap,
              table);
      break;
    case 1:
      decode_kernel<uint8_t, 2, 5, FUSED><<<grid, block, FUSED ? chunk : 0, s>>>(
          pk, sm, pos, val, cnt, static_cast<uint8_t*>(out), chunk, cap, table);
      break;
    case 2:
      decode_kernel<uint8_t, 3, 4, FUSED><<<grid, block, FUSED ? chunk : 0, s>>>(
          pk, sm, pos, val, cnt, static_cast<uint8_t*>(out), chunk, cap, table);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fmt: 0 = bf16, 1 = fp8_e5m2, 2 = fp8_e4m3.  Every pointer is device memory
// except ``lut`` (16 host bytes).  Returns the cudaError_t of the launch.
extern "C" int sz_decode_fused(int fmt, const void* packed,
                               const void* sign_mantissa, const void* esc_pos,
                               const void* esc_val, const void* esc_count,
                               void* out, long long rows, int chunk, int cap,
                               const void* lut, void* stream) {
  return launch_decode<true>(fmt, packed, sign_mantissa, esc_pos, esc_val,
                             esc_count, out, rows, chunk, cap, lut, stream);
}

extern "C" int sz_decode_dense(int fmt, const void* packed,
                               const void* sign_mantissa, void* out,
                               long long rows, int chunk, const void* lut,
                               void* stream) {
  return launch_decode<false>(fmt, packed, sign_mantissa, nullptr, nullptr,
                              nullptr, out, rows, chunk, 0, lut, stream);
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
