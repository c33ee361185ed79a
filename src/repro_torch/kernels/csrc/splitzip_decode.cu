// SplitZip decode kernels for Hopper (sm_90a): fused and dense.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/splitzip_decode.py:
//   sz_decode_fused  <- decode_fused (_decode_fused_kernel)
//   sz_decode_dense  <- decode_dense (_decode_kernel)
//
// What it computes, per row of ``chunk`` elements (one escape chunk):
//   bits = sign << (BITS-1) | codebook[code] << MBITS | mantissa
// from the nibble-packed codes and the sign-mantissa bytes; the fused kernel
// then overwrites the exponent field at the row's escape slots j < count, in
// slot order, skipping padding slots (pos >= chunk).  The dense kernel leaves
// escaped exponents at code 0's value (the correction runs outside).
//
// Bound: memory traffic.  bf16 reads 1.5 B/element of dense streams (plus,
// fused, 3 B per applied escape and 4 B of count per row) and writes
// 2 B/element; the arithmetic is a table lookup and a few shifts per
// element.  The 16-entry decode table lives in shared memory, copied from
// the launch parameters, instead of the TPU kernel's one-hot select chain.
//
// Both are one kernel, ``decode_kernel``, with the escapes a compile-time
// switch (FUSED): a persistent grid (as many 256-thread CTAs as fit on the
// card, no more than the rows need; the table copied once a CTA) in which
// each warp decodes whole rows, w, w + W, ... for warp w of W, in steps of
// 32 * E elements, E contiguous ones a lane: E = 16 where the chunk is a
// multiple of 512 (bf16: an 8-byte code load, a 16-byte sign-mantissa load
// and two 16-byte stores a lane), else 8.  Each warp keeps the loads of its
// next 32 / E steps in flight in registers while it decodes the current one;
// loads bypass L1 and the output goes out as streaming stores.
//
// Fused only: a row's escape metadata comes in the same batch as its first
// step's streams: the count, and speculatively the first min(cap, 32) slots
// (lane j holds slot j), so no row waits on a dependent round trip; slots
// from 32 up are read only when the count says they exist.  Escapes are
// patched in registers: each slot j < count, in slot order, is broadcast by
// __shfl_sync and the lane that owns its position overwrites that element's
// exponent field, so a later slot overwrites an earlier one at a repeated
// position (slot order) with no shared-memory copy of the row and no
// barrier.  A row without escapes costs one test.  The dense kernel reads no
// escape buffer and carries no count or slot.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "codec_stream.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

struct DecodeLut {
  unsigned char t[16];  // code -> exponent
};

// ---------------------------------------------------------------------------
// the kernel: persistent, a warp per row
// ---------------------------------------------------------------------------

constexpr unsigned NO_SLOT = 0xFFFFu;        // a position no lane owns

// one step of a lane's loads; fused: ``count``/``slot`` only on a row's
// first step
template <int E, bool FUSED>
struct Item {
  Words<E / 2> codes;
  Words<E> am;
  int count;
  unsigned slot;  // pos | val << 16 of slot ``lane``
};

template <int E>
struct Item<E, false> {
  Words<E / 2> codes;
  Words<E> am;
};

// FUSED = false: the escape operands are not read (null, cap 0)
template <typename T, int MBITS, int EBITS, int E, bool FUSED>
__global__ void __launch_bounds__(FUSED_THREADS)
decode_kernel(const uint8_t* __restrict__ packed,
              const uint8_t* __restrict__ sign_mantissa,
              const uint16_t* __restrict__ esc_pos,
              const uint8_t* __restrict__ esc_val,
              const int32_t* __restrict__ esc_count,
              T* __restrict__ out, long long rows, int chunk, int cap,
              DecodeLut lut) {
  constexpr int BITS = 8 * sizeof(T);
  constexpr unsigned CMASK = (1u << BITS) - 1u;
  constexpr unsigned MMASK = (1u << MBITS) - 1u;
  constexpr unsigned KEEP = CMASK ^ (((1u << EBITS) - 1u) << MBITS);
  constexpr int STEP = 32 * E;
  constexpr int RING = ring_steps(E);
  __shared__ unsigned char s_dec[16];
  if (threadIdx.x < 16) s_dec[threadIdx.x] = lut.t[threadIdx.x];
  __syncthreads();

  const unsigned lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * FUSED_WARPS;
  const long long warp =
      (long long)blockIdx.x * FUSED_WARPS + (threadIdx.x >> 5);
  const int steps = chunk / STEP;
  const long long items =
      warp < rows ? ((rows - 1 - warp) / warps + 1) * steps : 0;
  const int prefetched = min(cap, 32);

  Item<E, FUSED> ring[RING];
  long long lrow = warp;  // the next item to load
  int lstep = 0;
  auto load = [&](Item<E, FUSED>& it) {
    const size_t first = (size_t)lrow * chunk + lstep * STEP + lane * E;
    it.codes = ld_stream<E / 2>(packed + first / 2);
    it.am = ld_stream<E>(sign_mantissa + first);
    if constexpr (FUSED) {
      it.count = 0;
      it.slot = NO_SLOT;
      if (lstep == 0) {
        it.count = __ldg(esc_count + lrow);
        if ((int)lane < prefetched) {
          const size_t j = (size_t)lrow * cap + lane;
          it.slot = __ldg(esc_pos + j) | ((unsigned)__ldg(esc_val + j) << 16);
        }
      }
    }
    if (++lstep == steps) { lstep = 0; lrow += warps; }
  };
#pragma unroll
  for (int k = 0; k < RING; ++k)
    if (k < items) load(ring[k]);

  long long row = warp;   // the item being decoded
  int step = 0, n = 0;
  unsigned slot0 = NO_SLOT;
  for (long long base = 0; base < items; base += RING) {
#pragma unroll
    for (int k = 0; k < RING; ++k) {
      if (base + k >= items) break;
      const Item<E, FUSED> it = ring[k];
      if (base + k + RING < items) load(ring[k]);

      if constexpr (FUSED) {
        if (step == 0) {
          n = min(max(it.count, 0), cap);
          slot0 = it.slot;
        }
      }
      const int at = step * STEP + (int)lane * E;  // in the row
      unsigned y[E];
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const unsigned a = (it.am.w[i / 4] >> (8 * (i % 4))) & 0xFFu;
        const unsigned e = s_dec[(it.codes.w[i / 8] >> (4 * (i % 8))) & 0xFu];
        const unsigned sign = (a >> MBITS) & 1u;
        y[i] = ((sign << (BITS - 1)) | (e << MBITS) | (a & MMASK)) & CMASK;
      }

      // the row's escapes, in slot order, 32 slots a round
      if constexpr (FUSED) {
        for (int r0 = 0; r0 < n; r0 += 32) {
          unsigned s = slot0;
          if (r0 > 0) {
            const int j = r0 + (int)lane;
            s = NO_SLOT;
            if (j < n) {
              const size_t o = (size_t)row * cap + j;
              s = __ldg(esc_pos + o) | ((unsigned)__ldg(esc_val + o) << 16);
            }
          }
          const int m = min(32, n - r0);
          for (int k2 = 0; k2 < m; ++k2) {
            const unsigned w = __shfl_sync(FULL, s, k2);
            const unsigned rel = (w & 0xFFFFu) - (unsigned)at;
            if (rel < (unsigned)E) {
              const unsigned v = w >> 16;
#pragma unroll
              for (int i = 0; i < E; ++i)
                if ((unsigned)i == rel) y[i] = ((y[i] & KEEP) | (v << MBITS)) & CMASK;
            }
          }
        }
      }

      Words<E * sizeof(T)> o = {};
      constexpr int PER = 4 / sizeof(T);
#pragma unroll
      for (int i = 0; i < E; ++i)
        o.w[i / PER] |= y[i] << (BITS * (i % PER));
      st_stream<E * sizeof(T)>(out + (size_t)row * chunk + at, o);

      if (++step == steps) {
        step = 0;
        row += warps;
      }
    }
  }
}

// The kernel for a format at E elements a lane.
template <int E, bool FUSED>
const void* kernel_at(int fmt) {
  return fmt == 0 ? (const void*)decode_kernel<uint16_t, 7, 8, E, FUSED>
       : fmt == 1 ? (const void*)decode_kernel<uint8_t, 2, 5, E, FUSED>
                  : (const void*)decode_kernel<uint8_t, 3, 4, E, FUSED>;
}

// The fused or dense kernel for a format at 16 (wide) or 8 elements a lane.
template <bool FUSED>
const void* kernel_of(int fmt, int wide) {
  return wide ? kernel_at<16, FUSED>(fmt) : kernel_at<8, FUSED>(fmt);
}

// each kernel its own occupancy (persistent_ctas's ``kind``)
template <bool FUSED>
int decode_grid(int fmt, long long rows, int chunk, int* ctas) {
  return persistent_ctas(kernel_of<FUSED>, fmt, rows, chunk, ctas,
                         FUSED ? 0 : 1);
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
  int ctas = 0;
  const int err = decode_grid<FUSED>(fmt, rows, chunk, &ctas);
  if (err != 0) return err;
  DecodeLut table;
  memcpy(table.t, lut, sizeof(table.t));
  // decode_kernel's parameters, in order
  void* args[] = {&packed, &sign_mantissa, &esc_pos, &esc_val, &esc_count,
                  &out,    &rows,          &chunk,   &cap,     &table};
  return (int)cudaLaunchKernel(kernel_of<FUSED>(fmt, lane_elems(chunk) == 16),
                               dim3((unsigned)ctas), dim3(FUSED_THREADS), args,
                               0, static_cast<cudaStream_t>(stream));
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

// The CTAs (of 8 warps) sz_decode_fused / sz_decode_dense launches for
// ``rows`` rows of ``chunk`` on the current device, into ``*ctas``.
// Returns a cudaError_t.
extern "C" int sz_decode_fused_grid(int fmt, long long rows, int chunk,
                                    int* ctas) {
  return decode_grid<true>(fmt, rows, chunk, ctas);
}

extern "C" int sz_decode_dense_grid(int fmt, long long rows, int chunk,
                                    int* ctas) {
  return decode_grid<false>(fmt, rows, chunk, ctas);
}

// The CTAs of the fused (``fused`` != 0) or dense kernel for ``chunk``
// that fit on one SM of the current device, asked anew, into ``*n``.
extern "C" int sz_decode_ctas_per_sm(int fused, int fmt, int chunk, int* n) {
  return ctas_per_sm(fused ? &kernel_of<true> : &kernel_of<false>, fmt,
                     chunk, n);
}

extern "C" const char* sz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
