// What the persistent codec kernels share (splitzip_encode.cu: the fused
// encode; splitzip_decode.cu: the fused and the dense decode): the grid's
// geometry and its size, and a lane's streaming loads and stores.  Each of the two sources includes it once and
// is its own library, so every static below is that library's own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FUSED_THREADS = 256;           // 8 warps a CTA
constexpr int FUSED_WARPS = FUSED_THREADS / 32;
constexpr int MAX_DEVICES = 64;

// E contiguous elements a lane owns a step (16 or 8): a warp takes 32 * E
// elements a step and loads 32 / E steps ahead
__host__ __device__ constexpr int lane_elems(int chunk) {
  return chunk % 512 == 0 ? 16 : 8;
}
__host__ __device__ constexpr int ring_steps(int e) { return 32 / e; }

// NB bytes as 32-bit words
template <int NB>
struct Words {
  unsigned w[NB / 4];
};

// a lane's NB contiguous bytes, read once: no L1 allocation
template <int NB>
__device__ __forceinline__ Words<NB> ld_stream(const void* p) {
  Words<NB> r;
  const char* c = static_cast<const char*>(p);
  if constexpr (NB >= 16) {
#pragma unroll
    for (int v = 0; v < NB / 16; ++v)
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(r.w[4 * v]), "=r"(r.w[4 * v + 1]),
                     "=r"(r.w[4 * v + 2]), "=r"(r.w[4 * v + 3])
                   : "l"(c + 16 * v));
  } else if constexpr (NB == 8) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                 : "=r"(r.w[0]), "=r"(r.w[1]) : "l"(c));
  } else {
    static_assert(NB == 4, "lane vectors are 4, 8 or 16n bytes");
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
                 : "=r"(r.w[0]) : "l"(c));
  }
  return r;
}

// a lane's NB contiguous bytes, written once: streaming stores
template <int NB>
__device__ __forceinline__ void st_stream(void* p, const Words<NB>& r) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int v = 0; v < NB / 16; ++v)
      __stcs(reinterpret_cast<uint4*>(p) + v,
             make_uint4(r.w[4 * v], r.w[4 * v + 1], r.w[4 * v + 2],
                        r.w[4 * v + 3]));
  } else if constexpr (NB == 8) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(r.w[0], r.w[1]));
  } else {
    static_assert(NB == 4, "lane vectors are 4, 8 or 16n bytes");
    __stcs(reinterpret_cast<unsigned*>(p), r.w[0]);
  }
}

// The persistent kernels a library may hold: each kind keeps its own
// occupancy (splitzip_decode.cu: 0 the fused kernel, 1 the dense one).
constexpr int MAX_KINDS = 2;

// CTAs of ``kernel_of(fmt, wide)`` that fit on one SM at once, into ``*n``:
// ``kernel_of(fmt, wide)`` is the kernel for format ``fmt`` at 16 (wide) or
// 8 elements a lane, the width ``chunk`` takes.  Not cached.
inline int ctas_per_sm(const void* (*kernel_of)(int, int), int fmt, int chunk,
                       int* n) {
  if (fmt < 0 || fmt > 2 || chunk % 256 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, kernel_of(fmt, lane_elems(chunk) == 16), FUSED_THREADS, 0);
}

// CTAs of a persistent grid of FUSED_THREADS-thread CTAs, a warp a row:
// as many as fit on the card at once, no more than ``rows`` need.  The
// occupancy query runs once per (kernel ``kind``, format, lane width,
// device) and is cached, so a launch itself queries nothing.
inline int persistent_ctas(const void* (*kernel_of)(int, int), int fmt,
                           long long rows, int chunk, int* ctas,
                           int kind = 0) {
  static int per_sm[MAX_KINDS][3][2][MAX_DEVICES], sms[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (kind < 0 || kind >= MAX_KINDS || fmt < 0 || fmt > 2 ||
      dev >= MAX_DEVICES || chunk % 256 != 0)
    return (int)cudaErrorInvalidValue;
  const int wide = lane_elems(chunk) == 16;
  int& fit = per_sm[kind][fmt][wide][dev];
  if (fit == 0) {
    int n = 0, m = 0;
    err = (cudaError_t)ctas_per_sm(kernel_of, fmt, chunk, &n);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    sms[dev] = m;
    fit = n;
  }
  const long long need = (rows + FUSED_WARPS - 1) / FUSED_WARPS;
  const long long full = (long long)fit * sms[dev];
  *ctas = (int)(need < full ? need : full);
  return 0;
}

}  // namespace
