// Shared pieces of the APSS self-join kernels for Hopper (sm_90a).
//
// score_tile: one 64 x 64 tile of X . Y^T in float32, by plain FMA in
//   registers. 256 threads each own a 4 x 4 block of the tile. Feature
//   chunks of 32 are staged in shared memory, transposed so that each
//   thread reads its 4 rows and 4 columns as two float4 loads per feature;
//   the next chunk is loaded from device memory into registers while the
//   current one is multiplied. Each score sums its products in increasing
//   feature order, one fmaf at a time. Inputs are float32 or bfloat16
//   (as raw 16-bit words, widened exactly to float32); the sum is float32.
//
// Top-k order: (value descending, global id ascending) -- the order the
//   reference's first-position max-extraction gives when column tiles are
//   scanned in ascending order. Empty slots are (NEG_LARGE, -1).
//
// Bound: both kernels are bound by float32 FMA throughput at the shapes of
//   the self-join (2 m FLOP per score against 8 bytes of input per row
//   pair, m in the hundreds to the hundred thousands); TF32 and the tensor
//   cores are not used, so the card's non-tensor f32 peak is the bound.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace apss {

constexpr int TILE = 64;           // rows and columns of one score tile
constexpr int TK = 32;             // feature chunk staged in shared memory
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 scores each
constexpr int WARPS = THREADS / 32;
constexpr int LDS = TILE + 4;      // padded row of a staged chunk (float4-aligned)
constexpr float NEG_LARGE = -0.5e30f;
constexpr float VALID = -0.25e30f; // values above this are real candidates
constexpr unsigned FULL = 0xffffffffu;

struct Staged {
  float a[TK * LDS];
  float b[TK * LDS];
};

// Four consecutive input values widened to float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {  // bfloat16 bits
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Rows [0, 64) of `src` (row stride m), features [k0, k0 + 32): each thread
// loads two float4s, 8 threads per row.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, long long m,
                                           int k0, float4 (&reg)[2]) {
  const int r = threadIdx.x >> 3, f = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) reg[h] = load4(src + (long long)(r + 32 * h) * m + k0 + f);
}

__device__ __forceinline__ void store_chunk(float* dst, const float4 (&reg)[2]) {
  const int r = threadIdx.x >> 3, f = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* d = dst + f * LDS + r + 32 * h;
    d[0] = reg[h].x;
    d[LDS] = reg[h].y;
    d[2 * LDS] = reg[h].z;
    d[3 * LDS] = reg[h].w;
  }
}

// acc[i][j] = X[ty*4 + i] . Y[tx*4 + j] for the 64 rows at x and at y
// (m a multiple of 32, both row blocks 16-byte aligned).
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ x, const T* __restrict__ y,
                                           long long m, Staged& st, float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float4 ra[2], rb[2];
  load_chunk(x, m, 0, ra);
  load_chunk(y, m, 0, rb);
  for (long long k0 = 0; k0 < m; k0 += TK) {
    __syncthreads();  // every thread is done reading the previous chunk
    store_chunk(st.a, ra);
    store_chunk(st.b, rb);
    __syncthreads();
    if (k0 + TK < m) {
      load_chunk(x, m, (int)(k0 + TK), ra);
      load_chunk(y, m, (int)(k0 + TK), rb);
    }
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&st.a[kk * LDS + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&st.b[kk * LDS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// (v, id) comes before (bv, bid) in the top-k order.
__device__ __forceinline__ bool before(float v, int id, float bv, int bid) {
  return v > bv || (v == bv && id < bid);
}

// Warp-wide first (v, id, pos) in the top-k order; every lane gets it.
__device__ __forceinline__ void warp_first(float& v, int& id, int& pos) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oid = __shfl_xor_sync(FULL, id, o);
    const int opos = __shfl_xor_sync(FULL, pos, o);
    if (before(ov, oid, v, id)) {
      v = ov;
      id = oid;
      pos = opos;
    }
  }
}

}  // namespace apss

// Message of a status code returned by the entry points.
extern "C" const char* apss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
