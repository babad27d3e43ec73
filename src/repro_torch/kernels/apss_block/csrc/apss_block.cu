// K7: thresholded dense score matrix -- out = where(X . Y^T >= t & live,
// X . Y^T, 0), with the product skipped on tiles the block mask declares
// dead.
//
// Replaces src/repro/kernels/apss_block/apss_block.py::apss_block_pallas
// (_apss_block_kernel).
//
// Design. The TPU kernel walks an (i, j, kf) grid with a VMEM accumulator
// and writes each block_m x block_n output tile once, at the last feature
// step. Here one thread block owns one 64 x 64 output sub-tile: it reads
// the caller's mask at (row / block_m, col / block_n) (the mask keeps its
// meaning at the caller's granularity), computes the sub-tile with
// score_tile (apss_common.cuh: f32 FMA in feature order, no TF32) when the
// tile is live, and writes where(acc >= t, acc, 0) once. A dead tile still
// writes its zeros: the wrapper allocates the output uninitialised, as the
// Pallas kernel writes o_ref for every tile. bf16 inputs are widened
// exactly to f32.
//
// Bound: float32 FMA on live tiles (2 m FLOP per score), plus writing the
// n_rows x n_cols f32 output once.
#include "apss_common.cuh"

namespace apss {

template <typename T>
__global__ void __launch_bounds__(THREADS)
apss_block_kernel(const T* __restrict__ x, const T* __restrict__ y, const int* __restrict__ mask,
                  float* __restrict__ out, int n_cols, int m, int mask_cols, int block_m,
                  int block_n, float threshold) {
  __shared__ __align__(16) Staged st;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool live = mask[(long long)(row0 / block_m) * mask_cols + col0 / block_n] != 0;
  float acc[4][4] = {};
  if (live) {  // the same for every thread of the block
    score_tile(x + (long long)row0 * m, y + (long long)col0 * m, m, st, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = live && acc[i][j] >= threshold ? acc[i][j] : 0.f;
    *reinterpret_cast<float4*>(&out[(long long)(row0 + ty * 4 + i) * n_cols + col0 + tx * 4]) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* mask, void* out, int n_rows, int n_cols,
           int m, int block_m, int block_n, float threshold, void* stream) {
  if (n_rows % block_m || n_cols % block_n || block_m % TILE || block_n % TILE || m % TK ||
      n_rows / TILE > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(n_cols / TILE, n_rows / TILE);
  apss_block_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const int*>(mask),
      static_cast<float*>(out), n_cols, m, n_cols / block_n, block_m, block_n, threshold);
  return cudaGetLastError();
}

}  // namespace apss

// x (n_rows, m), y (n_cols, m) row-major; mask (n_rows/block_m, n_cols/block_n)
// int32; out (n_rows, n_cols) f32. Returns a cudaError_t code.
extern "C" int apss_block_f32(const void* x, const void* y, const void* mask, void* out,
                              int n_rows, int n_cols, int m, int block_m, int block_n,
                              float threshold, void* stream) {
  return apss::launch<float>(x, y, mask, out, n_rows, n_cols, m, block_m, block_n, threshold,
                             stream);
}

extern "C" int apss_block_bf16(const void* x, const void* y, const void* mask, void* out,
                               int n_rows, int n_cols, int m, int block_m, int block_n,
                               float threshold, void* stream) {
  return apss::launch<uint16_t>(x, y, mask, out, n_rows, n_cols, m, block_m, block_n,
                                threshold, stream);
}
