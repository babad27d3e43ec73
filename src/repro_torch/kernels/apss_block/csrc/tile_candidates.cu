// K2: live-tile worklist kernel of the self-join -- per upper-triangular
// tile (i, j) of a (2, T) worklist, a forward candidate packet for the rows
// of block i and a mirror packet for the rows of block j (S = S^T).
//
// Replaces src/repro/kernels/apss_block/fused.py::apss_tile_candidates_pallas
// (_tile_cand_kernel, _tile_packets).
//
// Design. One thread block per worklist entry t; it reads ij[:, t] itself
// (the TPU kernel got it by scalar prefetch) and runs tile_packets
// (apss_common.cuh) on row blocks ib and jb of D: phase 1 writes the
// block_m x block_n f32 score tile to a device scratch buffer, phase 2 selects
// the forward packet (one warp per row) and the mirror packet (one warp per
// column, empty on a diagonal tile). Bound: float32 FMA, as for K1.
#include "apss_common.cuh"

namespace apss {

template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_candidates_kernel(const T* __restrict__ D, const int* __restrict__ ij, int n_tiles,
                       float* scratch, float* __restrict__ fv, int* __restrict__ fi,
                       int* __restrict__ fc, float* __restrict__ bv, int* __restrict__ bi,
                       int* __restrict__ bc, int m, int block_m, int block_n, int n_valid,
                       float threshold, int k) {
  __shared__ __align__(16) Staged st;
  const int t = blockIdx.x;
  const int ib = ij[t], jb = ij[n_tiles + t];
  tile_packets(D + (long long)ib * block_m * m, D + (long long)jb * block_n * m, m, t, ib, jb,
               block_m, block_n, n_valid, threshold, k, st, scratch, fv, fi, fc, bv, bi, bc);
}

template <typename T>
int launch(const void* D, const void* ij, int n_tiles, void* scratch, void* fv, void* fi,
           void* fc, void* bv, void* bi, void* bc, int m, int block_m, int block_n,
           int n_valid, float threshold, int k, void* stream) {
  if (block_m % TILE || block_n % TILE || block_m > MAX_BLOCK || block_n > MAX_BLOCK ||
      m % TK || k < 1 || n_tiles < 1)
    return cudaErrorInvalidValue;
  tile_candidates_kernel<T><<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const int*>(ij), n_tiles,
      static_cast<float*>(scratch), static_cast<float*>(fv), static_cast<int*>(fi),
      static_cast<int*>(fc), static_cast<float*>(bv), static_cast<int*>(bi),
      static_cast<int*>(bc), m, block_m, block_n, n_valid, threshold, k);
  return cudaGetLastError();
}

}  // namespace apss

// D (n, m) row-major; ij (2, n_tiles) int32; scratch (n_tiles, block_m, block_n)
// f32; fv/fi (n_tiles, block_m, k), fc (n_tiles, block_m); bv/bi
// (n_tiles, block_n, k), bc (n_tiles, block_n). Returns a cudaError_t code.
extern "C" int apss_tile_candidates_f32(const void* D, const void* ij, int n_tiles,
                                        void* scratch, void* fv, void* fi, void* fc, void* bv,
                                        void* bi, void* bc, int m, int block_m, int block_n,
                                        int n_valid, float threshold, int k, void* stream) {
  return apss::launch<float>(D, ij, n_tiles, scratch, fv, fi, fc, bv, bi, bc, m, block_m,
                             block_n, n_valid, threshold, k, stream);
}

extern "C" int apss_tile_candidates_bf16(const void* D, const void* ij, int n_tiles,
                                         void* scratch, void* fv, void* fi, void* fc,
                                         void* bv, void* bi, void* bc, int m, int block_m,
                                         int block_n, int n_valid, float threshold, int k,
                                         void* stream) {
  return apss::launch<uint16_t>(D, ij, n_tiles, scratch, fv, fi, fc, bv, bi, bc, m, block_m,
                                block_n, n_valid, threshold, k, stream);
}
