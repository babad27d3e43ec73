// K6: CSR tile kernel of query-time serving -- per rectangular tile (query
// block qi, corpus block cj) of a (2, T) worklist, the tile scores
// qg[t] . bx[cj]^T over the corpus block's own support, then K4's forward
// packet for the tile's query rows.
//
// Replaces src/repro/kernels/apss_block/sparse.py::rect_sparse_tile_candidates_pallas
// (_rect_sparse_tile_kernel).
//
// Operands, as on the TPU: bx (nb, block_c, S) holds each corpus block
// densified onto its sorted support bdims[cj] (built once, in the index);
// qg (T, block_q, S) holds, for worklist entry t, the query block's
// components at bdims[ij[1, t]] (a plain torch gather outside the kernel, as
// the reference gathers in XLA; the sentinel dimension m gathers 0). The
// product over S is exact: every nonzero of the corpus block lies in its
// support, and query components outside it multiply stored zeros.
//
// Design. K4's: one thread block per worklist entry t reads ij[1, t] and
// runs rect_tile_packet (apss_common.cuh) with x = qg[t] and y = bx[cj] at
// row stride S: the block_q x block_c tile in dynamic shared memory, scored
// by f32 FMA over the support in the chunked order of apss_common.cuh
// (K4's), then one warp per query row selects by (value desc, id asc).
//
// Bound: 2 * block_q * block_c * S FLOP per tile against 4 * (block_q +
// block_c) * S bytes of operands: about block_q / 2 FLOP per byte of bx,
// under the card's ridge of about 20 until block_q nears 40, so a batch of
// small query blocks is bound by reading bx and qg. One thread block per
// tile, as K4.
#include "apss_common.cuh"

namespace apss {

template <typename T>
__global__ void __launch_bounds__(THREADS)
rect_sparse_tile_candidates_kernel(const T* __restrict__ qg, const T* __restrict__ bx,
                                   const int* __restrict__ ij, int n_tiles,
                                   float* __restrict__ fv, int* __restrict__ fi,
                                   int* __restrict__ fc, int S, int block_q, int block_c,
                                   int nc_valid, float threshold, int k) {
  __shared__ __align__(16) Staged st;
  extern __shared__ __align__(16) float dyn[];
  const int t = blockIdx.x;
  const int cj = ij[n_tiles + t];
  const long long row = (long long)t * block_q;
  rect_tile_packet(qg + row * S, bx + (long long)cj * block_c * S, S, block_q, block_c,
                   cj * block_c, nc_valid, threshold, k, st, dyn, fv + row * k, fi + row * k,
                   fc + row);
}

template <typename T>
int launch(const void* qg, const void* bx, const void* ij, int n_tiles, void* fv, void* fi,
           void* fc, int S, int block_q, int block_c, int nc_valid, float threshold, int k,
           void* stream) {
  if (block_q % 8 || block_q < 8 || block_q > MAX_QBLOCK || block_c % TILE ||
      block_c > MAX_BLOCK || S % TK || S < TK || k < 1 || n_tiles < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * block_q * block_c;
  auto kernel = rect_sparse_tile_candidates_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qg), static_cast<const T*>(bx), static_cast<const int*>(ij),
      n_tiles, static_cast<float*>(fv), static_cast<int*>(fi), static_cast<int*>(fc), S,
      block_q, block_c, nc_valid, threshold, k);
  return cudaGetLastError();
}

}  // namespace apss

// qg (n_tiles, block_q, S) and bx (nb, block_c, S) row-major, one dtype; ij
// (2, n_tiles) int32; fv/fi (n_tiles, block_q, k), fc (n_tiles, block_q).
// Returns a cudaError_t code.
extern "C" int apss_rect_sparse_tile_candidates_f32(const void* qg, const void* bx,
                                                    const void* ij, int n_tiles, void* fv,
                                                    void* fi, void* fc, int S, int block_q,
                                                    int block_c, int nc_valid, float threshold,
                                                    int k, void* stream) {
  return apss::launch<float>(qg, bx, ij, n_tiles, fv, fi, fc, S, block_q, block_c, nc_valid,
                             threshold, k, stream);
}

extern "C" int apss_rect_sparse_tile_candidates_bf16(const void* qg, const void* bx,
                                                     const void* ij, int n_tiles, void* fv,
                                                     void* fi, void* fc, int S, int block_q,
                                                     int block_c, int nc_valid,
                                                     float threshold, int k, void* stream) {
  return apss::launch<uint16_t>(qg, bx, ij, n_tiles, fv, fi, fc, S, block_q, block_c,
                                nc_valid, threshold, k, stream);
}
