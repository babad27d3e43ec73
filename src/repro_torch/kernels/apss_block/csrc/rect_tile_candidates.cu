// K4: live-tile worklist kernel of query-time serving -- per rectangular
// tile (query block qi, corpus block cj) of a (2, T) or (3, T) worklist, the
// forward candidate packet of the tile's query rows.
//
// Replaces src/repro/kernels/apss_block/fused.py::rect_tile_candidates_pallas
// (_rect_cand_kernel, _rect_tile_packets).
//
// Design. One thread block per worklist entry t; it reads ij[:, t] itself
// (the TPU kernel got it by scalar prefetch) and runs rect_tile_packet
// (apss_common.cuh): the block_q x block_c f32 tile of Q[qi] . C[cj]^T,
// scored by plain FMA in strips of 16-64 query rows by 64 corpus rows, stays
// in dynamic shared memory (at most 128 KB at 128 x 256); then one warp per
// query row keeps s >= t and gcol < nc_valid and selects its top-k by
// (value desc, id asc). Rows 0 and 1 of the worklist address the operands;
// the packet's column ids and validity come from the LAST row (a (3, T)
// worklist carries global block ids there while row 1 holds local ones).
// No TF32, no tensor cores: sums are f32 FMA in the chunked order of
// apss_common.cuh (partials over FK features, each in increasing feature
// order, added in increasing chunk order), the order K5 shares.
//
// Bound: at serving batches (8-128 query rows) a tile does 2 * block_q FLOP
// per 4-byte corpus element it reads, so a batch of one query block is
// bound by reading the live corpus blocks (block_q = 8: 4 FLOP/byte
// against the card's 20) and turns operation-bound near block_q = 40. One
// thread block per tile fills only as many SMs as the batch has live tiles
// (27 for one query block of a 6912-row corpus at block_c = 256), so the
// kernel runs far from either bound there; splitting a tile over more SMs
// is queued design work (ROADMAP); K5 spreads its tiles over every SM.
#include "apss_common.cuh"

namespace apss {

template <typename T>
__global__ void __launch_bounds__(THREADS)
rect_tile_candidates_kernel(const T* __restrict__ Q, const T* __restrict__ C,
                            const int* __restrict__ ij, int ij_rows, int n_tiles,
                            float* __restrict__ fv, int* __restrict__ fi, int* __restrict__ fc,
                            int m, int block_q, int block_c, int nc_valid, float threshold,
                            int k) {
  __shared__ __align__(16) Staged st;
  extern __shared__ __align__(16) float dyn[];
  const int t = blockIdx.x;
  const int qi = ij[t], cj = ij[n_tiles + t], gj = ij[(ij_rows - 1) * n_tiles + t];
  const long long row = (long long)t * block_q;
  rect_tile_packet(Q + (long long)qi * block_q * m, C + (long long)cj * block_c * m, m,
                   block_q, block_c, gj * block_c, nc_valid, threshold, k, st, dyn,
                   fv + row * k, fi + row * k, fc + row);
}

template <typename T>
int launch(const void* Q, const void* C, const void* ij, int ij_rows, int n_tiles, void* fv,
           void* fi, void* fc, int m, int block_q, int block_c, int nc_valid, float threshold,
           int k, void* stream) {
  if (block_q % 8 || block_q < 8 || block_q > MAX_QBLOCK || block_c % TILE ||
      block_c > MAX_BLOCK || m % TK || m < TK || k < 1 || n_tiles < 1 ||
      (ij_rows != 2 && ij_rows != 3))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * block_q * block_c;
  auto kernel = rect_tile_candidates_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Q), static_cast<const T*>(C), static_cast<const int*>(ij), ij_rows,
      n_tiles, static_cast<float*>(fv), static_cast<int*>(fi), static_cast<int*>(fc), m,
      block_q, block_c, nc_valid, threshold, k);
  return cudaGetLastError();
}

}  // namespace apss

// Q (nq, m) and C (nc, m) row-major, one dtype; ij (ij_rows, n_tiles) int32;
// fv/fi (n_tiles, block_q, k), fc (n_tiles, block_q). Returns a cudaError_t.
extern "C" int apss_rect_tile_candidates_f32(const void* Q, const void* C, const void* ij,
                                             int ij_rows, int n_tiles, void* fv, void* fi,
                                             void* fc, int m, int block_q, int block_c,
                                             int nc_valid, float threshold, int k,
                                             void* stream) {
  return apss::launch<float>(Q, C, ij, ij_rows, n_tiles, fv, fi, fc, m, block_q, block_c,
                             nc_valid, threshold, k, stream);
}

extern "C" int apss_rect_tile_candidates_bf16(const void* Q, const void* C, const void* ij,
                                              int ij_rows, int n_tiles, void* fv, void* fi,
                                              void* fc, int m, int block_q, int block_c,
                                              int nc_valid, float threshold, int k,
                                              void* stream) {
  return apss::launch<uint16_t>(Q, C, ij, ij_rows, n_tiles, fv, fi, fc, m, block_q, block_c,
                                nc_valid, threshold, k, stream);
}
