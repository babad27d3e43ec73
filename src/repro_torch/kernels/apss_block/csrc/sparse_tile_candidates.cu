// K3: CSR tile kernel of the sparse self-join -- per upper-triangular tile
// (i, j) of a (2, T) worklist, the tile scores bx[i] . yg[t]^T over the
// row block's support, then a forward candidate packet for the rows of
// block i and a mirror packet for the rows of block j (S = S^T).
//
// Replaces src/repro/kernels/apss_block/sparse.py::sparse_tile_candidates_pallas
// (_sparse_tile_kernel, which reuses fused.py::_tile_packets).
//
// Operands, as on the TPU: bx (nb, bm, S) holds each row block densified
// onto its own sorted support; yg (T, bm, S) holds, for worklist entry t,
// the CSR rows of block ij[1, t] gathered onto the support of block
// ij[0, t] (a plain torch gather outside the kernel, as the reference
// gathers in XLA outside Pallas). The product over S is exact: every
// nonzero of block i lies in its support, and dimensions outside it add 0.
//
// Design. K2's: one thread block per worklist entry t reads ij[:, t] and
// runs tile_packets (apss_common.cuh) with x = bx[ij[0, t]] and
// y = yg[t] at row stride S: 64 x 64 sub-tiles scored by f32 FMA in support
// order into a (T, bm, bm) scratch buffer, then one warp per row (forward)
// and per column (mirror, ids = row ids, empty on a diagonal tile)
// selects by (value desc, id asc).
//
// Bound: float32 FMA over the support, 2 * bm * bm * S FLOP per tile
// against 8 * bm * S bytes of operands (S in the hundreds to the tens of
// thousands). The (T, bm, S) yg buffer is the largest device allocation of
// the path; gathering inside the kernel would remove it (ROADMAP).
#include "apss_common.cuh"

namespace apss {

template <typename T>
__global__ void __launch_bounds__(THREADS)
sparse_tile_candidates_kernel(const T* __restrict__ bx, const T* __restrict__ yg,
                              const int* __restrict__ ij, int n_tiles, float* scratch,
                              float* __restrict__ fv, int* __restrict__ fi, int* __restrict__ fc,
                              float* __restrict__ bv, int* __restrict__ bi,
                              int* __restrict__ bc, int S, int block_m, int n_valid,
                              float threshold, int k) {
  __shared__ __align__(16) Staged st;
  const int t = blockIdx.x;
  const int ib = ij[t], jb = ij[n_tiles + t];
  const long long block = (long long)block_m * S;
  tile_packets(bx + ib * block, yg + t * block, S, t, ib, jb, block_m, block_m, n_valid,
               threshold, k, st, scratch, fv, fi, fc, bv, bi, bc);
}

template <typename T>
int launch(const void* bx, const void* yg, const void* ij, int n_tiles, void* scratch,
           void* fv, void* fi, void* fc, void* bv, void* bi, void* bc, int S, int block_m,
           int n_valid, float threshold, int k, void* stream) {
  if (block_m % TILE || block_m > MAX_BLOCK || S % TK || S < TK || k < 1 || n_tiles < 1)
    return cudaErrorInvalidValue;
  sparse_tile_candidates_kernel<T><<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(bx), static_cast<const T*>(yg), static_cast<const int*>(ij),
      n_tiles, static_cast<float*>(scratch), static_cast<float*>(fv), static_cast<int*>(fi),
      static_cast<int*>(fc), static_cast<float*>(bv), static_cast<int*>(bi),
      static_cast<int*>(bc), S, block_m, n_valid, threshold, k);
  return cudaGetLastError();
}

}  // namespace apss

// bx (nb, block_m, S), yg (n_tiles, block_m, S) row-major; ij (2, n_tiles)
// int32; scratch (n_tiles, block_m, block_m) f32; fv/fi and bv/bi
// (n_tiles, block_m, k), fc and bc (n_tiles, block_m). Returns a cudaError_t.
extern "C" int apss_sparse_tile_candidates_f32(const void* bx, const void* yg, const void* ij,
                                               int n_tiles, void* scratch, void* fv, void* fi,
                                               void* fc, void* bv, void* bi, void* bc, int S,
                                               int block_m, int n_valid, float threshold, int k,
                                               void* stream) {
  return apss::launch<float>(bx, yg, ij, n_tiles, scratch, fv, fi, fc, bv, bi, bc, S, block_m,
                             n_valid, threshold, k, stream);
}

extern "C" int apss_sparse_tile_candidates_bf16(const void* bx, const void* yg, const void* ij,
                                                int n_tiles, void* scratch, void* fv, void* fi,
                                                void* fc, void* bv, void* bi, void* bc, int S,
                                                int block_m, int n_valid, float threshold,
                                                int k, void* stream) {
  return apss::launch<uint16_t>(bx, yg, ij, n_tiles, scratch, fv, fi, fc, bv, bi, bc, S,
                                block_m, n_valid, threshold, k, stream);
}
