// K5: K4 with early exit -- the worklist is ordered by tile upper bound
// descending, and a tile is skipped when every valid query row of its block
// already holds k values that strictly beat the tile's bound ub[t].
//
// Replaces src/repro/kernels/apss_block/fused.py::rect_tile_candidates_early_exit_pallas
// (_rect_ee_cand_kernel).
//
// Design. On the TPU the grid walks the worklist in order on one core and
// carries a running per-row values buffer (nq, k) in VMEM. A tile's skip
// test reads only the rows of its own query block, so here one thread block
// owns one query block: it walks the whole worklist in order, takes the
// entries of its block, and keeps that block's values buffer (block_q, k)
// in shared memory beside the block_q x block_c score tile. Per entry:
//   - skip when ub[t] is a padding bound (<= -0.25e30), or when no valid
//     row (global row < nq_valid; padded rows never pin a block) has a k-th
//     value <= ub[t]. The test is strict (k-th > ub): the port orders ties
//     by (value desc, id asc), so a skipped tile holding a candidate equal
//     to a row's k-th value with a lower id would change the result under
//     the TPU's `k-th >= ub`. A skipped tile writes the neutral packet
//     (NEG_LARGE, -1, 0) and skipped[t] = 1;
//   - otherwise rect_tile_packet (apss_common.cuh) scores the tile and
//     writes K4's packet, and each row's selected values are merged into the
//     buffer (merge_values); skipped[t] = 0.
// Values and ids after the fold equal K4's; counts past k are lost for
// skipped tiles, and the caller saturates them at k.
//
// Bound: K4's bytes and operations for the tiles this run scores. With one
// thread block per query block, a serving batch of one block runs on one
// SM: the kernel is bound by that SM's FMA rate, not the card's. Keeping the
// TPU's skip decisions while using more SMs (split each tile over a
// cluster) is queued design work (ROADMAP).
#include "apss_common.cuh"

namespace apss {

template <typename T>
__global__ void __launch_bounds__(THREADS)
rect_ee_kernel(const T* __restrict__ Q, const T* __restrict__ C, const int* __restrict__ ij,
               const float* __restrict__ ub, int n_tiles, float* __restrict__ fv,
               int* __restrict__ fi, int* __restrict__ fc, int* __restrict__ skipped, int m,
               int block_q, int block_c, int nc_valid, int nq_valid, float threshold, int k) {
  __shared__ __align__(16) Staged st;
  extern __shared__ __align__(16) float dyn[];
  float* s = dyn;                         // (block_q, block_c) score tile
  float* topv = dyn + block_q * block_c;  // (block_q, k) running values
  const int qi = blockIdx.x;
  const int rows_valid = nq_valid - qi * block_q;
  for (int e = threadIdx.x; e < block_q * k; e += THREADS) topv[e] = NEG_LARGE;
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    if (ij[t] != qi) continue;  // uniform over the block
    const float u = ub[t];
    const int r = threadIdx.x;
    const bool pin = r < block_q && r < rows_valid && !(topv[r * k + k - 1] > u);
    const bool any_pin = __syncthreads_or(pin);
    const long long row = (long long)t * block_q;
    if (u <= VALID || !any_pin) {
      for (int e = threadIdx.x; e < block_q * k; e += THREADS) {
        fv[row * k + e] = NEG_LARGE;
        fi[row * k + e] = -1;
      }
      for (int e = threadIdx.x; e < block_q; e += THREADS) fc[row + e] = 0;
      if (threadIdx.x == 0) skipped[t] = 1;
      continue;
    }
    if (threadIdx.x == 0) skipped[t] = 0;
    const int cj = ij[n_tiles + t];
    rect_tile_packet(Q + (long long)qi * block_q * m, C + (long long)cj * block_c * m, m,
                     block_q, block_c, cj * block_c, nc_valid, threshold, k, st, s,
                     fv + row * k, fi + row * k, fc + row, topv);
  }
}

template <typename T>
int launch(const void* Q, const void* C, const void* ij, const void* ub, int n_tiles,
           int grid_q, void* fv, void* fi, void* fc, void* skipped, int m, int block_q,
           int block_c, int nc_valid, int nq_valid, float threshold, int k, void* stream) {
  if (block_q % 8 || block_q < 8 || block_q > MAX_QBLOCK || block_c % TILE ||
      block_c > MAX_BLOCK || m % TK || m < TK || k < 1 || k > MAX_EE_K || n_tiles < 1 ||
      grid_q < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * block_q * (block_c + k);
  auto kernel = rect_ee_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_q, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Q), static_cast<const T*>(C), static_cast<const int*>(ij),
      static_cast<const float*>(ub), n_tiles, static_cast<float*>(fv), static_cast<int*>(fi),
      static_cast<int*>(fc), static_cast<int*>(skipped), m, block_q, block_c, nc_valid,
      nq_valid, threshold, k);
  return cudaGetLastError();
}

}  // namespace apss

// Q (grid_q * block_q, m) and C (nc, m) row-major, one dtype; ij (2, n_tiles)
// int32; ub (n_tiles,) f32; fv/fi (n_tiles, block_q, k), fc (n_tiles,
// block_q), skipped (n_tiles,) int32. Returns a cudaError_t code.
extern "C" int apss_rect_tile_candidates_ee_f32(const void* Q, const void* C, const void* ij,
                                                const void* ub, int n_tiles, int grid_q,
                                                void* fv, void* fi, void* fc, void* skipped,
                                                int m, int block_q, int block_c, int nc_valid,
                                                int nq_valid, float threshold, int k,
                                                void* stream) {
  return apss::launch<float>(Q, C, ij, ub, n_tiles, grid_q, fv, fi, fc, skipped, m, block_q,
                             block_c, nc_valid, nq_valid, threshold, k, stream);
}

extern "C" int apss_rect_tile_candidates_ee_bf16(const void* Q, const void* C, const void* ij,
                                                 const void* ub, int n_tiles, int grid_q,
                                                 void* fv, void* fi, void* fc, void* skipped,
                                                 int m, int block_q, int block_c, int nc_valid,
                                                 int nq_valid, float threshold, int k,
                                                 void* stream) {
  return apss::launch<uint16_t>(Q, C, ij, ub, n_tiles, grid_q, fv, fi, fc, skipped, m,
                                block_q, block_c, nc_valid, nq_valid, threshold, k, stream);
}
