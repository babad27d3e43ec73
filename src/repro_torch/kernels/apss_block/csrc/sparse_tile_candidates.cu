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
// Design. Two launches, as K4 and K6 run (rect_tiles.cuh):
//   1. sparse_part_kernel: one thread block per work item (worklist entry
//      t, IR-row part of block ij[0, t], IC-column part of block ij[1, t];
//      IR = IC = 128: 4 items a tile at bm = 256, 1 at bm = 128;
//      sparse.py::sparse_work_items). It runs ring_tile (apss_common.cuh)
//      on bx[ij[0, t]] and yg[t] at row stride S over all S features: a
//      4-stage cp.async ring, each of 256 threads owning 8 x IC / 16
//      scores, and writes the part into the (T, bm, bm) f32 scratch. The
//      stages and the item width were chosen by tools/kernel_ab.py k3_tile
//      (times in PERF.md). Each score is one fmaf chain from 0 in increasing
//      support order, the order of score_tile, so the packets keep the
//      bits of the one-block-per-tile kernel this replaced, and equal K2's
//      on a corpus whose every row block has the full feature range as its
//      support.
//   2. sparse_select_kernel: one thread block per worklist entry runs
//      tile_select (apss_common.cuh, K2's phase 2): one warp per tile row
//      selects the forward packet and one warp per tile column the mirror
//      packet (ids = row ids, empty on a diagonal tile), by (value desc, id
//      asc).
//
// Bound: float32 FMA over the support, 2 * bm * bm * S FLOP per tile
// against 8 * bm * S bytes of operands (S in the hundreds to the tens of
// thousands). The (T, bm, S) yg buffer is the largest device allocation of
// the path; gathering inside the kernel would remove it (ROADMAP).
#include "apss_common.cuh"

namespace apss {

constexpr int K3_IR = 128;  // rows of a work item: a part of block ij[0, t]
constexpr int K3_IC = 128;  // columns: a part of block ij[1, t]
constexpr int K3_RN = K3_IC / 16;  // columns a thread (16 threads along them)

constexpr int K3_STAGES = 4;  // ring stages (147,456 bytes of shared memory at f32)

template <typename T>
using SparseRing = Ring<K3_IR, K3_IC, K3_STAGES, T, T>;

// Phase 1: the scores of one work item into scratch (T, block_m, block_m).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
sparse_part_kernel(const T* __restrict__ bx, const T* __restrict__ yg,
                   const int* __restrict__ ij, float* __restrict__ scratch, int S,
                   int block_m) {
  constexpr int TXN = K3_IC / K3_RN, TYN = K3_IR / 8;
  static_assert(TXN * TYN == THREADS, "a work item's scores cover the block's threads");
  extern __shared__ __align__(16) unsigned char ring[];
  const int parts_r = (block_m + K3_IR - 1) / K3_IR, parts_c = (block_m + K3_IC - 1) / K3_IC;
  const int t = blockIdx.x / (parts_r * parts_c), p = blockIdx.x % (parts_r * parts_c);
  const int r0 = (p / parts_c) * K3_IR, c0 = (p % parts_c) * K3_IC;
  const int x_rows = block_m - r0 < K3_IR ? block_m - r0 : K3_IR;
  const int y_rows = block_m - c0 < K3_IC ? block_m - c0 : K3_IC;
  const long long block = (long long)block_m * S;
  float acc[8][K3_RN];
  ring_tile<K3_IR, K3_IC, 8, K3_RN, K3_STAGES>(
      bx + ij[t] * block + (long long)r0 * S, x_rows, yg + t * block + (long long)c0 * S,
      y_rows, S, S, ring, acc);
  const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
  float* s = scratch + (long long)t * block_m * block_m + (long long)r0 * block_m + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + TYN * i;
    if (r < x_rows)
#pragma unroll
      for (int j = 0; j < K3_RN; ++j)
        if (tx + TXN * j < y_rows) s[(long long)r * block_m + tx + TXN * j] = acc[i][j];
  }
}

// Phase 2: one thread block per worklist entry selects both packets.
__global__ void __launch_bounds__(THREADS)
sparse_select_kernel(const float* __restrict__ scratch, const int* __restrict__ ij,
                     int n_tiles, float* __restrict__ fv, int* __restrict__ fi,
                     int* __restrict__ fc, float* __restrict__ bv, int* __restrict__ bi,
                     int* __restrict__ bc, int block_m, int n_valid, float threshold, int k) {
  const int t = blockIdx.x;
  tile_select(scratch + (long long)t * block_m * block_m, t, ij[t], ij[n_tiles + t], block_m,
              block_m, n_valid, threshold, k, fv, fi, fc, bv, bi, bc);
}

template <typename T>
int launch(const void* bx, const void* yg, const void* ij, int n_tiles, void* scratch,
           void* fv, void* fi, void* fc, void* bv, void* bi, void* bc, int S, int block_m,
           int n_valid, float threshold, int k, void* stream_) {
  if (block_m % TILE || block_m > MAX_BLOCK || S % PK || S < PK || k < 1 || n_tiles < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  using R = SparseRing<T>;
  auto part = sparse_part_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(part, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::BYTES);
  if (err != cudaSuccess) return err;
  const long long items = (long long)n_tiles * ((block_m + K3_IR - 1) / K3_IR) *
                          ((block_m + K3_IC - 1) / K3_IC);
  part<<<(unsigned)items, THREADS, R::BYTES, stream>>>(
      static_cast<const T*>(bx), static_cast<const T*>(yg), static_cast<const int*>(ij),
      static_cast<float*>(scratch), S, block_m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sparse_select_kernel<<<n_tiles, THREADS, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const int*>(ij), n_tiles,
      static_cast<float*>(fv), static_cast<int*>(fi), static_cast<int*>(fc),
      static_cast<float*>(bv), static_cast<int*>(bi), static_cast<int*>(bc), block_m, n_valid,
      threshold, k);
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
