// The two launches of the self-join worklist kernels K2 (dense row blocks
// of D) and K3 (row blocks densified onto their supports): per upper-
// triangular worklist entry t, tile (ij[0, t], ij[1, t]), the block_m x
// block_n scores of the tile's rows against its columns, then a forward
// candidate packet for its rows and a mirror packet for its columns
// (S = S^T). The two differ only in where entry t's column operand lies:
// K2 reads row block cols[t] = ij[1, t] of D (ld = m); K3 (cols = null)
// reads entry t of its gathered yg (T, block_m, S) (ld = S). The row
// operand is row block ij[0, t] of x for both, and both run one compiled
// kernel.
//
//   1. tile_part_kernel: one thread block per work item (worklist entry t,
//      an IR-row part of the tile's rows from r0, an IC-column part of its
//      columns from c0; IR = IC = 128: 4 items a tile at 256 x 256, 2 at
//      256 x 128, 1 at 128 x 128 or below; fused.py::tile_work_items). The
//      items of one tile are adjacent in launch order, so they meet its
//      operands in L2. Each runs ring_tile (apss_common.cuh) over all ld
//      features: a 3-stage cp.async ring (110,592 bytes of shared memory at
//      f32; 244 registers a thread, one block an SM), each of 256 threads
//      owning 8 x IC / 16 scores, and writes its part into the (T,
//      block_m, block_n) f32 scratch. Each score is one fmaf chain from 0
//      in increasing feature order, so K2's packets equal K3's on a corpus
//      whose every row block has the full feature range as its support, and
//      K2's scores equal K1's (apss_fused.cu, one ring_walk chain that
//      skips only chunks of exact zero products) bit for bit. The column block comes from a pointer, not a
//      template flag: with a flag, K3's instance compiled to 174 registers
//      and ran 7 % slower than this one on sparse_radikal_full (H100 SXM).
//      The stages and the item width were chosen by tools/kernel_ab.py
//      k2_tile and k3_tile (times in PERF.md): 3 stages beat 4 by 1.4 % on
//      K2's radikal cell and tie elsewhere, 128 x 64 items lose 7-12 %.
//   2. tile_select_kernel: one thread block per worklist entry runs
//      tile_select (apss_common.cuh): one warp per tile row selects the
//      forward packet and one warp per tile column the mirror packet (ids =
//      row ids, empty on a diagonal tile), by (value desc, id asc).
//
// A 256 x 256 tile of f32 scores (256 KB) does not fit a block's 227 KB of
// shared memory, so the tile goes through the scratch the wrapper
// allocates: written once, read twice (rows, then columns), mostly from L2,
// small next to the tile's 2 * block_m * block_n * ld FLOP.
#pragma once

#include "apss_common.cuh"

namespace apss {

constexpr int ITEM_R = 128;  // rows of a work item: a part of block ij[0, t]
constexpr int ITEM_C = 128;  // columns: a part of the tile's column block
constexpr int ITEM_RN = ITEM_C / 16;  // columns a thread (16 threads along them)
constexpr int ITEM_STAGES = 3;  // ring stages (110,592 bytes of shared memory at f32)

template <typename T>
using ItemRing = Ring<ITEM_R, ITEM_C, ITEM_STAGES, T, T>;

// Phase 1: the scores of one work item into scratch (T, block_m, block_n).
// Entry t's column operand is row block cols[t] of y, or entry t of y where
// cols is null.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
tile_part_kernel(const T* __restrict__ x, const T* __restrict__ y, const int* __restrict__ ij,
                 const int* __restrict__ cols, float* __restrict__ scratch, int ld,
                 int block_m, int block_n) {
  constexpr int TXN = ITEM_C / ITEM_RN, TYN = ITEM_R / 8;
  static_assert(TXN * TYN == THREADS, "a work item's scores cover the block's threads");
  extern __shared__ __align__(16) unsigned char ring[];
  const int parts_r = (block_m + ITEM_R - 1) / ITEM_R, parts_c = (block_n + ITEM_C - 1) / ITEM_C;
  const int t = blockIdx.x / (parts_r * parts_c), p = blockIdx.x % (parts_r * parts_c);
  const int r0 = (p / parts_c) * ITEM_R, c0 = (p % parts_c) * ITEM_C;
  const int x_rows = block_m - r0 < ITEM_R ? block_m - r0 : ITEM_R;
  const int y_rows = block_n - c0 < ITEM_C ? block_n - c0 : ITEM_C;
  const int cb = cols != nullptr ? cols[t] : t;
  float acc[8][ITEM_RN];
  ring_tile<ITEM_R, ITEM_C, 8, ITEM_RN, ITEM_STAGES>(
      x + ((long long)ij[t] * block_m + r0) * ld, x_rows,
      y + ((long long)cb * block_n + c0) * ld, y_rows, ld, ld, ring, acc);
  const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
  float* s = scratch + (long long)t * block_m * block_n + (long long)r0 * block_n + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + TYN * i;
    if (r < x_rows)
#pragma unroll
      for (int j = 0; j < ITEM_RN; ++j)
        if (tx + TXN * j < y_rows) s[(long long)r * block_n + tx + TXN * j] = acc[i][j];
  }
}

// Phase 2: one thread block per worklist entry selects both packets.
__global__ void __launch_bounds__(THREADS)
tile_select_kernel(const float* __restrict__ scratch, const int* __restrict__ ij, int n_tiles,
                   float* __restrict__ fv, int* __restrict__ fi, int* __restrict__ fc,
                   float* __restrict__ bv, int* __restrict__ bi, int* __restrict__ bc,
                   int block_m, int block_n, int n_valid, float threshold, int k) {
  const int t = blockIdx.x;
  tile_select(scratch + (long long)t * block_m * block_n, t, ij[t], ij[n_tiles + t], block_m,
              block_n, n_valid, threshold, k, fv, fi, fc, bv, bi, bc);
}

// Both launches over a (2, n_tiles) worklist. x and y (row stride ld) are
// the row and column operands, cols the column block of each entry (null:
// entry t of y); scratch (n_tiles, block_m, block_n) f32;
// fv/fi (n_tiles, block_m, k), fc (n_tiles, block_m); bv/bi (n_tiles,
// block_n, k), bc (n_tiles, block_n). Returns a cudaError_t code.
template <typename T>
int launch_tiles(const void* x, const void* y, const void* ij_, const int* cols, int n_tiles,
                 void* scratch, void* fv, void* fi, void* fc, void* bv, void* bi, void* bc,
                 int ld, int block_m, int block_n, int n_valid, float threshold, int k,
                 void* stream_) {
  if (block_m % TILE || block_n % TILE || block_m < TILE || block_n < TILE ||
      block_m > MAX_BLOCK || block_n > MAX_BLOCK || ld % PK || ld < PK || k < 1 || n_tiles < 1)
    return cudaErrorInvalidValue;
  const int* ij = static_cast<const int*>(ij_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  auto part = tile_part_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(part, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)ItemRing<T>::BYTES);
  if (err != cudaSuccess) return err;
  const long long items = (long long)n_tiles * ((block_m + ITEM_R - 1) / ITEM_R) *
                          ((block_n + ITEM_C - 1) / ITEM_C);
  part<<<(unsigned)items, THREADS, ItemRing<T>::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), ij, cols,
      static_cast<float*>(scratch), ld, block_m, block_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_select_kernel<<<n_tiles, THREADS, 0, stream>>>(
      static_cast<const float*>(scratch), ij, n_tiles, static_cast<float*>(fv),
      static_cast<int*>(fi), static_cast<int*>(fc), static_cast<float*>(bv),
      static_cast<int*>(bi), static_cast<int*>(bc), block_m, block_n, n_valid, threshold, k);
  return cudaGetLastError();
}

}  // namespace apss
