// K2: live-tile worklist kernel of the self-join -- per upper-triangular
// tile (i, j) of a (2, T) worklist, a forward candidate packet for the rows
// of block i and a mirror packet for the rows of block j (S = S^T).
//
// Replaces src/repro/kernels/apss_block/fused.py::apss_tile_candidates_pallas
// (_tile_cand_kernel, _tile_packets).
//
// Design: the two launches of tile_items.cuh, shared with K3, with row
// blocks ij[0, t] and ij[1, t] of D as the row and column operands (row
// stride m; the TPU kernel got ij by scalar prefetch, a block here reads
// it itself). Launch 1 cuts each block_m x block_n tile into work items
// of up to 128 x 128 scores (fused.py::tile_work_items) that stream all m
// features through ring_tile's 3-stage cp.async ring into the (T,
// block_m, block_n) f32 scratch; launch 2 selects the forward packet (one
// warp per row) and the mirror packet (one warp per column, empty on a
// diagonal tile) with tile_select. Each score is one fmaf chain from 0 in
// increasing feature order: K1's scores and, on full support, K3's
// packets bit for bit.
//
// Bound: float32 FMA, 2 * block_m * block_n * m FLOP a tile against 8 *
// 128 * m bytes an item (32 FLOP a byte at 128 x 128, above the card's
// ridge with no L2 reuse). radikal (6,912 x 136,704 padded, 378 live tiles
// of 256 x 256) is 1,512 work items, 11.5 an SM, and 6.77e12 FLOP: 100.1
// ms at 67 TFLOP/s. clustered_65k (65,536 x 768) is 1,152 tiles, 4,608
// items of 24 ring stages; there the selection launch costs as much as the
// scoring (3.7 and 3.9 ms on an H100 SXM): tile_select runs one round of
// warp-wide selection per kept candidate, up to k, for each of the tile's
// 512 packets, and clustered rows keep many candidates a tile.
#include "tile_items.cuh"

// D (n, m) row-major; ij (2, n_tiles) int32; scratch (n_tiles, block_m, block_n)
// f32; fv/fi (n_tiles, block_m, k), fc (n_tiles, block_m); bv/bi
// (n_tiles, block_n, k), bc (n_tiles, block_n). Returns a cudaError_t code.
extern "C" int apss_tile_candidates_f32(const void* D, const void* ij, int n_tiles,
                                        void* scratch, void* fv, void* fi, void* fc, void* bv,
                                        void* bi, void* bc, int m, int block_m, int block_n,
                                        int n_valid, float threshold, int k, void* stream) {
  const int* cols = static_cast<const int*>(ij) + n_tiles;  // row 1 of the worklist
  return apss::launch_tiles<float>(D, D, ij, cols, n_tiles, scratch, fv, fi, fc, bv, bi, bc,
                                   m, block_m, block_n, n_valid, threshold, k, stream);
}

extern "C" int apss_tile_candidates_bf16(const void* D, const void* ij, int n_tiles,
                                         void* scratch, void* fv, void* fi, void* fc,
                                         void* bv, void* bi, void* bc, int m, int block_m,
                                         int block_n, int n_valid, float threshold, int k,
                                         void* stream) {
  const int* cols = static_cast<const int*>(ij) + n_tiles;  // row 1 of the worklist
  return apss::launch_tiles<uint16_t>(D, D, ij, cols, n_tiles, scratch, fv, fi, fc, bv, bi,
                                      bc, m, block_m, block_n, n_valid, threshold, k, stream);
}
