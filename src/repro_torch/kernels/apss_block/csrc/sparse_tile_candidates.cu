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
// Design: K2's two launches and compiled kernels (tile_items.cuh) with
// bx[ij[0, t]] as the row operand and yg[t] as the column operand (no
// column index: cols = null), at row stride S: work items of
// up to 128 x 128 scores (sparse.py::sparse_work_items, K2's items at
// block_n = bm) through ring_tile's 3-stage cp.async ring into the (T,
// bm, bm) scratch, then tile_select. Each score is one fmaf chain from 0
// in increasing support order, ring_tile's order, so on a corpus whose
// every row block has the full feature range as its support the packets
// equal K2's bit for bit.
//
// Bound: float32 FMA over the support, 2 * bm * bm * S FLOP per tile
// against 8 * bm * S bytes of operands (S in the hundreds to the tens of
// thousands). The (T, bm, S) yg buffer is the largest device allocation of
// the path; gathering inside the kernel would remove it (ROADMAP).
#include "tile_items.cuh"

// bx (nb, block_m, S), yg (n_tiles, block_m, S) row-major; ij (2, n_tiles)
// int32; scratch (n_tiles, block_m, block_m) f32; fv/fi and bv/bi
// (n_tiles, block_m, k), fc and bc (n_tiles, block_m). Returns a cudaError_t.
extern "C" int apss_sparse_tile_candidates_f32(const void* bx, const void* yg, const void* ij,
                                               int n_tiles, void* scratch, void* fv, void* fi,
                                               void* fc, void* bv, void* bi, void* bc, int S,
                                               int block_m, int n_valid, float threshold, int k,
                                               void* stream) {
  return apss::launch_tiles<float>(bx, yg, ij, nullptr, n_tiles, scratch, fv, fi, fc, bv, bi,
                                   bc, S, block_m, block_m, n_valid, threshold, k, stream);
}

extern "C" int apss_sparse_tile_candidates_bf16(const void* bx, const void* yg, const void* ij,
                                                int n_tiles, void* scratch, void* fv, void* fi,
                                                void* fc, void* bv, void* bi, void* bc, int S,
                                                int block_m, int n_valid, float threshold,
                                                int k, void* stream) {
  return apss::launch_tiles<uint16_t>(bx, yg, ij, nullptr, n_tiles, scratch, fv, fi, fc, bv, bi,
                                      bc, S, block_m, block_m, n_valid, threshold, k, stream);
}
