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
// Design. K4's two launches (rect_tiles.cuh) with QueryAt::Entry: the query
// operand of entry t is qg[t], the corpus operand bx[ij[1, t]], both at row
// stride S. rect_part_kernel runs one thread block per work item (tile x
// FK-feature chunk of the support x corpus strip, fused.py::rect_work_split
// with m = S), streaming the chunk through K4's cp.async ring into K4's
// Tall thread layout and writing the partial strip to device scratch;
// rect_select_kernel adds each score's partials from 0 in chunk order and
// selects by (value desc, id asc), one warp per tile row, ids and validity
// from ij[1, t]. The summation order is K4's, so on a corpus whose blocks
// span every feature (support arange(m), zero-padded) K6's packets are
// K4's bit for bit. Worklists whose scratch passes the wrapper's budget run
// in passes of pass_tiles tiles.
//
// Bound: 2 * block_q * block_c * S FLOP per tile against 4 * (block_q +
// block_c) * S bytes of operands: about block_q / 2 FLOP per byte of bx,
// under the card's ridge of about 20 until block_q nears 40, so a batch of
// small query blocks is bound by reading bx and qg. Radikal's sparse index
// at 64 queries (27 live tiles, S about 13.8k, 12 GFLOP, 0.18 ms at 67
// TFLOP/s) gives 27 * 14 = 378 items of one FK chunk, about 3 an SM, and
// 25 MB of scratch written once and read once; the one-block-per-tile
// design it replaces kept 27 of the 132 SMs busy.
#include "rect_tiles.cuh"

// qg (n_tiles, block_q, S) and bx (nb, block_c, S) row-major, one dtype; ij
// (2, n_tiles) int32; part (pass_tiles, ceil(S / FK), block_q, block_c) f32
// scratch; fv/fi (n_tiles, block_q, k), fc (n_tiles, block_q). Returns a
// cudaError_t code.
#define APSS_RECT_SPARSE_ENTRY(SUFFIX, T)                                                 \
  extern "C" int apss_rect_sparse_tile_candidates_##SUFFIX(                              \
      const void* qg, const void* bx, const void* ij, int n_tiles, void* part,           \
      int pass_tiles, void* fv, void* fi, void* fc, int S, int block_q, int block_c,     \
      int nc_valid, float threshold, int k, void* stream) {                              \
    return apss::launch_rect<apss::QueryAt::Entry, T, T>(                                \
        qg, bx, ij, 2, n_tiles, part, pass_tiles, fv, fi, fc, S, block_q, block_c,       \
        nc_valid, threshold, k, stream);                                                 \
  }

APSS_RECT_SPARSE_ENTRY(f32, float)
APSS_RECT_SPARSE_ENTRY(bf16, uint16_t)
