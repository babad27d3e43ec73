// K4: live-tile worklist kernel of query-time serving -- per rectangular
// tile (query block qi, corpus block cj) of a (2, T) or (3, T) worklist, the
// forward candidate packet of the tile's query rows.
//
// Replaces src/repro/kernels/apss_block/fused.py::rect_tile_candidates_pallas
// (_rect_cand_kernel, _rect_tile_packets).
//
// Design. On the TPU one grid step scores one tile. Here every tile is
// spread over the whole card in two launches (an ordinary grid: nothing
// carries from tile to tile), rect_part_kernel over work items of (tile x
// FK feature chunk x corpus strip) and rect_select_kernel, one warp per
// tile row; rect_tiles.cuh holds both, shared with K6 (QueryAt::Block
// here: the query operand of entry t is query block ij[0, t] of Q).
// Rows 0 and 1 of the worklist address the operands; column ids and
// validity come from its LAST row. Q and C may differ in type (f32
// queries against a bf16 corpus, as the reference promotes). The summation
// order (FK-feature partials, each one fmaf chain from 0, added 0 + p0 +
// p1 + ...) makes K4's packets K5's bit for bit.
//
// Bound: at serving batches (8-128 query rows) a tile does 2 * block_q FLOP
// per 4-byte corpus element, so a batch of one query block of 8 rows is
// bound by reading the live corpus blocks (radikal: 3.76 GB, 1.12 ms at
// 3.35 TB/s) and turns operation-bound near block_q = 40 (radikal at 64
// rows: 120.4 GFLOP, 1.79 ms at 67 TFLOP/s). Radikal's 27 live tiles give
// 27 * 134 = 3,618 items of 256 corpus rows, 27 per SM; the scratch (237 MB
// at 64 rows) is written once and read once.
#include "rect_tiles.cuh"

// Q (nq, m) and C (nc, m) row-major, each float32 or bfloat16 (the entry's
// suffix: query type, corpus type); ij (ij_rows, n_tiles) int32; part
// (pass_tiles, ceil(m / FK), block_q, block_c) f32 scratch; fv/fi (n_tiles,
// block_q, k), fc (n_tiles, block_q). Returns a cudaError_t code.
#define APSS_RECT_ENTRY(SUFFIX, TQ, TC)                                                  \
  extern "C" int apss_rect_tile_candidates_##SUFFIX(                                     \
      const void* Q, const void* C, const void* ij, int ij_rows, int n_tiles, void* part, \
      int pass_tiles, void* fv, void* fi, void* fc, int m, int block_q, int block_c,     \
      int nc_valid, float threshold, int k, void* stream) {                              \
    return apss::launch_rect<apss::QueryAt::Block, TQ, TC>(                              \
        Q, C, ij, ij_rows, n_tiles, part, pass_tiles, fv, fi, fc, m, block_q, block_c,   \
        nc_valid, threshold, k, stream);                                                 \
  }

APSS_RECT_ENTRY(f32_f32, float, float)
APSS_RECT_ENTRY(bf16_bf16, uint16_t, uint16_t)
APSS_RECT_ENTRY(f32_bf16, float, uint16_t)
APSS_RECT_ENTRY(bf16_f32, uint16_t, float)
