// K4: live-tile worklist kernel of query-time serving -- per rectangular
// tile (query block qi, corpus block cj) of a (2, T) or (3, T) worklist, the
// forward candidate packet of the tile's query rows.
//
// Replaces src/repro/kernels/apss_block/fused.py::rect_tile_candidates_pallas
// (_rect_cand_kernel, _rect_tile_packets).
//
// Design. On the TPU one grid step scores one tile. Here every tile is
// spread over the whole card in two launches (an ordinary grid: nothing
// carries from tile to tile):
//   1. rect_part_kernel: one thread block per work item (tile t, feature
//      chunk f of FK, strip of SC corpus rows); the split is
//      fused.py::rect_work_split. The item's query strip is the whole query
//      block, rounded up to SR = 8, 16, 32, 64 or 128 rows, so every corpus
//      row is read once per query block. It streams the chunk's features
//      through a 4-stage cp.async ring (ring_tile, apss_common.cuh) into 256
//      threads of 8 query rows x RN corpus rows each (Tall: the rows a warp
//      shares are broadcast from shared memory) and writes the partial
//      strip to device scratch part (tiles, n_chunks, block_q, block_c) f32.
//   2. rect_select_kernel: one warp per tile row adds each score's partials
//      from 0 in increasing chunk order, then keeps s >= t and gcol <
//      nc_valid and selects the row's top-k by (value desc, id asc)
//      (rect_row_packet, K5's rule).
// Worklists whose scratch would pass the caller's budget run in passes of
// `pass_tiles` tiles, each pass both launches. Rows 0 and 1 of the worklist
// address the operands; column ids and validity come from its LAST row (a
// (3, T) worklist carries global block ids there while row 1 holds local
// ones). Q and C may differ in type (f32 queries against a bf16 corpus, as
// the reference promotes); both are widened exactly and summed in f32.
// No TF32, no tensor cores: every score is FK-feature partials, each one
// fmaf chain from 0 in increasing feature order, added 0 + p0 + p1 + ...,
// the order K5 and K6 share, so K4's packets are K5's bit for bit.
//
// Bound: at serving batches (8-128 query rows) a tile does 2 * block_q FLOP
// per 4-byte corpus element, so a batch of one query block of 8 rows is
// bound by reading the live corpus blocks (radikal: 3.76 GB, 1.12 ms at
// 3.35 TB/s) and turns operation-bound near block_q = 40 (radikal at 64
// rows: 120.4 GFLOP, 1.79 ms at 67 TFLOP/s). Radikal's 27 live tiles give
// 27 * 134 = 3,618 items of 256 corpus rows, 27 per SM; the scratch (237 MB
// at 64 rows) is written once and read once.
#include "apss_common.cuh"

namespace apss {

constexpr int RECT_STAGES = 4;

// The item layout for query strips of SR rows (8 to 128): each of the 256
// threads owns 8 strip rows (ty + TYN * i) and RN corpus rows (tx + TXN *
// j) of an SC-row corpus strip. Every thread of a warp shares its rows (SR
// up to 64), so a query value read from shared memory is one broadcast and
// a corpus value feeds 8 fmaf: 8 + RN loads per 32 * RN fmaf.
template <int SR>
struct Tall {
  static constexpr int TYN = SR / 8, TXN = THREADS / TYN;
};

// Phase 1: the partial strip of one work item, SR query rows by SC corpus rows.
template <int SR, int SC, typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS, 1)
rect_part_kernel(const TQ* __restrict__ Q, const TC* __restrict__ C,
                 const int* __restrict__ ij, int n_tiles, int t0, float* __restrict__ part,
                 int m, int block_q, int block_c, int n_chunks) {
  constexpr int TXN = Tall<SR>::TXN, TYN = Tall<SR>::TYN, RN = SC / TXN;
  static_assert(RN >= 1 && RN * TXN == SC && RN <= 8, "a corpus strip the threads divide");
  extern __shared__ __align__(16) unsigned char ring[];
  const int strips = block_c / SC;
  long long it = blockIdx.x;  // ((t - t0) * n_chunks + f) * strips + strip
  const int c0 = (int)(it % strips) * SC;
  it /= strips;
  const int f = (int)(it % n_chunks), tl = (int)(it / n_chunks), t = t0 + tl;
  const int qi = ij[t], cj = ij[n_tiles + t];
  const long long f0 = (long long)f * FK;
  const int len = (int)(m - f0 < FK ? m - f0 : FK);
  float acc[8][RN];
  ring_tile<SR, SC, 8, RN, RECT_STAGES>(Q + (long long)qi * block_q * m + f0, block_q,
                                        C + ((long long)cj * block_c + c0) * m + f0, SC, m,
                                        len, ring, acc);
  const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
  float* p = part + ((long long)tl * n_chunks + f) * block_q * block_c + c0 + tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + TYN * i;
    if (r < block_q)
#pragma unroll
      for (int j = 0; j < RN; ++j) p[(long long)r * block_c + TXN * j] = acc[i][j];
  }
}

// Phase 2: one warp per row of the pass's tiles.
__global__ void __launch_bounds__(THREADS)
rect_select_kernel(const float* __restrict__ part, const int* __restrict__ ij, int ij_rows,
                   int n_tiles, int t0, int tiles, float* __restrict__ fv,
                   int* __restrict__ fi, int* __restrict__ fc, int block_q, int block_c,
                   int n_chunks, int nc_valid, float threshold, int k) {
  __shared__ float rows[WARPS][MAX_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long lrow = (long long)blockIdx.x * WARPS + warp;
  if (lrow >= (long long)tiles * block_q) return;  // the whole warp
  const int tl = (int)(lrow / block_q), r = (int)(lrow % block_q);
  const int gj = ij[(ij_rows - 1) * n_tiles + t0 + tl];
  const float* p = part + ((long long)tl * n_chunks * block_q + r) * block_c;
  const long long chunk = (long long)block_q * block_c;
  float s[MAX_BLOCK / 32];
#pragma unroll
  for (int q = 0; q < MAX_BLOCK / 32; ++q) s[q] = 0.f;
  for (int f = 0; f < n_chunks; ++f)  // 0 + p0 + p1 + ..., as score_strip adds
#pragma unroll
    for (int q = 0; q < MAX_BLOCK / 32; ++q)
      if (q * 32 < block_c) s[q] += p[f * chunk + q * 32 + lane];
#pragma unroll
  for (int q = 0; q < MAX_BLOCK / 32; ++q)
    if (q * 32 < block_c) rows[warp][q * 32 + lane] = s[q];
  __syncwarp();
  const long long row = (long long)(t0 + tl) * block_q + r;
  rect_row_packet<false>(rows[warp], block_c, gj * block_c, nc_valid, threshold, k,
                         fv + row * k, fi + row * k, fc + row);
}

template <int SR, int SC, typename TQ, typename TC>
cudaError_t launch_strips(const void* Q, const void* C, const int* ij, int n_tiles, int t0,
                          int tiles, float* part, int m, int block_q, int block_c,
                          int n_chunks, cudaStream_t stream) {
  using R = Ring<SR, SC, RECT_STAGES, TQ, TC>;
  auto kernel = rect_part_kernel<SR, SC, TQ, TC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)R::BYTES);
  if (err != cudaSuccess) return err;
  const long long items = (long long)tiles * n_chunks * (block_c / SC);
  kernel<<<(unsigned)items, THREADS, R::BYTES, stream>>>(
      static_cast<const TQ*>(Q), static_cast<const TC*>(C), ij, n_tiles, t0, part, m,
      block_q, block_c, n_chunks);
  return cudaGetLastError();
}

// The strip of fused.py::rect_work_split: SR the query block rounded up to
// 8, 16, 32, 64 or 128 rows, and at least 2048 / block_c (so that TXN, the
// threads along the corpus strip, fit the block); SC = min(block_c, 8 * TXN).
template <typename TQ, typename TC>
cudaError_t launch_parts(const void* Q, const void* C, const int* ij, int n_tiles, int t0,
                         int tiles, float* part, int m, int block_q, int block_c,
                         int n_chunks, cudaStream_t stream) {
  int sr = 8;
  while (sr < block_q || sr * block_c < 8 * THREADS) sr *= 2;
  const int txn = THREADS / (sr / 8), sc = block_c < 8 * txn ? block_c : 8 * txn;
#define APSS_STRIP(SR, SC)                                                                \
  if (sr == SR && sc == SC)                                                               \
    return launch_strips<SR, SC, TQ, TC>(Q, C, ij, n_tiles, t0, tiles, part, m, block_q, \
                                         block_c, n_chunks, stream);
  APSS_STRIP(8, 256)
  APSS_STRIP(16, 128)
  APSS_STRIP(16, 256)
  APSS_STRIP(32, 64)
  APSS_STRIP(32, 128)
  APSS_STRIP(32, 256)
  APSS_STRIP(64, 64)
  APSS_STRIP(64, 128)
  APSS_STRIP(64, 256)
  APSS_STRIP(128, 64)
  APSS_STRIP(128, 128)
#undef APSS_STRIP
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TC>
int launch(const void* Q, const void* C, const void* ij_, int ij_rows, int n_tiles,
           void* part_, int pass_tiles, void* fv, void* fi, void* fc, int m, int block_q,
           int block_c, int nc_valid, float threshold, int k, void* stream_) {
  if (block_q % 8 || block_q < 8 || block_q > MAX_QBLOCK || block_c % TILE ||
      block_c > MAX_BLOCK || m % PK || m < PK || k < 1 || n_tiles < 1 || pass_tiles < 1 ||
      (ij_rows != 2 && ij_rows != 3))
    return cudaErrorInvalidValue;
  const int* ij = static_cast<const int*>(ij_);
  float* part = static_cast<float*>(part_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int n_chunks = (m + FK - 1) / FK;
  for (int t0 = 0; t0 < n_tiles; t0 += pass_tiles) {
    const int tiles = n_tiles - t0 < pass_tiles ? n_tiles - t0 : pass_tiles;
    cudaError_t err = launch_parts<TQ, TC>(Q, C, ij, n_tiles, t0, tiles, part, m, block_q,
                                           block_c, n_chunks, stream);
    if (err != cudaSuccess) return err;
    const long long rows = (long long)tiles * block_q;
    rect_select_kernel<<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
        part, ij, ij_rows, n_tiles, t0, tiles, static_cast<float*>(fv), static_cast<int*>(fi),
        static_cast<int*>(fc), block_q, block_c, n_chunks, nc_valid, threshold, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace apss

// Q (nq, m) and C (nc, m) row-major, each float32 or bfloat16 (the entry's
// suffix: query type, corpus type); ij (ij_rows, n_tiles) int32; part
// (pass_tiles, ceil(m / FK), block_q, block_c) f32 scratch; fv/fi (n_tiles,
// block_q, k), fc (n_tiles, block_q). Returns a cudaError_t code.
#define APSS_RECT_ENTRY(SUFFIX, TQ, TC)                                                  \
  extern "C" int apss_rect_tile_candidates_##SUFFIX(                                     \
      const void* Q, const void* C, const void* ij, int ij_rows, int n_tiles, void* part, \
      int pass_tiles, void* fv, void* fi, void* fc, int m, int block_q, int block_c,     \
      int nc_valid, float threshold, int k, void* stream) {                              \
    return apss::launch<TQ, TC>(Q, C, ij, ij_rows, n_tiles, part, pass_tiles, fv, fi, fc, \
                                m, block_q, block_c, nc_valid, threshold, k, stream);    \
  }

APSS_RECT_ENTRY(f32_f32, float, float)
APSS_RECT_ENTRY(bf16_bf16, uint16_t, uint16_t)
APSS_RECT_ENTRY(f32_bf16, float, uint16_t)
APSS_RECT_ENTRY(bf16_f32, uint16_t, float)
