// The two launches of the rectangular worklist kernels K4 (dense queries
// against dense corpus blocks) and K6 (gathered queries against corpus
// blocks densified onto their supports): per worklist entry t, the forward
// candidate packet of a block_q x block_c tile of query rows against corpus
// rows. The two differ only in where entry t's query block lies (QueryAt):
// K4 reads query block ij[0, t] of Q (nq, m); K6 reads entry t of its
// gathered qg (T, block_q, S), one block a worklist entry. Both operands
// have row stride m (K6: m = S).
//
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
//      (rect_row_packet, K5's rule). K4's masked entry (the live index's
//      delta joins) also hands it col_live (one byte per corpus row, 0 =
//      dead) and qpos (per query row of Q, its own corpus position or -1):
//      those columns score NEG_LARGE before the threshold. The masks touch
//      the selection only, so the scores keep their bits.
// Worklists whose scratch would pass the caller's budget run in passes of
// `pass_tiles` tiles, each pass both launches. Row 1 of the worklist
// addresses the corpus block (and row 0 K4's query block); column ids and
// validity come from its LAST row (a (3, T) worklist carries global block
// ids there while row 1 holds local ones). The query and corpus types may
// differ (K4: f32 queries against a bf16 corpus, as the reference
// promotes); both are widened exactly and summed in f32. No TF32, no
// tensor cores: every score is FK-feature partials, each one fmaf chain
// from 0 in increasing feature order, added 0 + p0 + p1 + ..., the order
// K5 shares, so K4's packets are K5's bit for bit, and K6's are K4's on a
// corpus whose blocks span every feature.
#pragma once

#include "apss_common.cuh"

namespace apss {

constexpr int RECT_STAGES = 4;

// Where worklist entry t's query block lies.
enum class QueryAt {
  Block,  // query block ij[0, t] of Q (K4)
  Entry,  // entry t of the gathered blocks (K6)
};

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
template <QueryAt QA, int SR, int SC, typename TQ, typename TC>
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
  const int qi = QA == QueryAt::Entry ? t : ij[t], cj = ij[n_tiles + t];
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
                   int n_chunks, int nc_valid, float threshold, int k,
                   const unsigned char* __restrict__ col_live, const int* __restrict__ qpos) {
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
  for (int f = 0; f < n_chunks; ++f)  // 0 + p0 + p1 + ..., the chunk order K5 adds in
#pragma unroll
    for (int q = 0; q < MAX_BLOCK / 32; ++q)
      if (q * 32 < block_c) s[q] += p[f * chunk + q * 32 + lane];
#pragma unroll
  for (int q = 0; q < MAX_BLOCK / 32; ++q)
    if (q * 32 < block_c) rows[warp][q * 32 + lane] = s[q];
  __syncwarp();
  const long long row = (long long)(t0 + tl) * block_q + r;
  const int own = qpos != nullptr ? qpos[(long long)ij[t0 + tl] * block_q + r] : -1;
  rect_row_packet<false>(rows[warp], block_c, gj * block_c, nc_valid, threshold, k,
                         fv + row * k, fi + row * k, fc + row, col_live, own);
}

template <QueryAt QA, int SR, int SC, typename TQ, typename TC>
cudaError_t launch_strips(const void* Q, const void* C, const int* ij, int n_tiles, int t0,
                          int tiles, float* part, int m, int block_q, int block_c,
                          int n_chunks, cudaStream_t stream) {
  using R = Ring<SR, SC, RECT_STAGES, TQ, TC>;
  auto kernel = rect_part_kernel<QA, SR, SC, TQ, TC>;
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
template <QueryAt QA, typename TQ, typename TC>
cudaError_t launch_parts(const void* Q, const void* C, const int* ij, int n_tiles, int t0,
                         int tiles, float* part, int m, int block_q, int block_c,
                         int n_chunks, cudaStream_t stream) {
  int sr = 8;
  while (sr < block_q || sr * block_c < 8 * THREADS) sr *= 2;
  const int txn = THREADS / (sr / 8), sc = block_c < 8 * txn ? block_c : 8 * txn;
#define APSS_STRIP(SR, SC)                                                                 \
  if (sr == SR && sc == SC)                                                                \
    return launch_strips<QA, SR, SC, TQ, TC>(Q, C, ij, n_tiles, t0, tiles, part, m, block_q, \
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

// Both launches over the worklist, in passes of pass_tiles tiles.
template <QueryAt QA, typename TQ, typename TC>
int launch_rect(const void* Q, const void* C, const void* ij_, int ij_rows, int n_tiles,
                void* part_, int pass_tiles, void* fv, void* fi, void* fc, int m, int block_q,
                int block_c, int nc_valid, float threshold, int k, void* stream_,
                const void* col_live = nullptr, const void* qpos = nullptr) {
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
    cudaError_t err = launch_parts<QA, TQ, TC>(Q, C, ij, n_tiles, t0, tiles, part, m,
                                               block_q, block_c, n_chunks, stream);
    if (err != cudaSuccess) return err;
    const long long rows = (long long)tiles * block_q;
    rect_select_kernel<<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
        part, ij, ij_rows, n_tiles, t0, tiles, static_cast<float*>(fv), static_cast<int*>(fi),
        static_cast<int*>(fc), block_q, block_c, n_chunks, nc_valid, threshold, k,
        static_cast<const unsigned char*>(col_live), static_cast<const int*>(qpos));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace apss
