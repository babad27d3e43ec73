// K5: K4 with early exit -- the worklist is ordered by tile upper bound
// descending, and a tile is skipped when every valid query row of its block
// already holds k values that strictly beat the tile's bound ub[t].
//
// Replaces src/repro/kernels/apss_block/fused.py::rect_tile_candidates_early_exit_pallas
// (_rect_ee_cand_kernel).
//
// Contract. The worklist is walked in its order. A tile is skipped when
// ub[t] is a padding bound (<= -0.25e30), or when no valid row (global row
// < nq_valid; padded rows never pin a block) has a k-th value <= ub[t]. The
// test is strict (k-th > ub): the port orders ties by (value desc, id asc),
// so a skipped tile holding a candidate equal to a row's k-th value with a
// lower id would change the result under the TPU's `k-th >= ub`. A skipped
// tile writes the neutral packet (NEG_LARGE, -1, 0) and skipped[t] = 1; a
// scored one writes K4's packet, bit for bit, merges each row's selected
// values into the running values buffer, and skipped[t] = 0. Values and ids
// after the fold equal K4's; counts past k are lost for skipped tiles, and
// the caller saturates them at k.
//
// Design. On the TPU the grid walks the worklist in order on one core and
// carries the values buffer (nq, k) in VMEM. Here one persistent grid, as
// many thread blocks as the card holds at once (a cooperative launch, which
// guarantees that they are co-resident), walks the worklist together:
//   - every block runs the skip test itself from the values buffer
//     (grid_q * block_q, k) in device memory; all blocks read the same
//     buffer after the same barrier, so all decide alike. A skipped tile
//     needs no barrier: its neutral packet is written by all blocks, a
//     grid stride each;
//   - a scored tile runs in three phases, each closed by a grid barrier.
//     A: the work items of the split the wrapper passes (ee_work_split in
//     fused.py: feature chunk of FK x strip of 16, 32 or 64 query rows x
//     64 corpus rows) are spread over the blocks at a stride of the grid;
//     each writes its chunk's partial strip (score_strip_part,
//     apss_common.cuh) to the device scratch (n_chunks, block_q, block_c)
//     f32. B1: every element of the tile adds its partials in increasing
//     chunk order, from 0, into chunk 0's slot -- the order K4's
//     selection pass adds in, so the scores are K4's bits (no float
//     atomics). B2: one
//     warp per tile row selects the row's packet (rect_row_packet, K4's
//     rule) and merges its values into the buffer in shared memory
//     (merge_values).
// Reads of what other blocks wrote in this launch go through L2 (__ldcg).
//
// Bound: K4's bytes and operations for the tiles this run scores: 2 * rows
// * cols * m FLOP of f32 FMA per tile (no TF32, no tensor cores) against
// each query row and each scored corpus row read once. On radikal's
// 64-query batch (27 tiles of 64 x 256 over m = 136,704) that is 120.4
// GFLOP, 1.794 ms at the card's 67 TFLOP/s f32 peak, against 3.8 GB of
// corpus rows (1.13 ms at 3.35 TB/s): operation-bound. The split gives
// 134 chunks x 4 strips = 536 items a tile on a grid of 264 (two blocks an
// SM at 127 registers a thread), so every SM works on every scored tile.
// The barriers cost a few microseconds each (three per scored tile). The
// kernel is instantiated per strip height (RM), each with its own register
// allocation; one kernel switching on the height per item measured slower.
#include <cooperative_groups.h>

#include "apss_common.cuh"

namespace apss {

namespace cg = cooperative_groups;

struct EeArgs {
  const void* Q;
  const void* C;
  const int* ij;       // (2, n_tiles)
  const float* ub;     // (n_tiles,)
  const int* items;    // (n_items, 3): chunk, first query row, first corpus row
  float* fv;           // (n_tiles, block_q, k)
  int* fi;
  int* fc;             // (n_tiles, block_q)
  int* skipped;        // (n_tiles,)
  float* topv;         // (grid_q * block_q, k) running values
  float* part;         // (n_chunks, block_q, block_c) partial tiles
  int n_tiles, grid_q, n_items, m, block_q, block_c, nc_valid, nq_valid, k;
  float threshold;
};

// RM: query rows per thread of a strip (16 * RM rows by 64 corpus rows);
// TQ, TC: the types of the queries and of the corpus.
template <int RM, typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
rect_ee_kernel(const EeArgs a) {
  __shared__ __align__(16) Staged st;
  extern __shared__ __align__(16) float dyn[];  // per warp: its buffer row, its packet row
  cg::grid_group grid = cg::this_grid();
  const TQ* Q = static_cast<const TQ*>(a.Q);
  const TC* C = static_cast<const TC*>(a.C);
  const int nb = gridDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long gtid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthreads = (long long)nb * THREADS;
  const long long m = a.m, k = a.k;
  const long long tile = (long long)a.block_q * a.block_c;
  const int n_chunks = (int)((m + FK - 1) / FK);

  for (long long e = gtid; e < (long long)a.grid_q * a.block_q * k; e += nthreads)
    a.topv[e] = NEG_LARGE;
  grid.sync();

  for (int t = 0; t < a.n_tiles; ++t) {
    const int qi = a.ij[t];
    const float u = a.ub[t];
    const int r = threadIdx.x;
    const float* kth = a.topv + ((long long)qi * a.block_q + r) * k + (k - 1);
    const bool pin = r < a.block_q && r < a.nq_valid - qi * a.block_q && !(__ldcg(kth) > u);
    const bool any_pin = __syncthreads_or(pin);
    const long long row = (long long)t * a.block_q;
    if (u <= VALID || !any_pin) {  // the same decision in every block
      for (long long e = gtid; e < a.block_q * k; e += nthreads) {
        a.fv[row * k + e] = NEG_LARGE;
        a.fi[row * k + e] = -1;
      }
      for (long long e = gtid; e < a.block_q; e += nthreads) a.fc[row + e] = 0;
      if (gtid == 0) a.skipped[t] = 1;
      continue;
    }
    if (gtid == 0) a.skipped[t] = 0;
    const int cj = a.ij[a.n_tiles + t];
    const TQ* qb = Q + (long long)qi * a.block_q * m;
    const TC* cb = C + (long long)cj * a.block_c * m;

    // A: partial strips, one work item at a time.
    for (int it = blockIdx.x; it < a.n_items; it += nb) {
      const int f = a.items[3 * it], r0 = a.items[3 * it + 1], c0 = a.items[3 * it + 2];
      const long long f0 = (long long)f * FK;
      float acc[RM][4];
      score_strip_part<RM>(qb + r0 * m + f0, a.block_q - r0, cb + c0 * m + f0, m,
                           (int)(m - f0 < FK ? m - f0 : FK), st, acc);
      float* p = a.part + f * tile;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rr = r0 + ty * RM + i;
        if (rr < a.block_q)
          *reinterpret_cast<float4*>(&p[(long long)rr * a.block_c + c0 + tx * 4]) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    grid.sync();

    // B1: each score is 0 + partial_0 + partial_1 + ..., K4's order.
    for (long long e = gtid; e < tile; e += nthreads) {
      float s = 0.f;
      for (int f = 0; f < n_chunks; ++f) s += __ldcg(a.part + f * tile + e);
      a.part[e] = s;
    }
    grid.sync();

    // B2: per row, K4's packet, then its values merged into the buffer.
    float* bufv = dyn + warp * 2 * k;
    float* pkv = bufv + k;
    for (int rr = blockIdx.x * WARPS + warp; rr < a.block_q; rr += nb * WARPS) {
      float* out_v = a.fv + (row + rr) * k;
      rect_row_packet<true>(a.part + (long long)rr * a.block_c, a.block_c, cj * a.block_c,
                            a.nc_valid, a.threshold, a.k, out_v, a.fi + (row + rr) * k,
                            a.fc + row + rr);
      __syncwarp();  // the packet row is written (lane 0 and the padding lanes)
      float* tv = a.topv + ((long long)qi * a.block_q + rr) * k;
      for (int e = lane; e < k; e += 32) {
        bufv[e] = __ldcg(tv + e);
        pkv[e] = out_v[e];
      }
      __syncwarp();
      merge_values(bufv, pkv, a.k);
      for (int e = lane; e < k; e += 32) tv[e] = bufv[e];
    }
    grid.sync();
  }
}

template <int RM, typename TQ, typename TC>
cudaError_t capacity_rm(int k, int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rect_ee_kernel<RM, TQ, TC>, THREADS, sizeof(float) * WARPS * 2 * k);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) *blocks = per_sm * sms;
  return err;
}

// Thread blocks of K5 the card holds at once, for every strip height, of
// the instantiation for these operand types.
template <typename TQ, typename TC>
int capacity(int k, int* blocks) {
  if (k < 1 || k > MAX_EE_K) return cudaErrorInvalidValue;
  int b1 = 0, b2 = 0, b4 = 0;
  cudaError_t err = capacity_rm<1, TQ, TC>(k, &b1);
  if (err == cudaSuccess) err = capacity_rm<2, TQ, TC>(k, &b2);
  if (err == cudaSuccess) err = capacity_rm<4, TQ, TC>(k, &b4);
  if (err != cudaSuccess) return err;
  *blocks = b1 < b2 ? (b1 < b4 ? b1 : b4) : (b2 < b4 ? b2 : b4);
  return cudaSuccess;
}

template <int RM, typename TQ, typename TC>
cudaError_t launch_rm(EeArgs& a, int grid, cudaStream_t stream) {
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)rect_ee_kernel<RM, TQ, TC>, grid, THREADS,
                                     args,
                                     sizeof(float) * WARPS * 2 * a.k, stream);
}

template <typename TQ, typename TC>
int launch(EeArgs a, int strip_rows, int grid, void* stream) {
  if (a.block_q % 8 || a.block_q < 8 || a.block_q > MAX_QBLOCK || a.block_c % TILE ||
      a.block_c > MAX_BLOCK || a.m % TK || a.m < TK || a.k < 1 || a.k > MAX_EE_K ||
      a.n_tiles < 1 || a.grid_q < 1 || a.n_items < 1 || grid < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (strip_rows) {
    case 16: err = launch_rm<1, TQ, TC>(a, grid, s); break;
    case 32: err = launch_rm<2, TQ, TC>(a, grid, s); break;
    case 64: err = launch_rm<4, TQ, TC>(a, grid, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

EeArgs args(const void* Q, const void* C, const void* ij, const void* ub, int n_tiles,
            int grid_q, void* fv, void* fi, void* fc, void* skipped, void* topv, void* part,
            const void* items, int n_items, int m, int block_q, int block_c, int nc_valid,
            int nq_valid, float threshold, int k) {
  EeArgs a;
  a.Q = Q;
  a.C = C;
  a.ij = static_cast<const int*>(ij);
  a.ub = static_cast<const float*>(ub);
  a.items = static_cast<const int*>(items);
  a.fv = static_cast<float*>(fv);
  a.fi = static_cast<int*>(fi);
  a.fc = static_cast<int*>(fc);
  a.skipped = static_cast<int*>(skipped);
  a.topv = static_cast<float*>(topv);
  a.part = static_cast<float*>(part);
  a.n_tiles = n_tiles;
  a.grid_q = grid_q;
  a.n_items = n_items;
  a.m = m;
  a.block_q = block_q;
  a.block_c = block_c;
  a.nc_valid = nc_valid;
  a.nq_valid = nq_valid;
  a.k = k;
  a.threshold = threshold;
  return a;
}

}  // namespace apss

// The entries' suffix names the query type, then the corpus type.
//
// capacity: the co-resident grid of K5 (thread blocks over all SMs) for a
// given k.
//
// launch: Q (grid_q * block_q, m) and C (nc, m) row-major; ij (2, n_tiles)
// int32; ub (n_tiles,) f32; fv/fi (n_tiles, block_q, k), fc (n_tiles,
// block_q), skipped (n_tiles,) int32; topv (grid_q * block_q, k) f32 and
// part (ceil(m / FK), block_q, block_c) f32 scratch; items (n_items, 3)
// int32, strips of strip_rows (16, 32 or 64) query rows by 64 corpus rows;
// grid thread blocks, at most the capacity above. A cooperative launch on
// `stream`. Both return a cudaError_t code.
#define APSS_EE_ENTRIES(SUFFIX, TQ, TC)                                                       \
  extern "C" int apss_rect_tile_candidates_ee_capacity_##SUFFIX(int k, int* blocks) {          \
    return apss::capacity<TQ, TC>(k, blocks);                                                 \
  }                                                                                           \
  extern "C" int apss_rect_tile_candidates_ee_##SUFFIX(                                       \
      const void* Q, const void* C, const void* ij, const void* ub, int n_tiles, int grid_q,  \
      void* fv, void* fi, void* fc, void* skipped, void* topv, void* part, const void* items, \
      int n_items, int strip_rows, int grid, int m, int block_q, int block_c, int nc_valid,   \
      int nq_valid, float threshold, int k, void* stream) {                                   \
    return apss::launch<TQ, TC>(                                                              \
        apss::args(Q, C, ij, ub, n_tiles, grid_q, fv, fi, fc, skipped, topv, part, items,     \
                   n_items, m, block_q, block_c, nc_valid, nq_valid, threshold, k),           \
        strip_rows, grid, stream);                                                            \
  }

APSS_EE_ENTRIES(f32_f32, float, float)
APSS_EE_ENTRIES(bf16_bf16, uint16_t, uint16_t)
APSS_EE_ENTRIES(f32_bf16, float, uint16_t)
APSS_EE_ENTRIES(bf16_f32, uint16_t, float)
