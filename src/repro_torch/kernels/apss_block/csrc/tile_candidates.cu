// K2: live-tile worklist kernel of the self-join -- per upper-triangular
// tile (i, j) of a (2, T) worklist, a forward candidate packet for the rows
// of block i and a mirror packet for the rows of block j (S = S^T).
//
// Replaces src/repro/kernels/apss_block/fused.py::apss_tile_candidates_pallas
// (_tile_cand_kernel, _tile_packets).
//
// Design. One thread block per worklist entry t; it reads ij[:, t] itself
// (the TPU kernel got it by scalar prefetch). A block_m x block_n tile of
// f32 scores (256 KB at 256 x 256) does not fit a block's 227 KB of shared
// memory, so the tile goes to a device scratch buffer that the wrapper
// allocates, (T, block_m, block_n) f32 -- design 2: phase 1 computes the
// tile as 64 x 64 sub-tiles with score_tile (apss_common.cuh) and writes
// them to scratch; after a block barrier, phase 2 selects from it:
//   forward: one warp per tile row: keep s >= t, grow != gcol,
//     grow < n_valid, gcol < n_valid; count them; top-k by
//     (value desc, gcol asc) in min(k, count) rounds of warp-wide
//     selection over the row held in registers;
//   mirror (i != j): one warp per tile column, the same kept set read down
//     the column, ids grow (not gcol); on a diagonal tile the mirror packet
//     is empty with count 0.
// Scratch costs 4 * block_m * block_n bytes per worklist entry; its traffic
// (written once, read twice, mostly from L2) is small next to the tile's
// 2 * block_m * block_n * m FLOP, so the kernel stays bound by float32 FMA.
// Tiles are at most 256 x 256 (eight register slots per lane in phase 2).
#include "apss_common.cuh"

namespace apss {

constexpr int MAX_BLOCK = 256;

// Writes the top-k of the lane-held candidates (v, id; up to 8 per lane,
// `count` of them real) to out_v/out_i[0, k) and count to *out_c.
__device__ __forceinline__ void select_packet(float (&v)[MAX_BLOCK / 32],
                                              int (&id)[MAX_BLOCK / 32], int count, int k,
                                              float* out_v, int* out_i, int* out_c) {
  const int lane = threadIdx.x & 31;
  const int rounds = count < k ? count : k;
  for (int slot = 0; slot < rounds; ++slot) {
    float bv = NEG_LARGE;
    int bi = 0x7fffffff, bp = 0;
#pragma unroll
    for (int q = 0; q < MAX_BLOCK / 32; ++q) {
      if (before(v[q], id[q], bv, bi)) {
        bv = v[q];
        bi = id[q];
      }
    }
    warp_first(bv, bi, bp);
#pragma unroll
    for (int q = 0; q < MAX_BLOCK / 32; ++q) {
      if (id[q] == bi) v[q] = NEG_LARGE;  // real ids are unique within a packet
    }
    if (lane == 0) {
      out_v[slot] = bv;
      out_i[slot] = bi;
    }
  }
  for (int e = rounds + lane; e < k; e += 32) {
    out_v[e] = NEG_LARGE;
    out_i[e] = -1;
  }
  if (lane == 0) *out_c = count;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_candidates_kernel(const T* __restrict__ D, const int* __restrict__ ij, int n_tiles,
                       float* scratch, float* __restrict__ fv, int* __restrict__ fi,
                       int* __restrict__ fc, float* __restrict__ bv, int* __restrict__ bi,
                       int* __restrict__ bc, int m, int block_m, int block_n, int n_valid,
                       float threshold, int k) {
  __shared__ __align__(16) Staged st;
  const int t = blockIdx.x;
  const int ib = ij[t], jb = ij[n_tiles + t];
  float* s = scratch + (long long)t * block_m * block_n;
  const T* xb = D + (long long)ib * block_m * m;
  const T* yb = D + (long long)jb * block_n * m;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int r0 = 0; r0 < block_m; r0 += TILE) {
    for (int c0 = 0; c0 < block_n; c0 += TILE) {
      float acc[4][4];
      score_tile(xb + (long long)r0 * m, yb + (long long)c0 * m, m, st, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(&s[(long long)(r0 + ty * 4 + i) * block_n + c0 + tx * 4]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
  __syncthreads();  // the block's scratch writes are visible to all its threads

  const int grow0 = ib * block_m, gcol0 = jb * block_n;
  for (int r = warp; r < block_m; r += WARPS) {  // forward packet: rows of block i
    const int grow = grow0 + r;
    float v[MAX_BLOCK / 32];
    int id[MAX_BLOCK / 32];
    int count = 0;
#pragma unroll
    for (int q = 0; q < MAX_BLOCK / 32; ++q) {
      const int c = q * 32 + lane;
      bool ok = false;
      float sv = NEG_LARGE;
      if (c < block_n) {
        const int gcol = gcol0 + c;
        sv = s[(long long)r * block_n + c];
        ok = sv >= threshold && grow != gcol && grow < n_valid && gcol < n_valid;
        id[q] = ok ? gcol : -1;
      } else {
        id[q] = -1;
      }
      v[q] = ok ? sv : NEG_LARGE;
      count += __popc(__ballot_sync(FULL, ok));
    }
    const long long row = (long long)t * block_m + r;
    select_packet(v, id, count, k, fv + row * k, fi + row * k, fc + row);
  }

  for (int c = warp; c < block_n; c += WARPS) {  // mirror packet: rows of block j
    const long long row = (long long)t * block_n + c;
    if (ib == jb) {
      for (int e = lane; e < k; e += 32) {
        bv[row * k + e] = NEG_LARGE;
        bi[row * k + e] = -1;
      }
      if (lane == 0) bc[row] = 0;
      continue;
    }
    const int gcol = gcol0 + c;
    float v[MAX_BLOCK / 32];
    int id[MAX_BLOCK / 32];
    int count = 0;
#pragma unroll
    for (int q = 0; q < MAX_BLOCK / 32; ++q) {
      const int r = q * 32 + lane;
      bool ok = false;
      float sv = NEG_LARGE;
      if (r < block_m) {
        const int grow = grow0 + r;
        sv = s[(long long)r * block_n + c];
        ok = sv >= threshold && grow != gcol && grow < n_valid && gcol < n_valid;
        id[q] = ok ? grow : -1;
      } else {
        id[q] = -1;
      }
      v[q] = ok ? sv : NEG_LARGE;
      count += __popc(__ballot_sync(FULL, ok));
    }
    select_packet(v, id, count, k, bv + row * k, bi + row * k, bc + row);
  }
}

template <typename T>
int launch(const void* D, const void* ij, int n_tiles, void* scratch, void* fv, void* fi,
           void* fc, void* bv, void* bi, void* bc, int m, int block_m, int block_n,
           int n_valid, float threshold, int k, void* stream) {
  if (block_m % TILE || block_n % TILE || block_m > MAX_BLOCK || block_n > MAX_BLOCK ||
      m % TK || k < 1 || n_tiles < 1)
    return cudaErrorInvalidValue;
  tile_candidates_kernel<T><<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const int*>(ij), n_tiles,
      static_cast<float*>(scratch), static_cast<float*>(fv), static_cast<int*>(fi),
      static_cast<int*>(fc), static_cast<float*>(bv), static_cast<int*>(bi),
      static_cast<int*>(bc), m, block_m, block_n, n_valid, threshold, k);
  return cudaGetLastError();
}

}  // namespace apss

// D (n, m) row-major; ij (2, n_tiles) int32; scratch (n_tiles, block_m, block_n)
// f32; fv/fi (n_tiles, block_m, k), fc (n_tiles, block_m); bv/bi
// (n_tiles, block_n, k), bc (n_tiles, block_n). Returns a cudaError_t code.
extern "C" int apss_tile_candidates_f32(const void* D, const void* ij, int n_tiles,
                                        void* scratch, void* fv, void* fi, void* fc, void* bv,
                                        void* bi, void* bc, int m, int block_m, int block_n,
                                        int n_valid, float threshold, int k, void* stream) {
  return apss::launch<float>(D, ij, n_tiles, scratch, fv, fi, fc, bv, bi, bc, m, block_m,
                             block_n, n_valid, threshold, k, stream);
}

extern "C" int apss_tile_candidates_bf16(const void* D, const void* ij, int n_tiles,
                                         void* scratch, void* fv, void* fi, void* fc,
                                         void* bv, void* bi, void* bc, int m, int block_m,
                                         int block_n, int n_valid, float threshold, int k,
                                         void* stream) {
  return apss::launch<uint16_t>(D, ij, n_tiles, scratch, fv, fi, fc, bv, bi, bc, m, block_m,
                                block_n, n_valid, threshold, k, stream);
}
