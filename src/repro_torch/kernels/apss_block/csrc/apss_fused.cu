// K1: streaming fused APSS join -- X . Y^T, threshold, self-exclusion,
// per-row top-k and exact counts in one kernel; the score matrix never
// reaches device memory.
//
// Replaces src/repro/kernels/apss_block/fused.py::apss_fused_pallas
// (_fused_kernel, _merge_topk).
//
// Design. The TPU kernel walks its (i, j, kf) grid in order and carries a
// row block's running top-k across j in VMEM scratch. Hopper's blocks run
// in no order, so here one thread block owns 64 rows and loops over every
// 64-column tile itself, keeping its rows' running top-k (values + global
// ids) and counts in shared memory; nothing carries between blocks. A
// column tile whose entry of the block mask is 0 is skipped (the mask stays
// at the caller's block_m x block_n granularity and is read at
// (row / block_m, col / block_n), so its meaning is unchanged). Row and
// column offsets and the count of valid columns are runtime arguments.
//
// Per live tile: score_tile (apss_common.cuh), then one warp per row keeps
// s >= t, local col < n_valid_cols and (with exclude_self) global row !=
// global col, adds them to the exact count, drops candidates that do not
// beat the row's current k-th entry, and if any remain, refills the row's
// top-k by k rounds of warp-wide first-in-order selection over the old
// buffer and the survivors. Order: (value desc, global id asc).
//
// Bound: float32 FMA (see apss_common.cuh). Shared memory per block is
// 34,048 + 64*k*8 + 64*4 + 8*(k+64)*8 bytes (56,832 at k = 32), which caps
// k at 336 on a 227 KB block.
#include "apss_common.cuh"

namespace apss {

__host__ __device__ constexpr size_t fused_smem_bytes(int k) {
  return sizeof(Staged) + sizeof(float) * TILE * (TILE + 1)  // staged chunks, score tile
         + (sizeof(float) + sizeof(int)) * TILE * k           // running top-k
         + sizeof(int) * TILE                                 // counts
         + (sizeof(float) + sizeof(int)) * WARPS * (k + TILE);  // per-warp merge area
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_kernel(const T* __restrict__ x, const T* __restrict__ y, const int* __restrict__ mask,
             float* __restrict__ out_v, int* __restrict__ out_i, int* __restrict__ out_c,
             int n_cols, int m, int mask_cols, int block_m, int block_n, int row_offset,
             int col_offset, int n_valid_cols, float threshold, int k, int exclude_self) {
  extern __shared__ __align__(16) unsigned char smem[];
  Staged& st = *reinterpret_cast<Staged*>(smem);
  float* tile = reinterpret_cast<float*>(smem + sizeof(Staged));
  float* top_v = tile + TILE * (TILE + 1);
  int* top_i = reinterpret_cast<int*>(top_v + TILE * k);
  int* cnt = top_i + TILE * k;
  float* mrg_v = reinterpret_cast<float*>(cnt + TILE);
  int* mrg_i = reinterpret_cast<int*>(mrg_v + WARPS * (k + TILE));

  const int row0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int e = threadIdx.x; e < TILE * k; e += THREADS) {
    top_v[e] = NEG_LARGE;
    top_i[e] = -1;
  }
  for (int e = threadIdx.x; e < TILE; e += THREADS) cnt[e] = 0;
  __syncthreads();

  const int* mask_row = mask + (long long)(row0 / block_m) * mask_cols;
  float* mv = mrg_v + warp * (k + TILE);
  int* mi = mrg_i + warp * (k + TILE);
  for (int col0 = 0; col0 < n_cols; col0 += TILE) {
    if (mask_row[col0 / block_n] == 0) continue;  // the same for every thread
    float acc[4][4];
    score_tile(x + (long long)row0 * m, y + (long long)col0 * m, m, st, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tile[(ty * 4 + i) * (TILE + 1) + tx * 4 + j] = acc[i][j];
    __syncthreads();

    for (int r = warp; r < TILE; r += WARPS) {
      const int grow = row_offset + row0 + r;
      float* tv = top_v + r * k;
      int* ti = top_i + r * k;
      float s[2];
      int g[2];
      bool ok[2];
      int n_ok = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lc = col0 + lane + 32 * h;
        s[h] = tile[r * (TILE + 1) + lane + 32 * h];
        g[h] = col_offset + lc;
        ok[h] = s[h] >= threshold && lc < n_valid_cols && !(exclude_self && grow == g[h]);
        n_ok += __popc(__ballot_sync(FULL, ok[h]));
      }
      if (n_ok == 0) continue;
      if (lane == 0) cnt[r] += n_ok;
      const float kv = tv[k - 1];
      const int ki = ti[k - 1];
      bool enter[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) enter[h] = ok[h] && before(s[h], g[h], kv, ki);
      if (__ballot_sync(FULL, enter[0] || enter[1]) == 0) continue;

      for (int e = lane; e < k; e += 32) {
        mv[e] = tv[e];
        mi[e] = ti[e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mv[k + lane + 32 * h] = enter[h] ? s[h] : NEG_LARGE;
        mi[k + lane + 32 * h] = enter[h] ? g[h] : -1;
      }
      __syncwarp();
      for (int slot = 0; slot < k; ++slot) {
        float bv = NEG_LARGE;
        int bi = 0x7fffffff, bp = 0;
        for (int e = lane; e < k + TILE; e += 32) {
          if (before(mv[e], mi[e], bv, bi)) {
            bv = mv[e];
            bi = mi[e];
            bp = e;
          }
        }
        warp_first(bv, bi, bp);
        if (bv <= VALID) {  // the rest are empty
          for (int e = slot + lane; e < k; e += 32) {
            tv[e] = NEG_LARGE;
            ti[e] = -1;
          }
          break;
        }
        if (lane == 0) {
          tv[slot] = bv;
          ti[slot] = bi;
          mv[bp] = NEG_LARGE;
          mi[bp] = -1;
        }
        __syncwarp();
      }
      __syncwarp();
    }
    __syncthreads();  // the score tile is rewritten by the next live tile
  }

  for (int e = threadIdx.x; e < TILE * k; e += THREADS) {
    out_v[(long long)row0 * k + e] = top_v[e];
    out_i[(long long)row0 * k + e] = top_i[e];
  }
  for (int e = threadIdx.x; e < TILE; e += THREADS) out_c[row0 + e] = cnt[e];
}

template <typename T>
int launch(const void* x, const void* y, const void* mask, void* out_v, void* out_i,
           void* out_c, int n_rows, int n_cols, int m, int block_m, int block_n,
           int row_offset, int col_offset, int n_valid_cols, float threshold, int k,
           int exclude_self, void* stream) {
  if (n_rows % block_m || n_cols % block_n || block_m % TILE || block_n % TILE || m % TK ||
      k < 1)
    return cudaErrorInvalidValue;
  const size_t smem = fused_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_kernel<T><<<n_rows / TILE, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const int*>(mask),
      static_cast<float*>(out_v), static_cast<int*>(out_i), static_cast<int*>(out_c), n_cols,
      m, n_cols / block_n, block_m, block_n, row_offset, col_offset, n_valid_cols, threshold,
      k, exclude_self);
  return cudaGetLastError();
}

}  // namespace apss

// x (n_rows, m), y (n_cols, m) row-major; mask (n_rows/block_m, n_cols/block_n)
// int32; out_v/out_i (n_rows, k); out_c (n_rows). Returns a cudaError_t code.
extern "C" int apss_fused_f32(const void* x, const void* y, const void* mask, void* out_v,
                              void* out_i, void* out_c, int n_rows, int n_cols, int m,
                              int block_m, int block_n, int row_offset, int col_offset,
                              int n_valid_cols, float threshold, int k, int exclude_self,
                              void* stream) {
  return apss::launch<float>(x, y, mask, out_v, out_i, out_c, n_rows, n_cols, m, block_m,
                             block_n, row_offset, col_offset, n_valid_cols, threshold, k,
                             exclude_self, stream);
}

extern "C" int apss_fused_bf16(const void* x, const void* y, const void* mask, void* out_v,
                               void* out_i, void* out_c, int n_rows, int n_cols, int m,
                               int block_m, int block_n, int row_offset, int col_offset,
                               int n_valid_cols, float threshold, int k, int exclude_self,
                               void* stream) {
  return apss::launch<uint16_t>(x, y, mask, out_v, out_i, out_c, n_rows, n_cols, m, block_m,
                                block_n, row_offset, col_offset, n_valid_cols, threshold, k,
                                exclude_self, stream);
}
