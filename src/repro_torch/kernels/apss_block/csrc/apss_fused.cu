// K1: streaming fused APSS join -- X . Y^T, threshold, self-exclusion,
// per-row top-k and exact counts; the score matrix never reaches device
// memory.
//
// Replaces src/repro/kernels/apss_block/fused.py::apss_fused_pallas
// (_fused_kernel, _merge_topk).
//
// Design. The TPU kernel walks its (i, j, kf) grid in order and carries a
// row block's running top-k across j in VMEM scratch. Hopper's blocks run
// in no order, so the columns are cut into S segments (whole 128-column
// tiles; fused.py::fused_segments picks S so that the grid of row tiles x
// segments fills the card) and launches replace the carry over j:
//   0. fused_kernel_occupancy, once for x and once for y unless y is x: for
//      each 128-row tile and each chunk of PK = 32 features, one bit that
//      says some row of the tile is nonzero there, and one that says some
//      entry is not finite (Inf or NaN). One block per (tile, 1,024
//      features) reads its rows once in 16-byte loads; the bitmaps are
//      (tiles, 2, ceil(m / 1,024)) words, 58 KB at radikal.
//   1. fused_kernel: one thread block per (128-row tile, segment) walks the
//      segment's 128 x 128 score tiles in ascending column order. A tile
//      is skipped when every entry of the block mask that covers it is 0
//      (the mask stays at the caller's block_m x block_n granularity, and
//      each score is also held to its own entry, so its meaning is
//      unchanged). A live tile is one ring_walk (apss_common.cuh) over the
//      chunks in which both tiles hold a nonzero or either a non-finite
//      value (ChunkWalk), in increasing feature order: the features stream
//      through a 3-stage (f32) or 4-stage (bf16) cp.async ring, each of
//      256 threads owns 8 x 8 scores (4 fmaf per value read from shared
//      memory), each score one fmaf chain over the walked chunks. The
//      tile then goes to shared memory (it
//      aliases the ring) and one warp per row keeps s >= t, local col <
//      n_valid_cols, a live mask entry and (with exclude_self) global row
//      != global col, adds them to the exact count, drops candidates that
//      do not beat the row's current k-th entry, and merges the rest into
//      the row's sorted top-k by rank (merge_row: each entry's place is the
//      count of entries before it, no rounds of selection: on
//      clustered_65k 11.3 ms against 22.4 with k rounds of warp-wide
//      selection, NVIDIA H100 80GB HBM3 at 700 W). The running
//      top-k of the segment lives in device memory, in the block's own
//      slice of the output (S = 1) or of the scratch (S, n_rows, k); only
//      its owning warp reads and writes a row, so plain loads see its
//      writes. Thread 0 adds the tile's walked stages, and the m / PK of
//      the whole walk, to a device counter (the census and telemetry read
//      it; nothing else waits for it).
//   2. fused_merge_kernel (S > 1): one warp per row merges the S sorted
//      lists (lane s holds the head of segment s): k rounds of warp-wide
//      first-in-order selection; counts add as int32. Exact: a member of
//      the global top-k is in the top-k of its own segment.
// Order everywhere: (value desc, global id asc). Row and column offsets and
// the count of valid columns are runtime arguments (the ring schedules).
//
// Same bits as the walk over every chunk (K1 = K2 = K3): a skipped chunk
// holds only finite values and is all zero in one of the tiles, so each of
// its products is an exact +0 or -0, and fmaf(a, b, acc) with a * b = +-0
// returns acc (a chain from +0 never reaches -0). The chain over the walked
// chunks in increasing order is the whole chain less steps that change
// nothing. A chunk with an Inf or NaN is always walked (Inf * 0 is NaN).
// Zero-magnitude entries (-0) count as zero. The walk depends on the data
// alone: a dense corpus walks every chunk and pays only step 0.
//
// Bound: float32 FMA (apss_common.cuh) over the walked stages, 2 * 128^2 *
// PK FLOP each; radikal (6,912 x 136,704 padded, every tile live) walking
// every stage is 2 * 6883^2 * 136447 FLOP, 193 ms at 67 TFLOP/s. Below the
// walk's own work lies the read of the corpus (step 0, 1.1 ms at radikal).
// Shared memory per block: the ring (110,592 bytes f32, 81,920 bf16; the
// 128 x 144 f32 score tile of 73,728 bytes fits in it), 512 bytes of
// counts and 64 * (k + 128) bytes of per-warp merge area: 184,832 bytes f32
// at the largest k, FUSED_MAX_K = 1024 (227 KB allow 1,768). One block an
// SM. The walk reads its bitmaps from global memory (L1), so no m is too
// wide for it.
#include "apss_common.cuh"

namespace apss {

constexpr int FT = 128;            // rows and columns of a K1 score tile
constexpr int FRM = 8, FRN = 8;    // rows and columns of a thread's scores
constexpr int FTX = FT / FRN, FTY = FT / FRM;  // threads along the columns and the rows
constexpr int FLD = FT + 16;       // padded row of the score tile in shared memory
constexpr int FUSED_MAX_K = 1024;  // largest k (merge area; the wrapper refuses more)
constexpr int MAX_SEGMENTS = 32;   // one lane per segment in the merge

template <typename T>
struct Fused {
  static constexpr int STAGES = sizeof(T) == 4 ? 3 : 4;
  using R = Ring<FT, FT, STAGES, T, T>;
  static constexpr size_t TILE_BYTES = sizeof(float) * FT * FLD;
  static constexpr size_t REGION = R::BYTES > TILE_BYTES ? R::BYTES : TILE_BYTES;
  static constexpr size_t smem(int k) {
    return REGION + sizeof(int) * FT + (sizeof(float) + sizeof(int)) * WARPS * (k + FT);
  }
};

constexpr int OCC_WORD = 32 * PK;  // features of one bitmap word

// A 32-bit word of T values: MAG masks the non-sign bits of each, bad(w)
// says one of them is Inf or NaN.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  static constexpr unsigned MAG = 0x7fffffffu;
  __device__ static bool bad(unsigned w) { return (w & 0x7f800000u) == 0x7f800000u; }
};
template <>
struct Bits<uint16_t> {  // bfloat16 pairs
  static constexpr unsigned MAG = 0x7fff7fffu;
  __device__ static bool bad(unsigned w) {
    return (w & 0x7f80u) == 0x7f80u || (w & 0x7f800000u) == 0x7f800000u;
  }
};

// Step 0: block (j, tile) writes word j of the tile's occupancy bitmap
// (bit c: some row of rows [tile * FT, +FT) is nonzero in features
// [(32 j + c) PK, +PK)) at occ[tile][0][j] and of its non-finite bitmap at
// occ[tile][1][j]; a row of words is ceil(m / OCC_WORD) long. Thread p reads
// the 16 bytes at feature 32 j PK + p E of every RPP-th row, once each.
// With `walked`, block (0, 0) also zeroes fused_kernel's stage counter.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_kernel_occupancy(const T* __restrict__ x, int n_rows, int m,
                       unsigned* __restrict__ occ, unsigned long long* __restrict__ walked) {
  constexpr int E = 16 / sizeof(T);      // values a load
  constexpr int LPR = OCC_WORD / E;      // loads across a word's features of one row
  constexpr int RPP = THREADS / LPR;     // rows a pass: 1 (f32), 2 (bf16)
  __shared__ unsigned s_occ, s_bad;
  const int j = blockIdx.x, tile = blockIdx.y;
  const int words = (m / PK + 31) / 32;
  const int row0 = tile * FT;
  const int rows = n_rows - row0 < FT ? n_rows - row0 : FT;
  const int p = threadIdx.x % LPR;
  const long long f = (long long)j * OCC_WORD + p * E;
  if (threadIdx.x == 0) {
    s_occ = s_bad = 0;
    if (walked != nullptr && j == 0 && tile == 0) walked[0] = walked[1] = 0;
  }
  __syncthreads();
  unsigned mag = 0;
  bool bad = false;
  if (f < m) {
    const long long stride = (long long)RPP * m / E;  // in 16-byte words
    const uint4* src = reinterpret_cast<const uint4*>(x + (long long)row0 * m + f) +
                       (long long)(threadIdx.x / LPR) * (m / E);
#pragma unroll 8
    for (int r = threadIdx.x / LPR; r < rows; r += RPP, src += stride) {
      const uint4 u = __ldcs(src);  // read once: evict first
      mag |= u.x | u.y | u.z | u.w;
      bad |= Bits<T>::bad(u.x) | Bits<T>::bad(u.y) | Bits<T>::bad(u.z) | Bits<T>::bad(u.w);
    }
  }
  const unsigned bit = 1u << (p * E / PK);
  if (mag & Bits<T>::MAG) atomicOr(&s_occ, bit);
  if (bad) atomicOr(&s_bad, bit);
  __syncthreads();
  if (threadIdx.x == 0) {
    occ[(long long)tile * 2 * words + j] = s_occ;
    occ[(long long)tile * 2 * words + words + j] = s_bad;
  }
}

// K1's walk of a tile pair: the PK-feature chunks in which both row tiles
// hold a nonzero, or either a non-finite value, in increasing order, from
// their step-0 bitmaps ox and oy (occupancy words [0, words), non-finite
// words [words, 2 words)). Every thread of the block walks it alike.
struct ChunkWalk {
  const unsigned* ox;
  const unsigned* oy;
  int words, stages, j;
  unsigned w;  // the chunks of word j not yet walked
  __device__ __forceinline__ ChunkWalk(const unsigned* ox_, const unsigned* oy_, int words_)
      : ox(ox_), oy(oy_), words(words_), stages(0), j(-1), w(0) {
    for (int i = 0; i < words; ++i) stages += __popc(word(i));
  }
  __device__ __forceinline__ unsigned word(int i) const {
    return (__ldg(ox + i) & __ldg(oy + i)) | __ldg(ox + words + i) | __ldg(oy + words + i);
  }
  __device__ __forceinline__ long long next(int) {
    while (w == 0) w = word(++j);
    const int b = __ffs(w) - 1;
    w &= w - 1;
    return ((long long)j * 32 + b) * PK;
  }
};

// The row's top-k tv/ti[0, k) := the first k of its old list (a sorted
// copy in mv/mi[0, k)) and the n_new candidates at mv/mi[k, k + n_new),
// by (value desc, id asc); one warp. An entry's place in the merged order
// is the number of entries of both lists before it (an old entry's own
// index plus the candidates before it), so neither a sort nor rounds of
// selection are needed; ids are unique, so the places are distinct, and
// those past k drop out. Empty old entries sort last.
__device__ __forceinline__ void merge_row(const float* mv, const int* mi, int k, int n_new,
                                          float* tv, int* ti) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < k + n_new; e += 32) {
    const float v = mv[e];
    const int id = mi[e];
    int pos = e < k ? e : 0;
    for (int j = e < k ? k : 0; j < k + n_new; ++j)
      pos += j != e && before(mv[j], mi[j], v, id);
    if (pos < k) {
      tv[pos] = v;
      ti[pos] = id;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_kernel(const T* __restrict__ x, const T* __restrict__ y, const int* __restrict__ mask,
             const unsigned* __restrict__ occ_x, const unsigned* __restrict__ occ_y,
             unsigned long long* __restrict__ walked, float* __restrict__ seg_v, int* __restrict__ seg_i, int* __restrict__ seg_c,
             int n_rows, int n_cols, int m, int mask_cols, int block_m, int block_n,
             int row_offset, int col_offset, int n_valid_cols, float threshold, int k,
             int exclude_self, int n_segments) {
  using F = Fused<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* tile = reinterpret_cast<float*>(smem);  // aliases the ring
  int* cnt = reinterpret_cast<int*>(smem + F::REGION);
  float* mrg_v = reinterpret_cast<float*>(cnt + FT);
  int* mrg_i = reinterpret_cast<int*>(mrg_v + WARPS * (k + FT));

  const int row0 = blockIdx.x * FT, seg = blockIdx.y;
  const int x_rows = n_rows - row0 < FT ? n_rows - row0 : FT;
  const int col_tiles = (n_cols + FT - 1) / FT;
  const int ct0 = (int)((long long)seg * col_tiles / n_segments);
  const int ct1 = (int)((long long)(seg + 1) * col_tiles / n_segments);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = threadIdx.x % FTX, ty = threadIdx.x / FTX;
  float* top_v = seg_v + ((long long)seg * n_rows + row0) * k;
  int* top_i = seg_i + ((long long)seg * n_rows + row0) * k;
  for (int e = threadIdx.x; e < x_rows * k; e += THREADS) {
    top_v[e] = NEG_LARGE;
    top_i[e] = -1;
  }
  for (int e = threadIdx.x; e < FT; e += THREADS) cnt[e] = 0;
  __syncthreads();

  const int mr0 = row0 / block_m, nmr = (row0 + x_rows - 1) / block_m - mr0 + 1;
  const int words = (m / PK + 31) / 32;
  const unsigned* ox = occ_x + (long long)blockIdx.x * 2 * words;
  float* mv = mrg_v + warp * (k + FT);
  int* mi = mrg_i + warp * (k + FT);
  for (int ct = ct0; ct < ct1; ++ct) {
    const int col0 = ct * FT;
    const int y_rows = n_cols - col0 < FT ? n_cols - col0 : FT;
    const int mc0 = col0 / block_n, nmc = (col0 + y_rows - 1) / block_n - mc0 + 1;
    bool any = false;
    for (int e = threadIdx.x; e < nmr * nmc; e += THREADS)
      any |= mask[(long long)(mr0 + e / nmc) * mask_cols + mc0 + e % nmc] != 0;
    if (!__syncthreads_or(any)) continue;  // the same for every thread

    const ChunkWalk walk(ox, occ_y + (long long)ct * 2 * words, words);
    if (threadIdx.x == 0) {
      atomicAdd(walked, (unsigned long long)walk.stages);
      atomicAdd(walked + 1, (unsigned long long)(m / PK));
    }
    float acc[FRM][FRN];
    ring_walk<FT, FT, FRM, FRN, F::STAGES>(x + (long long)row0 * m, x_rows,
                                         y + (long long)col0 * m, y_rows, m, walk, ring, acc);
#pragma unroll
    for (int i = 0; i < FRM; ++i)
#pragma unroll
      for (int j = 0; j < FRN; ++j) tile[(ty + FTY * i) * FLD + tx + FTX * j] = acc[i][j];
    __syncthreads();

    for (int r = warp; r < x_rows; r += WARPS) {
      const int grow = row_offset + row0 + r;
      const int* mrow = mask + (long long)((row0 + r) / block_m) * mask_cols;
      float* tv = top_v + (long long)r * k;
      int* ti = top_i + (long long)r * k;
      float s[4];
      int g[4];
      bool ok[4];
      int n_ok = 0;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int lc = col0 + lane + 32 * h;
        s[h] = tile[r * FLD + lane + 32 * h];
        g[h] = col_offset + lc;
        ok[h] = lc < n_cols && lc < n_valid_cols && s[h] >= threshold &&
                mrow[lc / block_n] != 0 && !(exclude_self && grow == g[h]);
        n_ok += __popc(__ballot_sync(FULL, ok[h]));
      }
      if (n_ok == 0) continue;
      if (lane == 0) cnt[r] += n_ok;
      const float kv = tv[k - 1];
      const int ki = ti[k - 1];
      bool enter[4], any_enter = false;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        enter[h] = ok[h] && before(s[h], g[h], kv, ki);
        any_enter |= enter[h];
      }
      if (__ballot_sync(FULL, any_enter) == 0) continue;

      int n_new = 0;  // the entering candidates, packed after a copy of the list
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const unsigned b = __ballot_sync(FULL, enter[h]);
        if (enter[h]) {
          const int slot = k + n_new + __popc(b & ((1u << lane) - 1));
          mv[slot] = s[h];
          mi[slot] = g[h];
        }
        n_new += __popc(b);
      }
      for (int e = lane; e < k; e += 32) {
        mv[e] = tv[e];
        mi[e] = ti[e];
      }
      __syncwarp();
      merge_row(mv, mi, k, n_new, tv, ti);
      __syncwarp();
    }
    __syncthreads();  // the score tile is overwritten by the next tile's copies
  }

  for (int e = threadIdx.x; e < x_rows; e += THREADS)
    seg_c[(long long)seg * n_rows + row0 + e] = cnt[e];
}

// One warp per row: the first k of the union of the S segments' sorted
// lists, and the sum of their counts.
__global__ void __launch_bounds__(THREADS)
fused_merge_kernel(const float* __restrict__ seg_v, const int* __restrict__ seg_i,
                   const int* __restrict__ seg_c, float* __restrict__ out_v,
                   int* __restrict__ out_i, int* __restrict__ out_c, int n_rows, int k,
                   int n_segments) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= n_rows) return;  // the whole warp
  int c = lane < n_segments ? seg_c[(long long)lane * n_rows + row] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
  const float* hv = seg_v + ((long long)lane * n_rows + row) * k;
  const int* hi = seg_i + ((long long)lane * n_rows + row) * k;
  int pos = 0;
  for (int slot = 0; slot < k; ++slot) {
    float v = NEG_LARGE;
    int id = 0x7fffffff, who = lane;
    if (lane < n_segments && pos < k && hv[pos] > VALID) {
      v = hv[pos];
      id = hi[pos];
    }
    warp_first(v, id, who);
    if (v <= VALID) {  // every list is spent
      for (int e = slot + lane; e < k; e += 32) {
        out_v[row * k + e] = NEG_LARGE;
        out_i[row * k + e] = -1;
      }
      break;
    }
    if (lane == 0) {
      out_v[row * k + slot] = v;
      out_i[row * k + slot] = id;
    }
    if (lane == who) ++pos;
  }
  if (lane == 0) out_c[row] = c;
}

// Step 0 on the n_rows rows of x: the bitmaps of its row tiles into occ
// ((n_rows + FT - 1) / FT, 2, ceil(m / OCC_WORD) words); with `walked`,
// that counter zeroed.
template <typename T>
cudaError_t occupancy(const void* x, int n_rows, int m, void* occ, void* walked,
                      cudaStream_t stream) {
  const int tiles = (n_rows + FT - 1) / FT;
  if (n_rows < 1 || m % PK || m < PK || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((m + OCC_WORD - 1) / OCC_WORD, tiles);
  fused_kernel_occupancy<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), n_rows, m, static_cast<unsigned*>(occ),
      static_cast<unsigned long long*>(walked));
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* y, const void* mask, void* occ, void* walked,
           void* seg_v, void* seg_i, void* seg_c, void* out_v, void* out_i, void* out_c,
           int n_rows, int n_cols, int m, int block_m, int block_n, int row_offset,
           int col_offset, int n_valid_cols, float threshold, int k, int exclude_self,
           int n_segments, void* stream_) {
  const int col_tiles = (n_cols + FT - 1) / FT;
  if (n_rows < 1 || n_cols < 1 || n_rows % block_m || n_cols % block_n || block_m % TILE ||
      block_n % TILE || m % PK || m < PK || k < 1 || k > FUSED_MAX_K || n_segments < 1 ||
      n_segments > MAX_SEGMENTS || n_segments > col_tiles)
    return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (n_segments == 1) {  // the segment is the output
    seg_v = out_v;
    seg_i = out_i;
    seg_c = out_c;
  }
  const size_t smem = Fused<T>::smem(k);
  cudaError_t err = cudaFuncSetAttribute(fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // The bitmaps of x, then of y unless y is x, one after the other in occ.
  const long long row_words = 2LL * ((m / PK + 31) / 32);
  unsigned* occ_x = static_cast<unsigned*>(occ);
  unsigned* occ_y = occ_x;
  err = occupancy<T>(x, n_rows, m, occ_x, walked, stream);
  if (err == cudaSuccess && (y != x || n_cols != n_rows)) {
    occ_y = occ_x + (n_rows + FT - 1) / FT * row_words;
    err = occupancy<T>(y, n_cols, m, occ_y, nullptr, stream);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + FT - 1) / FT, n_segments);
  fused_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const int*>(mask),
      occ_x, occ_y, static_cast<unsigned long long*>(walked), static_cast<float*>(seg_v), static_cast<int*>(seg_i), static_cast<int*>(seg_c), n_rows,
      n_cols, m, n_cols / block_n, block_m, block_n, row_offset, col_offset, n_valid_cols,
      threshold, k, exclude_self, n_segments);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_segments == 1) return err;
  fused_merge_kernel<<<(n_rows + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      static_cast<const float*>(seg_v), static_cast<const int*>(seg_i),
      static_cast<const int*>(seg_c), static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<int*>(out_c), n_rows, k, n_segments);
  return cudaGetLastError();
}

// Blocks of fused_kernel an SM holds at once at this k, and the SM count.
template <typename T>
int capacity(int k, int* per_sm, int* sms) {
  if (k < 1 || k > FUSED_MAX_K) return cudaErrorInvalidValue;
  const size_t smem = Fused<T>::smem(k);
  cudaError_t err = cudaFuncSetAttribute(fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_kernel<T>, THREADS, smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace apss

// x (n_rows, m), y (n_cols, m) row-major, one dtype; mask (n_rows/block_m,
// n_cols/block_n) int32; occ the step-0 bitmaps' scratch, int32 words
// ((n_rows + 127) / 128 (+ (n_cols + 127) / 128 unless y is x), 2,
// ceil(m / 1024)); walked 2 int64: the stages walked and those of the
// walk over every chunk, of the live tiles; seg_v/seg_i (n_segments,
// n_rows, k) and seg_c (n_segments, n_rows) scratch (unused when
// n_segments is 1); out_v/out_i (n_rows, k); out_c (n_rows). The
// occupancy entry runs step 0 alone on x (n_rows, m) into occ. Each
// returns a cudaError_t code.
#define APSS_FUSED_ENTRIES(SUFFIX, T)                                                         \
  extern "C" int apss_fused_##SUFFIX(                                                         \
      const void* x, const void* y, const void* mask, void* occ, void* walked, void* seg_v,   \
      void* seg_i, void* seg_c, void* out_v, void* out_i, void* out_c, int n_rows,            \
      int n_cols, int m, int block_m, int block_n, int row_offset, int col_offset,            \
      int n_valid_cols, float threshold, int k, int exclude_self, int n_segments,             \
      void* stream) {                                                                         \
    return apss::launch<T>(x, y, mask, occ, walked, seg_v, seg_i, seg_c, out_v, out_i, out_c, \
                           n_rows, n_cols, m, block_m, block_n, row_offset, col_offset,       \
                           n_valid_cols, threshold, k, exclude_self, n_segments, stream);     \
  }                                                                                           \
  extern "C" int apss_fused_occupancy_##SUFFIX(const void* x, int n_rows, int m, void* occ,   \
                                               void* stream) {                                \
    return apss::occupancy<T>(x, n_rows, m, occ, nullptr,                                     \
                              static_cast<cudaStream_t>(stream));                             \
  }                                                                                           \
  extern "C" int apss_fused_capacity_##SUFFIX(int k, int* per_sm, int* sms) {                 \
    return apss::capacity<T>(k, per_sm, sms);                                                 \
  }

APSS_FUSED_ENTRIES(f32, float)
APSS_FUSED_ENTRIES(bf16, uint16_t)
