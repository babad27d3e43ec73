// K7: thresholded dense score matrix -- out = where(X . Y^T >= t & live,
// X . Y^T, 0), with the product skipped on tiles the block mask declares
// dead.
//
// Replaces src/repro/kernels/apss_block/apss_block.py::apss_block_pallas
// (_apss_block_kernel).
//
// Design. The TPU kernel walks an (i, j, kf) grid with a VMEM accumulator
// and writes each block_m x block_n output tile once, at the last feature
// step. Here one thread block of two warpgroups owns one BM x BN output
// tile (128 x 128): each warpgroup multiplies its 64 rows by the BN
// columns on the tensor cores (wgmma, NH columns an accumulator), the sum
// in registers. Features stream through a ring of STAGES cp.async stages,
// each 128 bytes of every row (32 f32 or 64 bf16 features: one 128-byte
// swizzle row; rows past the operand's edge and features past m are
// zero-filled). Tiles are numbered
// in grouped order, GROUP row tiles at a time and column by column within
// a group, so the blocks resident at once share a few row and column
// strips in the 50 MB L2 (X and Y of radikal are 3.78 GB each; there
// row-major order measured the same, tools/kernel_ab.py k7_tile). A tile is
// live when any block-mask entry that covers it is nonzero (the mask stays
// at the caller's block_m x block_n granularity, multiples of 64); a dead
// tile reads no operand and writes its zeros. Each score is also held to
// its own mask entry, so the mask's meaning is unchanged. The epilogue
// writes where(acc >= t, acc, 0) once, as f32.
//
// Numerics. bf16 inputs take one bf16 wgmma pass (m64nNk16): the products
// are exact in f32 and summed in f32, the arithmetic of a widened FMA in
// another order. f32 inputs are split, x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna: nearest, ties away from zero), and each
// score sums hi.hi + hi.lo + lo.hi in f32 over three tf32 wgmma passes
// (m64nNk8). Why this is f32-accurate: hi keeps 11 significant bits, so
// |x - hi| <= 2^-11 |x|, x - hi is exact in f32, and rounding it to lo
// costs at most 2^-11 |x - hi| <= 2^-22 |x|; tf32 x tf32 products (22 bits)
// are exact in f32. Against x.y the three terms miss lo_x.lo_y (<= 2^-22
// |x.y|) and the two roundings of lo (<= 2^-21 |x.y| together): at most
// 3 * 2^-22 ~ 7.2e-7 |x_i y_i| a product, so for unit vectors (sum |x_i
// y_i| <= 1) the score is within ~7.2e-7 plus the f32 rounding of the
// sums. The tensor cores add each wgmma's products into the f32
// accumulator with truncation, not rounding to nearest: summed over all m
// features that drifts a unit vector's self-score down by several 1e-6 on
// radikal (tools/kernel_ab.py k7_tile measures it; PERF.md). So each
// stage's wgmmas start from 0 (STAGE_SUMS) and the stage's sum is added to
// a running sum in registers by an f32 add that rounds to nearest; the
// truncation then spans 32 features, and the score stays within ~1e-6 of
// the exact product, a tenth of the 1e-5 the port holds its scores to. The
// running sum costs BN / 2 registers a thread beside the NH / 2 of the
// accumulator: a 128 x 256 tile (two accumulator halves a stage) needs 255
// registers and spills, for a few percent (tools/kernel_ab.py k7_tile), so
// the tile is 128 x 128.
// apss_block.py::apss_block_split_plain computes the same split in plain
// PyTorch. The A operand (the tile's rows) is split in registers, read by
// each thread from the landed stage in the wgmma fragment layout; the B
// operand (its columns) is split in shared memory after its stage lands,
// hi in place and lo in a second buffer, while the previous stage's
// wgmmas run.
//
// Bound: the tensor cores on live tiles, 2 m FLOP per score a pass (three
// tf32 passes at 495 TFLOP/s for f32, one bf16 pass at 989), and, kept
// beside it, the same 2 m FLOP at the 67 TFLOP/s f32 FMA rate of the
// kernel this design replaced; plus writing the n_rows x n_cols f32 output
// once.
#include "apss_common.cuh"

namespace apss {
namespace k7 {

constexpr int BM = 128;       // rows of an output tile: two warpgroups of 64
constexpr int BN = 128;       // columns of an output tile: NH or 2 NH
constexpr int NH = 128;       // columns of one wgmma accumulator (64 registers a thread)
constexpr int F32_STAGES = BN == NH ? 4 : 3;  // ring stages of the f32 path (bf16: 4)
constexpr bool STAGE_SUMS = true;  // a stage's wgmma sum starts from 0 (see Numerics)
constexpr int GROUP = 8;      // row tiles a group of the grouped tile order
constexpr int WG = 128;       // threads of a warpgroup
constexpr int NT = 2 * WG;    // threads of a block
constexpr int ROW = 128;      // bytes of a staged row: one 128-byte swizzle row
static_assert(BN == NH || BN == 2 * NH, "a tile is one or two accumulator widths");
static_assert(STAGE_SUMS || BN == NH, "without stage sums the accumulator holds the tile");

template <typename T>
struct Shape {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int STAGES = F32 ? F32_STAGES : 4;  // ring stages
  static constexpr int PKE = ROW / (int)sizeof(T);  // features a stage
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int B_BYTES = BN * ROW;
  static constexpr int SLOT = A_BYTES + B_BYTES;
  static constexpr int LO = F32 ? 2 * B_BYTES : 0;  // B's lo parts, two stages
  static constexpr int SMEM = STAGES * SLOT + LO + 1024;  // + alignment of the swizzle
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor of a K-major operand in 128-byte swizzle:
// 8-row groups 1024 bytes apart (stride byte offset), start address and
// offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16z(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// This thread's generic-proxy writes to shared memory (cp.async, stores)
// become visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to registers an asynchronous MMA
// reads or writes across its issue or its wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// x rounded to tf32 (nearest, ties away from zero), as f32 bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (64 x 128) (+)= A (64 x 8, tf32 fragments in registers) . B (128 x 8,
// K-major in shared memory)^T; scale_d = 0 overwrites d.
__device__ __forceinline__ void mma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 128) (+)= A (64 x 16, K-major in shared memory) . B (128 x 16,
// K-major in shared memory)^T, bf16; scale_d = 0 overwrites d.
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Stage := features [k0, k0 + PKE) of the tile's BM rows at x (rows at or
// past x_rows zero) and BN rows at y (past y_rows zero), row stride m,
// features at or past m zero: row r's 16-byte chunk c goes to chunk c ^ (r
// % 8) of the row, as the 128-byte swizzle reads it. B's rows follow A's.
template <typename T>
__device__ __forceinline__ void load_stage(uint32_t dst, const T* __restrict__ x, int x_rows,
                                           const T* __restrict__ y, int y_rows, long long m,
                                           long long k0) {
  constexpr int E = 16 / (int)sizeof(T);  // elements a chunk
#pragma unroll
  for (int i = 0; i < (BM + BN) * 8 / NT; ++i) {
    const int u = threadIdx.x + i * NT, r = u >> 3, c = u & 7;
    const bool in_x = r < BM;
    const int rr = in_x ? r : r - BM;
    const long long f = k0 + c * E;
    const bool ok = rr < (in_x ? x_rows : y_rows) && f < m;
    const T* src = (in_x ? x : y) + (long long)rr * m + f;
    cp_async16z(dst + r * ROW + ((c ^ (r & 7)) << 4), ok ? src : x, ok);
  }
}

// B's stage at b (f32) := its tf32 hi parts in place, lo parts at lo (same
// layout).
__device__ __forceinline__ void split_b(float* b, float* lo) {
#pragma unroll
  for (int i = 0; i < BN * ROW / 16 / NT; ++i) {
    const int u = threadIdx.x + i * NT;
    float4 v = reinterpret_cast<float4*>(b)[u];
    float4 h = make_float4(__uint_as_float(tf32(v.x)), __uint_as_float(tf32(v.y)),
                           __uint_as_float(tf32(v.z)), __uint_as_float(tf32(v.w)));
    reinterpret_cast<float4*>(b)[u] = h;
    reinterpret_cast<float4*>(lo)[u] =
        make_float4(__uint_as_float(tf32(v.x - h.x)), __uint_as_float(tf32(v.y - h.y)),
                    __uint_as_float(tf32(v.z - h.z)), __uint_as_float(tf32(v.w - h.w)));
  }
}

// This thread's tf32 A fragments of the stage (f32 rows at a, swizzled), hi
// and lo, for the stage's four k8 steps: fragment register j of step s
// holds row 16 * warp + g + 8 * (j & 1), feature 8 * s + t + 4 * (j >> 1)
// of the warpgroup's 64 rows (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void split_a(const unsigned char* a, uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned char* row = a + (((threadIdx.x >> 5) & 3) * 16 + g) * ROW + 4 * t;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = *reinterpret_cast<const float*>(
          row + (j & 1) * 8 * ROW + (((2 * s + (j >> 1)) ^ g) << 4));
      hi[s][j] = tf32(v);
      lo[s][j] = tf32(v - __uint_as_float(hi[s][j]));
    }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
apss_block_tc(const T* __restrict__ x, const T* __restrict__ y, const int* __restrict__ mask,
              float* __restrict__ out, int n_rows, int n_cols, long long m, int mask_cols,
              int block_m, int block_n, float threshold) {
  using Sh = Shape<T>;
  constexpr int S = Sh::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle atoms align
  const uint32_t base = smem_u32(smem);

  // Grouped tile order.
  const int n_tm = (n_rows + BM - 1) / BM, n_tn = (n_cols + BN - 1) / BN;
  const int per_group = GROUP * n_tn, gid = blockIdx.x / per_group, in = blockIdx.x % per_group;
  const int first = gid * GROUP, gsize = n_tm - first < GROUP ? n_tm - first : GROUP;
  const int row0 = (first + in % gsize) * BM, col0 = (in / gsize) * BN;
  const int x_rows = n_rows - row0 < BM ? n_rows - row0 : BM;
  const int y_rows = n_cols - col0 < BN ? n_cols - col0 : BN;

  // Liveness: of the tile (any covering entry), and of this thread's scores
  // (its warpgroup's 64 rows lie in one mask row; 64-column group j).
  const int wg = threadIdx.x / WG, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  bool tile_live = false;
  for (int r = 0; r < x_rows; r += 64)
    for (int c = 0; c < y_rows; c += 64)
      tile_live |= mask[(long long)((row0 + r) / block_m) * mask_cols + (col0 + c) / block_n] != 0;
  bool live[BN / 64];
  const int wrow0 = row0 + 64 * wg;
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
    live[j] = wrow0 < n_rows && 64 * j < y_rows &&
              mask[(long long)(wrow0 / block_m) * mask_cols + (col0 + 64 * j) / block_n] != 0;

  // acc: one NH-column half of the tile's stage sum (the whole sum without
  // STAGE_SUMS); run: the running sums of the tile's BN columns, half by
  // half, laid out as one m64nBN accumulator would be.
  float acc[NH / 2], run[STAGE_SUMS ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (STAGE_SUMS ? BN / 2 : 1); ++i) run[i] = 0.f;
  const int scale0 = STAGE_SUMS ? 0 : 1;  // scale_d of a stage's first wgmma

  if (tile_live) {  // the same for every thread of the block
    const T* xt = x + (long long)row0 * m;
    const T* yt = y + (long long)col0 * m;
    const int nk = (int)((m + Sh::PKE - 1) / Sh::PKE);
    auto slot = [&](int s) { return base + s * Sh::SLOT; };
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s < nk) load_stage<T>(slot(s), xt, x_rows, yt, y_rows, m, (long long)s * Sh::PKE);
      cp_async_commit();  // an empty group keeps the count of groups uniform
    }
    float* lo = reinterpret_cast<float*>(smem + S * Sh::SLOT);
    if constexpr (Sh::F32) {  // stage 0's B split before the loop
      cp_async_wait<S - 1>();
      __syncthreads();
      split_b(reinterpret_cast<float*>(smem + Sh::A_BYTES), lo);
    } else {
      cp_async_wait<S - 1>();
    }
    fence_async_shared();
    __syncthreads();

    for (int c = 0; c < nk; ++c) {
      const int s = c % S;
      const uint32_t a_addr = slot(s) + wg * 64 * ROW, b_addr = slot(s) + Sh::A_BYTES;
      uint32_t ahi[4][4], alo[4][4];
      if constexpr (Sh::F32) split_a(smem + s * Sh::SLOT + wg * 64 * ROW, ahi, alo);
      const uint32_t l_addr = smem_u32(lo) + (c & 1) * Sh::B_BYTES;
#pragma unroll
      for (int h = 0; h < BN / NH; ++h) {  // the tile's column halves, one accumulator
        const uint32_t bh = b_addr + h * NH * ROW, lh = l_addr + h * NH * ROW;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if constexpr (Sh::F32) {
            mma_tf32(acc, ahi[k], desc(bh + 32 * k), k == 0 ? scale0 : 1);
            mma_tf32(acc, ahi[k], desc(lh + 32 * k), 1);
            mma_tf32(acc, alo[k], desc(bh + 32 * k), 1);
          } else {
            mma_bf16(acc, desc(a_addr + 32 * k), desc(bh + 32 * k), k == 0 ? scale0 : 1);
          }
        }
        wgmma_commit();
        if (h == 0 && c + 1 < nk) {  // the next stage lands (f32: and its B is split) meanwhile
          cp_async_wait<S - 2>();
          if constexpr (Sh::F32) {
            __syncthreads();
            const int s1 = (c + 1) % S;
            split_b(reinterpret_cast<float*>(smem + s1 * Sh::SLOT + Sh::A_BYTES),
                    lo + ((c + 1) & 1) * (Sh::B_BYTES / 4));
          }
          fence_async_shared();
        }
        wgmma_wait_all();
        pin(acc);
        if constexpr (STAGE_SUMS) {
#pragma unroll
          for (int i = 0; i < NH / 2; ++i) run[h * NH / 2 + i] += acc[i];
        }
      }
      if constexpr (Sh::F32) {
        pin(ahi);
        pin(alo);
      }
      __syncthreads();  // stage c + 1 is in place for everyone, stage c free
      if (c + S < nk) load_stage<T>(slot(s), xt, x_rows, yt, y_rows, m, (long long)(c + S) * Sh::PKE);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }

  // Epilogue: run[i] (acc[i]) is row 16 * warp + g + 8 * ((i >> 1) & 1) of
  // the warpgroup's 64, column 8 * (i >> 2) + 2 * t + (i & 1) of the tile.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow0 + 16 * warp + g + 8 * h;
    if (row >= n_rows) continue;
    float* o = out + (long long)row * n_cols + col0 + 2 * t;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4) {
      const int j = i >> 5;  // 64-column group
      if (64 * j >= y_rows) continue;
      float v0 = acc[i + 2 * h], v1 = acc[i + 2 * h + 1];
      if constexpr (STAGE_SUMS) {
        v0 = run[i + 2 * h];
        v1 = run[i + 2 * h + 1];
      }
      *reinterpret_cast<float2*>(o + 8 * (i >> 2)) =
          make_float2(live[j] && v0 >= threshold ? v0 : 0.f, live[j] && v1 >= threshold ? v1 : 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* mask, void* out, int n_rows, int n_cols,
           int m, int block_m, int block_n, float threshold, void* stream) {
  if (n_rows < 1 || n_cols < 1 || m < 1 || n_rows % block_m || n_cols % block_n ||
      block_m % 64 || block_n % 64 || m % TK)
    return cudaErrorInvalidValue;
  auto kern = apss_block_tc<T>;
  const int smem = Shape<T>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((n_rows + BM - 1) / BM) * ((n_cols + BN - 1) / BN);
  kern<<<(unsigned)tiles, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const int*>(mask),
      static_cast<float*>(out), n_rows, n_cols, m, n_cols / block_n, block_m, block_n,
      threshold);
  return cudaGetLastError();
}

}  // namespace k7
}  // namespace apss

// x (n_rows, m), y (n_cols, m) row-major; mask (n_rows/block_m, n_cols/block_n)
// int32; out (n_rows, n_cols) f32. Returns a cudaError_t code.
extern "C" int apss_block_f32(const void* x, const void* y, const void* mask, void* out,
                              int n_rows, int n_cols, int m, int block_m, int block_n,
                              float threshold, void* stream) {
  return apss::k7::launch<float>(x, y, mask, out, n_rows, n_cols, m, block_m, block_n,
                                 threshold, stream);
}

extern "C" int apss_block_bf16(const void* x, const void* y, const void* mask, void* out,
                               int n_rows, int n_cols, int m, int block_m, int block_n,
                               float threshold, void* stream) {
  return apss::k7::launch<uint16_t>(x, y, mask, out, n_rows, n_cols, m, block_m, block_n,
                                    threshold, stream);
}
