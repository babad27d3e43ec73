// K8: causal (or full) GQA flash attention, forward -- the prefill path.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_flash_kernel).
//
// Computes, per (batch b, q head h), out = softmax(scale * q . k^T) . v over
// the kv head h / (Hq / Hkv), with q (B, Hq, S, D) and k, v (B, Hkv, S, D)
// row-major, float32 or bfloat16. Scores, the running row max m, the
// running row sum l and the accumulator are float32, the causal mask writes
// the finite NEG_LARGE, and out = acc / (l == 0 ? 1 : l) is stored in the
// input type. Causal kv tiles above the diagonal are never loaded (the TPU
// kernel's @pl.when skip), and thread blocks take q tiles from the last one
// down, so the longest causal rows start first. Head dims 16, 32, 64 and
// 128; S a multiple of 64 (the ops layer pads). Two kernels:
//
// flash_forward_tc (bfloat16, the model's type): Hopper's warpgroup MMA.
//   One warpgroup (128 threads) owns one 64-row q tile of one (b, h) and
//   walks 64-key kv tiles. S = Q . K^T is wgmma m64n64k16 with Q and K in
//   shared memory (128-byte swizzled, K-major); the scale goes onto the f32
//   scores, so q enters the product exactly. The online softmax runs on the
//   accumulator's own layout (two rows a thread, a quad of lanes a row), in
//   base 2 with log2(e) folded into the scale. P is rounded to bf16 in
//   registers, where the accumulator layout is already the A-operand
//   layout, and O += P . V is wgmma m64n{64,128}k16 with V in shared memory
//   (the same swizzled tile, read MN-major). K and V tiles arrive by
//   cp.async into a two-stage ring: tile j + 1 loads while tile j is
//   multiplied. Head dims under 64 are held in 64-wide tiles whose extra
//   columns are zero (QK^T steps over D only; P . V's extra output columns
//   are dropped). 80 KB of shared memory at D = 128: two blocks an SM.
//   Differences from the TPU kernel: P enters P . V as bf16 (the TPU kernel
//   keeps it f32), and exp is exp2 of scores scaled by log2(e).
//
// flash_forward (float32): plain f32 FMA, no tensor cores (TF32 keeps too
//   few digits for the f32 path's checks). 256 threads as 16 x 16; thread
//   (ty, tx) owns rows 4ty..4ty+3 of the tile: scores of columns 4tx..4tx+3
//   of each kv tile, and output columns tx + 16 j; row statistics reduced
//   with 16-lane shuffles. Shared memory holds q^T (scaled, f32), one kv
//   buffer holding K^T and then V, and P^T: 87 KB at D = 128. The next tile
//   loads into registers while the current one is multiplied. Sums in
//   increasing d for a score and increasing key for an output.
//
// Bound: a causal pass does 2 * 2 * S^2 * D / 2 FLOP per (b, h) (the two
// products on the lower triangle); at (2, 16, 4096, 128) that is 137 GFLOP:
// 0.139 ms at the card's 989 TFLOP/s bf16 tensor-core peak (the bf16
// kernel), 2.05 ms at its 67 TFLOP/s float32 peak (the f32 kernel), against
// 50 MB of inputs and outputs in bf16 (0.015 ms at 3.35 TB/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fa {

constexpr int BQ = 64;             // q rows per block
constexpr int BK = 64;             // keys per kv tile
constexpr int THREADS = 256;       // 16 x 16
constexpr int LDS = BQ + 4;        // stride of a transposed (d-major) tile
constexpr float NEG_LARGE = -0.5e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

template <int D>
struct Shape {
  static constexpr int VEC = D / 16;   // float4 loads per thread for a 64-row tile
  static constexpr int CPT = D / 16;   // output columns per thread
  static constexpr int LDV = D + 4;    // stride of a row-major V tile
  static constexpr int KV = D * LDS > BK * LDV ? D * LDS : BK * LDV;
  static constexpr int SMEM_FLOATS = D * LDS + KV + BK * LDS;
};

// A 64-row tile (rows of D values) into registers, one float4 per (row, 4 d).
// Lanes run along the rows, so the transposed stores below hit 32 banks.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* src, float4 (&r)[Shape<D>::VEC], int tid) {
#pragma unroll
  for (int it = 0; it < Shape<D>::VEC; ++it) {
    const int idx = tid + it * THREADS;
    r[it] = load4(src + (long long)(idx & 63) * D + (idx >> 6) * 4);
  }
}

template <int D>
__device__ __forceinline__ void store_transposed(float* dst, const float4 (&r)[Shape<D>::VEC],
                                                 int tid, float mul) {
#pragma unroll
  for (int it = 0; it < Shape<D>::VEC; ++it) {
    const int idx = tid + it * THREADS;
    float* p = dst + (idx >> 6) * 4 * LDS + (idx & 63);
    p[0] = r[it].x * mul;
    p[LDS] = r[it].y * mul;
    p[2 * LDS] = r[it].z * mul;
    p[3 * LDS] = r[it].w * mul;
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float4 (&r)[Shape<D>::VEC], int tid) {
#pragma unroll
  for (int it = 0; it < Shape<D>::VEC; ++it) {
    const int idx = tid + it * THREADS;
    *reinterpret_cast<float4*>(dst + (idx & 63) * Shape<D>::LDV + (idx >> 6) * 4) = r[it];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_forward(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, int Hq, int Hkv, int S, float scale, int causal) {
  using Sh = Shape<D>;
  constexpr int CPT = Sh::CPT;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // q^T, scaled: (D, LDS)
  float* kv = qt + D * LDS;       // K^T (D, LDS), then V (BK, LDV)
  float* pt = kv + Sh::KV;        // P^T: (BK, LDS)

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long qrow0 = ((long long)b * Hq + h) * S + (long long)qi * BQ;
  const T* kb = k + ((long long)b * Hkv + hk) * S * D;
  const T* vb = v + ((long long)b * Hkv + hk) * S * D;
  const int nk = causal ? qi + 1 : S / BK;

  float4 stage[Sh::VEC];
  load_tile<T, D>(q + qrow0 * D, stage, tid);
  store_transposed<D>(qt, stage, tid, scale);
  load_tile<T, D>(kb, stage, tid);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_LARGE;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    __syncthreads();  // the previous value product is done with kv and pt
    store_transposed<D>(kv, stage, tid, 1.f);
    load_tile<T, D>(vb + (long long)j * BK * D, stage, tid);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kv + d * LDS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(av[i], cv[jj], s[i][jj]);
    }
    if (causal && j == qi) {  // the diagonal tile: key c is visible to row r iff r >= c
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (ty * 4 + i < tx * 4 + jj) s[i][jj] = NEG_LARGE;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        sum += p;
        pt[(tx * 4 + jj) * LDS + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every score read K; P is complete
    store_rows<D>(kv, stage, tid);
    if (j + 1 < nk) load_tile<T, D>(kb + (long long)(j + 1) * BK * D, stage, tid);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pt + c * LDS + ty * 4);
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float vv = kv[c * Sh::LDV + tx + 16 * jj];
        acc[0][jj] = fmaf(p.x, vv, acc[0][jj]);
        acc[1][jj] = fmaf(p.y, vv, acc[1][jj]);
        acc[2][jj] = fmaf(p.z, vv, acc[2][jj]);
        acc[3][jj] = fmaf(p.w, vv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* o = out + (qrow0 + ty * 4 + i) * D;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) store1(o + tx + 16 * jj, acc[i][jj] / den);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
             int S, float scale, int causal, void* stream) {
  const int smem = Shape<D>::SMEM_FLOATS * (int)sizeof(float);
  auto kern = flash_forward<T, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(S / BQ, Hq, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, S, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int S, int D, float scale, int causal, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hq % Hkv || Hq > 65535 || S < BQ || S % BQ)
    return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, out, B, Hq, Hkv, S, scale, causal, stream);
    case 32: return launch_d<T, 32>(q, k, v, out, B, Hq, Hkv, S, scale, causal, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, B, Hq, Hkv, S, scale, causal, stream);
    case 128: return launch_d<T, 128>(q, k, v, out, B, Hq, Hkv, S, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (warpgroup MMA)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WG_THREADS = 128;    // one warpgroup
constexpr int ROW_BYTES = 128;     // a swizzled row: 64 bf16
constexpr int BLOCK_BYTES = 64 * ROW_BYTES;  // 64 rows x 64 columns of a tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32) | (1ull << 62);
}

// Q or K: rows along M or N, 64 d a swizzled row, 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return desc(addr, 16, 1024); }

// V read MN-major: 64 d a swizzled row (one key), 8-key groups 1024 B apart,
// the next 64 d one block (64 keys) further.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc(addr, BLOCK_BYTES, 1024);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// Keeps the compiler from moving accesses to an accumulator across the
// asynchronous MMA's issue or wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64) {+}= A (64 x 16, K-major in shared memory) . B (64 x 16,
// K-major in shared memory)^T; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, bf16 fragments in registers) . B (16 x 64,
// MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16, bf16 fragments in registers) . B (16 x 128,
// MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Rows [0, 64) of a row-major (., D) bf16 matrix at src into the swizzled
// tile at dst: 16-byte chunk c of row r goes to column block c / 8, chunk
// (c % 8) ^ (r % 8) of the row, as the 128-byte swizzle reads it.
template <int D>
__device__ __forceinline__ void load_tile_swizzled(uint32_t dst, const uint16_t* src, int tid) {
  constexpr int CPR = D / 8;  // chunks a row
#pragma unroll
  for (int i = 0; i < 64 * CPR / WG_THREADS; ++i) {
    const int idx = tid + i * WG_THREADS, r = idx / CPR, c = idx % CPR;
    cp_async16(dst + (c >> 3) * BLOCK_BYTES + r * ROW_BYTES + (((c & 7) ^ (r & 7)) << 4),
               src + r * D + c * 8);
  }
}

template <int D>
struct TcShape {
  static constexpr int DP = D < 64 ? 64 : D;        // tile width in shared memory
  static constexpr int TILE_BYTES = 64 * DP * 2;
  static constexpr int SMEM = 5 * TILE_BYTES + 1024;  // Q, K x 2, V x 2, alignment
};

template <int N>
__device__ __forceinline__ void pv_step(float (&o)[N / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void pv_step<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n64k16(o, a, b);
}
template <>
__device__ __forceinline__ void pv_step<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n128k16(o, a, b);
}

}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::WG_THREADS)
flash_forward_tc(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int Hq, int Hkv,
                 int S, float scale_log2, int causal) {
  using namespace tc;
  using Sh = TcShape<D>;
  constexpr int DP = Sh::DP, TB = Sh::TILE_BYTES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 B
  const uint32_t sq = base, sk = base + TB, sv = base + 3 * TB;

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r_lo = warp * 16 + g;  // this thread's rows of the tile: r_lo, r_lo + 8
  const long long qrow0 = ((long long)b * Hq + h) * S + (long long)qi * BQ;
  const uint16_t* kb = k + ((long long)b * Hkv + hk) * S * D;
  const uint16_t* vb = v + ((long long)b * Hkv + hk) * S * D;
  const int nk = causal ? qi + 1 : S / BK;

  if (D < 64) {  // columns past D read as 0
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (base - raw));
    for (int i = tid; i < 5 * TB / 16; i += WG_THREADS) z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  load_tile_swizzled<D>(sq, q + qrow0 * D, tid);
  load_tile_swizzled<D>(sk, kb, tid);
  load_tile_swizzled<D>(sv, vb, tid);
  cp_async_commit();

  float o[DP / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = NEG_LARGE;
    l[i] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    const uint32_t kt = sk + (j & 1) * TB, vt = sv + (j & 1) * TB;
    if (j + 1 < nk) {  // the other stage was released by the barrier that ended tile j - 1
      load_tile_swizzled<D>(sk + ((j + 1) & 1) * TB, kb + (long long)(j + 1) * BK * D, tid);
      load_tile_swizzled<D>(sv + ((j + 1) & 1) * TB, vb + (long long)(j + 1) * BK * D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();  // tile j (and Q) is in shared memory for every thread

    float s[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BLOCK_BYTES + (kk & 3) * 32;
      wgmma_ss_m64n64k16(s, desc_kmajor(sq + off), desc_kmajor(kt + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // Online softmax, base 2. s[i]: row r_lo + 8 * ((i >> 1) & 1), key
    // 8 * (i >> 2) + c2 + (i & 1) of the tile.
    const bool diag = causal && j == qi;
    float mx[2] = {NEG_LARGE, NEG_LARGE};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = (i >> 1) & 1;
      float x = s[i] * scale_log2;
      if (diag && 8 * (i >> 2) + c2 + (i & 1) > r_lo + 8 * hi) x = NEG_LARGE;
      s[i] = x;
      mx[hi] = fmaxf(mx[hi], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(FULL, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(FULL, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi]);
      alpha[hi] = exp2f(m[hi] - m_new);
      m[hi] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m[hi]);
      sum[hi] += s[i];
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) l[hi] = alpha[hi] * l[hi] + sum[hi];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    uint32_t p[4][4];  // P as the A operand of four k16 steps over the keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pv_step<DP>(o, p[kk], desc_mnmajor(vt + kk * 16 * ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(FULL, l[hi], 1);
    l[hi] += __shfl_xor_sync(FULL, l[hi], 2);
    l[hi] = l[hi] == 0.f ? 1.f : l[hi];
  }
  uint16_t* o_lo = out + (qrow0 + r_lo) * D + c2;
  uint16_t* o_hi = o_lo + 8 * D;
#pragma unroll
  for (int jb = 0; jb < D / 8; ++jb) {
    *reinterpret_cast<uint32_t*>(o_lo + 8 * jb) =
        pack_bf16(o[4 * jb] / l[0], o[4 * jb + 1] / l[0]);
    *reinterpret_cast<uint32_t*>(o_hi + 8 * jb) =
        pack_bf16(o[4 * jb + 2] / l[1], o[4 * jb + 3] / l[1]);
  }
}

template <int D>
int launch_tc_d(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
             int S, float scale, int causal, void* stream) {
  const int smem = tc::TcShape<D>::SMEM;
  auto kern = flash_forward_tc<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(S / BQ, Hq, B);
  kern<<<grid, tc::WG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), Hq, Hkv, S, scale * tc::LOG2E,
      causal);
  return cudaGetLastError();
}

int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int S, int D, float scale, int causal, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hq % Hkv || Hq > 65535 || S < BQ || S % BQ)
    return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_tc_d<16>(q, k, v, out, B, Hq, Hkv, S, scale, causal, stream);
    case 32: return launch_tc_d<32>(q, k, v, out, B, Hq, Hkv, S, scale, causal, stream);
    case 64: return launch_tc_d<64>(q, k, v, out, B, Hq, Hkv, S, scale, causal, stream);
    case 128: return launch_tc_d<128>(q, k, v, out, B, Hq, Hkv, S, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}


}  // namespace fa

// q (B, Hq, S, D), k and v (B, Hkv, S, D), out (B, Hq, S, D), all row-major
// and of one type. Returns a cudaError_t code.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                   int Hq, int Hkv, int S, int D, float scale, int causal,
                                   void* stream) {
  return fa::launch<float>(q, k, v, out, B, Hq, Hkv, S, D, scale, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                    int Hq, int Hkv, int S, int D, float scale, int causal,
                                    void* stream) {
  return fa::launch_tc(q, k, v, out, B, Hq, Hkv, S, D, scale, causal, stream);
}

// Message of a status code returned by the entry points.
extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
