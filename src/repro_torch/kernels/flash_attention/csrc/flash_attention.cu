// K8: causal (or full) GQA flash attention, forward -- the prefill path.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_flash_kernel).
//
// Computes, per (batch b, q head h), out = softmax(scale * q . k^T) . v over
// the kv head h / (Hq / Hkv), with q (B, Hq, S, D) and k, v (B, Hkv, S, D)
// row-major, float32 or bfloat16. As in the TPU kernel, q is widened and
// scaled in float32, scores, the running row max m, the running row sum l
// and the accumulator are float32, the causal mask writes the finite
// NEG_LARGE, and out = acc / (l == 0 ? 1 : l) is stored in the input type.
//
// Design. The TPU kernel walks a (b, h, q block, kv block) grid with
// 512 x 512 VMEM tiles and carries (m, l, acc) in scratch across the kv
// axis. Here one thread block owns one 64-row q tile of one (b, h) and
// walks the kv tiles itself, up to the diagonal when causal (the tiles
// above it are never loaded: the TPU kernel's @pl.when skip). 256 threads
// as 16 x 16; thread (ty, tx) owns rows 4ty..4ty+3 of the tile: scores of
// columns 4tx..4tx+3 of each kv tile, and output columns tx + 16 j. The
// row statistics are reduced over the 16 threads of a row group with warp
// shuffles, so m and l live in registers, as does the accumulator.
// Shared memory holds q^T (scaled, f32), one kv buffer that holds K^T for
// the score product and then V for the value product, and P^T: 87 KB at
// D = 128, so two blocks share an SM. The next tile is loaded into
// registers while the current one is multiplied. Products are plain f32
// FMA (no tensor cores, no TF32), in increasing d for a score and
// increasing key for an output. Blocks take q tiles from the last one
// down, so the longest causal rows start first.
//
// Bound: float32 FMA. A causal pass does 2 * 2 * S^2 * D / 2 FLOP per
// (b, h) (the two products on the lower triangle); at (2, 16, 4096, 128)
// that is 137 GFLOP, 2.05 ms at the card's 67 TFLOP/s float32 peak,
// against 50 MB of inputs and outputs (0.015 ms at 3.35 TB/s).
// Head dims 16, 32, 64 and 128; S a multiple of 64 (the ops layer pads).
#include <cstdint>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float4 load4(const uint16_t* p) {  // bfloat16 bits
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(uint16_t* p, float x) {  // round to nearest even
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    *p = static_cast<uint16_t>((u >> 16) | 0x40u);  // quiet NaN
    return;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  *p = static_cast<uint16_t>(u >> 16);
}

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
  return fa::launch<uint16_t>(q, k, v, out, B, Hq, Hkv, S, D, scale, causal, stream);
}

// Message of a status code returned by the entry points.
extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
