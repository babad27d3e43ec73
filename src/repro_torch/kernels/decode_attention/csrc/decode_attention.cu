// K9: flash-decode partials -- one new token per sequence against its KV
// cache, masked to the sequence's length.
//
// Replaces src/repro/kernels/decode_attention/decode_attention.py::
// decode_attention_pallas (_decode_kernel).
//
// For each batch row b and q head h, with kv head h / G (G = Hq / Hkv) and
// n = min(lengths[b], L) cache positions:
//   s_i = (scale * q) . k_i,  m = max_i s_i,  l = sum_i exp(s_i - m),
//   acc = sum_i exp(s_i - m) v_i,
// all in float32 (q and the cache are float32 or bfloat16 widened exactly),
// and writes the unnormalised partial (acc (B, Hq, D), m (B, Hq),
// l (B, Hq)). A row with n = 0 gets m = NEG_LARGE, l = 0, acc = 0, as the
// TPU kernel leaves its scratch when every kv tile is dead.
//
// Design. The TPU kernel walks a (b, q head, kv block) grid and reads each
// K/V tile once per q head. Here one thread block serves one (b, kv head)
// and all G q heads that share it, so each cache row is read once for the
// whole group; positions at or past n are never read (the TPU kernel's
// dead-tile skip, at row granularity). 512 threads; a row of D values is
// read by D / 4 lanes (one 4-value load each), so a warp covers 128 / D
// consecutive rows, 256 contiguous bytes of bfloat16, per step, and each
// lane keeps four steps of K and V in flight. The G dot products of a row
// are summed across its lanes with shuffles, and every lane group keeps
// its own running (m, l, acc) in registers. At the end the groups' partials
// are merged in shared memory by the logsumexp rule of combine_partials.
//
// Bound: device memory. The cache rows read, 2 * n * D * bytes per
// (b, kv head), dominate; at qwen3-1.7b's decode shapes (B = 8, Hkv = 8,
// L = 32768, D = 128, bfloat16) a full cache is 1.07 GB per layer, 0.32 ms
// at 3.35 TB/s. Known limit: B * Hkv blocks (64 here) fill half of the 132
// SMs; splitting the length over more blocks is later work.
// Head dims 16, 32, 64 and 128; groups of 1, 2, 4 and 8 q heads.
#include <cstdint>
#include <cuda_runtime.h>

namespace da {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;               // rows in flight per lane group
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

template <int D>
struct Shape {
  static constexpr int LPR = D / 4;          // lanes per cache row
  static constexpr int RPW = 32 / LPR;       // rows per warp step
  static constexpr int PARTS = WARPS * RPW;  // lane groups of a block
  static constexpr int STEP = WARPS * RPW;   // rows of a block step
};

template <int D, int G>
constexpr int smem_floats() {
  return Shape<D>::PARTS * G * (D + 2);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS, 1)
decode_partials(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ lengths, float* __restrict__ acc_out,
                float* __restrict__ m_out, float* __restrict__ l_out, int Hq, int Hkv, int L,
                float scale) {
  using Sh = Shape<D>;
  extern __shared__ __align__(16) float smem[];
  float* part_a = smem;                          // (PARTS, G, D)
  float* part_m = part_a + Sh::PARTS * G * D;    // (PARTS, G)
  float* part_l = part_m + Sh::PARTS * G;        // (PARTS, G)

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / Sh::LPR, sl = lane % Sh::LPR;
  const int part = warp * Sh::RPW + sub;
  const int n = max(0, min(lengths[b], L));

  float qv[G][4], m[G], l[G], a[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 t = load4(q + ((long long)b * Hq + hk * G + g) * D + sl * 4);
    qv[g][0] = t.x * scale;
    qv[g][1] = t.y * scale;
    qv[g][2] = t.z * scale;
    qv[g][3] = t.w * scale;
    m[g] = NEG_LARGE;
    l[g] = 0.f;
    a[g][0] = a[g][1] = a[g][2] = a[g][3] = 0.f;
  }
  const T* kb = k + ((long long)b * Hkv + hk) * L * D + sl * 4;
  const T* vb = v + ((long long)b * Hkv + hk) * L * D + sl * 4;

  for (int base = 0; base < n; base += U * Sh::STEP) {
    float4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + (u * WARPS + warp) * Sh::RPW + sub;
      ok[u] = r < n;
      if (ok[u]) {
        kr[u] = load4(kb + (long long)r * D);
        vr[u] = load4(vb + (long long)r * D);
      } else {
        kr[u] = vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = qv[g][0] * kr[u].x;
        s = fmaf(qv[g][1], kr[u].y, s);
        s = fmaf(qv[g][2], kr[u].z, s);
        s = fmaf(qv[g][3], kr[u].w, s);
#pragma unroll
        for (int off = Sh::LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
        if (ok[u]) {
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
          a[g][0] = fmaf(p, vr[u].x, a[g][0] * alpha);
          a[g][1] = fmaf(p, vr[u].y, a[g][1] * alpha);
          a[g][2] = fmaf(p, vr[u].z, a[g][2] * alpha);
          a[g][3] = fmaf(p, vr[u].w, a[g][3] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* pa = part_a + (part * G + g) * D + sl * 4;
    pa[0] = a[g][0];
    pa[1] = a[g][1];
    pa[2] = a[g][2];
    pa[3] = a[g][3];
    if (sl == 0) {
      part_m[part * G + g] = m[g];
      part_l[part * G + g] = l[g];
    }
  }
  __syncthreads();

  // Merge the lane groups' partials: m* = max m_p, w_p = exp(m_p - m*),
  // acc = sum acc_p w_p, l = sum l_p w_p.
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float ms = NEG_LARGE;
    for (int p = 0; p < Sh::PARTS; ++p) ms = fmaxf(ms, part_m[p * G + g]);
    float sa = 0.f, sl_ = 0.f;
    for (int p = 0; p < Sh::PARTS; ++p) {
      const float w = expf(part_m[p * G + g] - ms);
      sa = fmaf(part_a[(p * G + g) * D + d], w, sa);
      sl_ = fmaf(part_l[p * G + g], w, sl_);
    }
    const long long row = (long long)b * Hq + hk * G + g;
    acc_out[row * D + d] = sa;
    if (d == 0) {
      m_out[row] = ms;
      l_out[row] = sl_;
    }
  }
}

template <typename T, int D, int G>
int launch_dg(const void* q, const void* k, const void* v, const void* lengths, void* acc,
              void* m, void* l, int B, int Hq, int Hkv, int L, float scale, void* stream) {
  const int smem = smem_floats<D, G>() * (int)sizeof(float);
  auto kern = decode_partials<T, D, G>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hkv, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), Hq, Hkv, L, scale);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* lengths, void* acc,
             void* m, void* l, int B, int Hq, int Hkv, int L, float scale, void* stream) {
  switch (Hq / Hkv) {
    case 1: return launch_dg<T, D, 1>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, scale, stream);
    case 2: return launch_dg<T, D, 2>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, scale, stream);
    case 4: return launch_dg<T, D, 4>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, scale, stream);
    case 8: return launch_dg<T, D, 8>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* acc, void* m,
           void* l, int B, int Hq, int Hkv, int L, int D, float scale, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hq % Hkv || L < 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace da

// q (B, Hq, D), k and v (B, Hkv, L, D) row-major and of one type, lengths
// (B,) int32; acc (B, Hq, D), m and l (B, Hq) float32. Returns a
// cudaError_t code.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* lengths, void* acc, void* m, void* l, int B,
                                    int Hq, int Hkv, int L, int D, float scale, void* stream) {
  return da::launch<float>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, D, scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* acc, void* m, void* l, int B,
                                     int Hq, int Hkv, int L, int D, float scale, void* stream) {
  return da::launch<uint16_t>(q, k, v, lengths, acc, m, l, B, Hq, Hkv, L, D, scale, stream);
}

// Message of a status code returned by the entry points.
extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
