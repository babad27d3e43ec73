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
// Design. The TPU kernel walks a (b, q head, kv block) grid, block_k = 1024
// positions a step, carrying (m, l, acc) from step to step on one core.
// Here the length is split over thread blocks, in two launches:
//   1. decode_partials: one block of 256 threads per (kv split, kv head,
//      b), grid (ceil(L / split), Hkv, B), each covering `split` cache
//      positions (decode_attention.py::decode_split) for all G q heads that
//      share the kv head, so each cache row is read once for the whole
//      group. A block whose split starts at or past n exits at once, and
//      positions at or past n are never read (the TPU kernel's dead-tile
//      skip, at row granularity). A row of D values is read by D / 4
//      lanes, one 4-value load each; each lane keeps U rows of K and V in
//      flight, and every lane group keeps its own running (m, l, acc) in
//      registers, rescaled once per U rows. The block merges its lane
//      groups' partials in shared memory and writes the split's (acc, m, l)
//      to device scratch (B, Hq, n_splits, D + 2) f32.
//   2. merge_splits: one block per (b, q head), a thread per output
//      column, merges its ceil(n / split) live splits in increasing split
//      order by combine_partials' rule:
//      m* = max m_s, w_s = exp(m_s - m*), acc = sum acc_s w_s,
//      l = sum l_s w_s (n = 0: m* = NEG_LARGE, acc = l = 0).
// No atomics: every sum runs in a fixed order, so a call's bits do not
// change from run to run. The grid depends on L, never on the lengths, and
// nothing is read back to the host, so the launch pair can be captured in
// a CUDA graph.
//
// Bound: device memory. The cache rows read, 2 * n * D * bytes per
// (b, kv head), dominate; at qwen3-1.7b's decode shapes (B = 8, Hkv = 8,
// L = 32768, D = 128, bfloat16, lengths summing to 93,667) that is 384 MB
// a layer, 0.115 ms at 3.35 TB/s. Split 2048 gives 400 live blocks, about
// 3 an SM, where one block per (b, kv head) kept 64 SMs busy and left one
// 32,767-long sequence to 8 of them.
// Head dims 16, 32, 64 and 128; groups of 1, 2, 4 and 8 q heads.
#include <cstdint>
#include <cuda_runtime.h>

namespace da {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;               // rows in flight per lane group
constexpr int MERGE_THREADS = 160; // phase 2: D + 1 threads used, D up to 128
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

// Phase 1: the partial of split blockIdx.x of (b, kv head) for its G q heads.
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_partials(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ lengths, float* __restrict__ part, int Hq, int Hkv,
                int L, int split, int n_splits, float scale) {
  using Sh = Shape<D>;
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n = max(0, min(lengths[b], L));
  const int r0 = s * split;
  if (r0 >= n) return;  // the whole block: a dead split
  const int r1 = min(n, r0 + split);

  extern __shared__ __align__(16) float smem[];
  float* part_a = smem;                          // (PARTS, G, D)
  float* part_m = part_a + Sh::PARTS * G * D;    // (PARTS, G)
  float* part_l = part_m + Sh::PARTS * G;        // (PARTS, G)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / Sh::LPR, sl = lane % Sh::LPR;
  const int pt = warp * Sh::RPW + sub;

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

  for (int base = r0; base < r1; base += U * Sh::STEP) {
    float4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + (u * WARPS + warp) * Sh::RPW + sub;
      ok[u] = r < r1;
      if (ok[u]) {
        kr[u] = load4(kb + (long long)r * D);
        vr[u] = load4(vb + (long long)r * D);
      } else {
        kr[u] = vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc[U], mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = qv[g][0] * kr[u].x;
        d = fmaf(qv[g][1], kr[u].y, d);
        d = fmaf(qv[g][2], kr[u].z, d);
        d = fmaf(qv[g][3], kr[u].w, d);
#pragma unroll
        for (int off = Sh::LPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
        sc[u] = d;
        if (ok[u]) mx = fmaxf(mx, d);
      }
      // One rescale for the U rows: alpha = 1 when no row raised the max.
      const float alpha = expf(m[g] - mx);
      float ps = 0.f, pa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? expf(sc[u] - mx) : 0.f;
        ps += p;
        pa[0] = fmaf(p, vr[u].x, pa[0]);
        pa[1] = fmaf(p, vr[u].y, pa[1]);
        pa[2] = fmaf(p, vr[u].z, pa[2]);
        pa[3] = fmaf(p, vr[u].w, pa[3]);
      }
      l[g] = fmaf(l[g], alpha, ps);
#pragma unroll
      for (int c = 0; c < 4; ++c) a[g][c] = fmaf(a[g][c], alpha, pa[c]);
      m[g] = mx;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* pa = part_a + (pt * G + g) * D + sl * 4;
    pa[0] = a[g][0];
    pa[1] = a[g][1];
    pa[2] = a[g][2];
    pa[3] = a[g][3];
    if (sl == 0) {
      part_m[pt * G + g] = m[g];
      part_l[pt * G + g] = l[g];
    }
  }
  __syncthreads();

  // Merge the lane groups' partials in lane-group order: m* = max m_p,
  // w_p = exp(m_p - m*), acc = sum acc_p w_p, l = sum l_p w_p.
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
    float* out = part + (((long long)b * Hq + hk * G + g) * n_splits + s) * (D + 2);
    out[d] = sa;
    if (d == 0) {
      out[D] = ms;
      out[D + 1] = sl_;
    }
  }
}

// Phase 2: one block per (b, q head) merges its live splits in split order,
// a thread per output column (D of them, and one more for l). Each thread
// takes m* itself (a max, exact in any order) and its column's sum in
// increasing split order; the splits' loads are independent, so they
// overlap.
template <int D>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_splits(const float* __restrict__ part, const int* __restrict__ lengths,
             float* __restrict__ acc_out, float* __restrict__ m_out, float* __restrict__ l_out,
             int Hq, int L, int split, int n_splits) {
  const long long row = blockIdx.x;  // b * Hq + h
  const int d = threadIdx.x;
  if (d > D) return;
  const int n = max(0, min(lengths[row / Hq], L));
  const int live = (n + split - 1) / split;
  const float* p = part + row * n_splits * (D + 2);
  float ms = NEG_LARGE;
  for (int s = 0; s < live; ++s) ms = fmaxf(ms, p[s * (D + 2) + D]);
  const int col = d < D ? d : D + 1;  // thread D sums l
  float sum = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s)
    sum = fmaf(p[s * (D + 2) + col], expf(p[s * (D + 2) + D] - ms), sum);
  if (d < D) {
    acc_out[row * D + d] = sum;
  } else {
    m_out[row] = ms;
    l_out[row] = sum;
  }
}

template <typename T, int D, int G>
int launch_dg(const void* q, const void* k, const void* v, const void* lengths, void* part,
              void* acc, void* m, void* l, int B, int Hq, int Hkv, int L, int split,
              float scale, cudaStream_t stream) {
  const int smem = smem_floats<D, G>() * (int)sizeof(float);
  auto kern = decode_partials<T, D, G>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int n_splits = (L + split - 1) / split;
  kern<<<dim3(n_splits, Hkv, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(part), Hq, Hkv, L, split, n_splits,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_splits<D><<<(unsigned)B * Hq, MERGE_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(lengths),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), Hq, L, split,
      n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* lengths, void* part,
             void* acc, void* m, void* l, int B, int Hq, int Hkv, int L, int split,
             float scale, cudaStream_t stream) {
#define DA_GROUP(G)                                                                        \
  case G:                                                                                  \
    return launch_dg<T, D, G>(q, k, v, lengths, part, acc, m, l, B, Hq, Hkv, L, split, scale, \
                              stream);
  switch (Hq / Hkv) {
    DA_GROUP(1)
    DA_GROUP(2)
    DA_GROUP(4)
    DA_GROUP(8)
    default: return cudaErrorInvalidValue;
  }
#undef DA_GROUP
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* part,
           void* acc, void* m, void* l, int B, int Hq, int Hkv, int L, int D, int split,
           float scale, void* stream_) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || Hq % Hkv || L < 1 || split < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
#define DA_DIM(D)                                                                          \
  case D:                                                                                  \
    return launch_d<T, D>(q, k, v, lengths, part, acc, m, l, B, Hq, Hkv, L, split, scale, \
                          stream);
  switch (D) {
    DA_DIM(16)
    DA_DIM(32)
    DA_DIM(64)
    DA_DIM(128)
    default: return cudaErrorInvalidValue;
  }
#undef DA_DIM
}

}  // namespace da

// q (B, Hq, D), k and v (B, Hkv, L, D) row-major and of one type, lengths
// (B,) int32; part (B, Hq, ceil(L / split), D + 2) float32 scratch; acc
// (B, Hq, D), m and l (B, Hq) float32. Returns a cudaError_t code.
#define DA_ENTRY(SUFFIX, T)                                                                \
  extern "C" int decode_attention_##SUFFIX(const void* q, const void* k, const void* v,   \
                                           const void* lengths, void* part, void* acc,    \
                                           void* m, void* l, int B, int Hq, int Hkv, int L, \
                                           int D, int split, float scale, void* stream) { \
    return da::launch<T>(q, k, v, lengths, part, acc, m, l, B, Hq, Hkv, L, D, split, scale, \
                         stream);                                                          \
  }

DA_ENTRY(f32, float)
DA_ENTRY(bf16, uint16_t)

// Message of a status code returned by the entry points.
extern "C" const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
