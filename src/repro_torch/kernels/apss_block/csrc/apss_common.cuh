// Shared pieces of the APSS self-join kernels for Hopper (sm_90a).
//
// ring_tile: the pipelined body of K1, K4 and K6 (bottom of this file): a BM x
//   BN tile of X . Y^T over a feature range, streamed through a ring of
//   cp.async stages in shared memory (the next stages' copies in flight
//   while one is multiplied), each thread owning RM x RN scores and reading
//   its rows and columns four features at a time. Each score is one fmaf
//   chain from 0 in increasing feature order, the order of score_tile and
//   score_strip_part below.
//
// score_tile: one 64 x 64 tile of X . Y^T in float32, by plain FMA in
//   registers. 256 threads each own a 4 x 4 block of the tile. Feature
//   chunks of 32 are staged in shared memory, transposed so that each
//   thread reads its 4 rows and 4 columns as two float4 loads per feature;
//   the next chunk is loaded from device memory into registers while the
//   current one is multiplied. Each score sums its products in increasing
//   feature order, one fmaf at a time. Inputs are float32 or bfloat16
//   (as raw 16-bit words, widened exactly to float32); the sum is float32.
//
// tile_packets: the two-phase body of the worklist kernels K2 and K3 (one
//   thread block per worklist entry t; the caller passes the operand
//   pointers of the tile's row and column blocks). A block_m x block_n tile
//   of f32 scores (256 KB at 256 x 256) does not fit a block's 227 KB of
//   shared memory, so it goes to a device scratch buffer the wrapper
//   allocates, (T, block_m, block_n) f32. Phase 1 computes the tile as
//   64 x 64 sub-tiles with score_tile and writes them to scratch; after a
//   block barrier, phase 2 selects from it:
//     forward: one warp per tile row: keep s >= t, grow != gcol,
//       grow < n_valid, gcol < n_valid; count them; top-k by
//       (value desc, gcol asc) in min(k, count) rounds of warp-wide
//       selection over the row held in registers (select_packet);
//     mirror (ib != jb): one warp per tile column, the same kept set read
//       down the column, ids grow (not gcol); on a diagonal tile the mirror
//       packet is empty with count 0.
//   Scratch costs 4 * block_m * block_n bytes per worklist entry; its
//   traffic (written once, read twice, mostly from L2) is small next to the
//   tile's 2 * block_m * block_n * m FLOP. Tiles are at most 256 x 256
//   (eight register slots per lane in phase 2).
//
// score_strip_part: K5's strip of 16 * RM query rows by 64 corpus rows
//   over one feature chunk (RM = 1, 2 or 4 rows a thread, chosen from
//   block_q so that a block of 8 query rows wastes at most half of its
//   strip), staged through shared memory as score_tile. K4 and K6 score
//   through ring_tile instead (rect_tiles.cuh); all three select a row's
//   packet with rect_row_packet: keep s >= t and gcol < nc_valid (no
//   self-exclusion: queries are not corpus rows), count them and select
//   the top-k (select_packet).
//
// Summation order of a rectangular score (K4, K5, K6): the features are cut
//   into chunks of FK (the last one ragged); each chunk's partial is one
//   fmaf chain from 0 in increasing feature order (score_strip_part in K5,
//   ring_tile in K4 and K6), and the score is 0 + partial_0 + partial_1 +
//   ... in increasing chunk order. This order is part of the K4 = K5 = K6
//   contract: each computes a tile's partials on different thread blocks
//   and adds them in the same order, so their packets are bit-identical.
//
// Top-k order: (value descending, global id ascending) -- the order the
//   reference's first-position max-extraction gives when column tiles are
//   scanned in ascending order. Empty slots are (NEG_LARGE, -1).
//
// Bound: the self-join kernels are bound by float32 FMA throughput at the shapes of
//   the self-join (2 m FLOP per score against 8 bytes of input per row
//   pair, m in the hundreds to the hundred thousands); TF32 and the tensor
//   cores are not used, so the card's non-tensor f32 peak is the bound.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace apss {

constexpr int TILE = 64;           // rows and columns of one score tile
constexpr int TK = 32;             // feature chunk staged in shared memory
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 scores each
constexpr int WARPS = THREADS / 32;
constexpr int LDS = TILE + 4;      // padded row of a staged chunk (float4-aligned)
constexpr float NEG_LARGE = -0.5e30f;
constexpr float VALID = -0.25e30f; // values above this are real candidates
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_BLOCK = 256;     // largest worklist tile side (tile_packets)
constexpr int MAX_QBLOCK = 128;    // largest query block of the rect kernels
constexpr int MAX_EE_K = 256;      // largest k of the values buffer (merge_values)
constexpr int FK = 1024;           // features per partial sum of a rectangular score
static_assert(FK % TK == 0, "a summation chunk is a whole number of staged chunks");

struct Staged {
  float a[TK * LDS];
  float b[TK * LDS];
};

// Four consecutive input values widened to float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {  // bfloat16 bits
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Rows [0, 64) of `src` (row stride m), features [k0, k0 + 32): each thread
// loads two float4s, 8 threads per row.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, long long m,
                                           int k0, float4 (&reg)[2]) {
  const int r = threadIdx.x >> 3, f = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) reg[h] = load4(src + (long long)(r + 32 * h) * m + k0 + f);
}

__device__ __forceinline__ void store_chunk(float* dst, const float4 (&reg)[2]) {
  const int r = threadIdx.x >> 3, f = (threadIdx.x & 7) * 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* d = dst + f * LDS + r + 32 * h;
    d[0] = reg[h].x;
    d[LDS] = reg[h].y;
    d[2 * LDS] = reg[h].z;
    d[3 * LDS] = reg[h].w;
  }
}

// acc[i][j] = X[ty*4 + i] . Y[tx*4 + j] for the 64 rows at x and at y
// (m a multiple of 32, both row blocks 16-byte aligned).
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ x, const T* __restrict__ y,
                                           long long m, Staged& st, float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float4 ra[2], rb[2];
  load_chunk(x, m, 0, ra);
  load_chunk(y, m, 0, rb);
  for (long long k0 = 0; k0 < m; k0 += TK) {
    __syncthreads();  // every thread is done reading the previous chunk
    store_chunk(st.a, ra);
    store_chunk(st.b, rb);
    __syncthreads();
    if (k0 + TK < m) {
      load_chunk(x, m, (int)(k0 + TK), ra);
      load_chunk(y, m, (int)(k0 + TK), rb);
    }
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&st.a[kk * LDS + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&st.b[kk * LDS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// (v, id) comes before (bv, bid) in the top-k order.
__device__ __forceinline__ bool before(float v, int id, float bv, int bid) {
  return v > bv || (v == bv && id < bid);
}

// Warp-wide first (v, id, pos) in the top-k order; every lane gets it.
__device__ __forceinline__ void warp_first(float& v, int& id, int& pos) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oid = __shfl_xor_sync(FULL, id, o);
    const int opos = __shfl_xor_sync(FULL, pos, o);
    if (before(ov, oid, v, id)) {
      v = ov;
      id = oid;
      pos = opos;
    }
  }
}

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

// Forward and mirror packets of worklist entry t, tile (ib, jb): xb holds
// the tile's block_m rows and yb its block_n columns, both with row stride m.
// fv/fi/fc are (T, block_m, k|k|1) and bv/bi/bc (T, block_n, k|k|1).
template <typename T>
__device__ void tile_packets(const T* __restrict__ xb, const T* __restrict__ yb, long long m,
                             int t, int ib, int jb, int block_m, int block_n, int n_valid,
                             float threshold, int k, Staged& st, float* scratch,
                             float* __restrict__ fv, int* __restrict__ fi,
                             int* __restrict__ fc, float* __restrict__ bv,
                             int* __restrict__ bi, int* __restrict__ bc) {
  float* s = scratch + (long long)t * block_m * block_n;
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
  for (int r = warp; r < block_m; r += WARPS) {  // forward packet: rows of block ib
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

  for (int c = warp; c < block_n; c += WARPS) {  // mirror packet: rows of block jb
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

// ---------------------------------------------------------------------------
// Rectangular tiles (K4, K5, K6)
// ---------------------------------------------------------------------------

// Rows [0, 16 * RM) of `src` (row stride m), features [k0, k0 + 32); rows
// at or past `rows` read as 0. Thread i loads the float4 i and i + 256.
template <int RM, typename T>
__device__ __forceinline__ void load_strip(const T* __restrict__ src, int rows, long long m,
                                           long long k0, float4 (&reg)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = threadIdx.x + h * THREADS, r = i >> 3, f = (i & 7) * 4;
    reg[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < 16 * RM * 8 && r < rows) reg[h] = load4(src + (long long)r * m + k0 + f);
  }
}

template <int RM>
__device__ __forceinline__ void store_strip(float* dst, const float4 (&reg)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = threadIdx.x + h * THREADS, r = i >> 3, f = (i & 7) * 4;
    if (i < 16 * RM * 8) {
      float* d = dst + f * LDS + r;
      d[0] = reg[h].x;
      d[LDS] = reg[h].y;
      d[2 * LDS] = reg[h].z;
      d[3 * LDS] = reg[h].w;
    }
  }
}

// acc[i][j] = the partial of X[ty*RM + i] . Y[tx*4 + j] over features
// [0, len) for a strip of 16 * RM rows at x (rows at or past x_rows are 0)
// and the 64 rows at y, both at row stride m: one fmaf chain from 0 in
// increasing feature order, as score_tile sums. len is a multiple of 32.
// x and y may differ in type (f32 queries against a bf16 corpus).
template <int RM, typename TX, typename TY>
__device__ __forceinline__ void score_strip_part(const TX* __restrict__ x, int x_rows,
                                                 const TY* __restrict__ y, long long m, int len,
                                                 Staged& st, float (&acc)[RM][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float4 ra[2], rb[2];
  load_strip<RM>(x, x_rows, m, 0, ra);
  load_chunk(y, m, 0, rb);
  for (int k0 = 0; k0 < len; k0 += TK) {
    __syncthreads();  // every thread is done reading the previous chunk
    store_strip<RM>(st.a, ra);
    store_chunk(st.b, rb);
    __syncthreads();
    if (k0 + TK < len) {
      load_strip<RM>(x, x_rows, m, k0 + TK, ra);
      load_chunk(y, m, (int)(k0 + TK), rb);
    }
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float av[RM];
      if constexpr (RM == 4) {
        const float4 a = *reinterpret_cast<const float4*>(&st.a[kk * LDS + ty * 4]);
        av[0] = a.x;
        av[1] = a.y;
        av[2] = a.z;
        av[3] = a.w;
      } else if constexpr (RM == 2) {
        const float2 a = *reinterpret_cast<const float2*>(&st.a[kk * LDS + ty * 2]);
        av[0] = a.x;
        av[1] = a.y;
      } else {
        av[0] = st.a[kk * LDS + ty];
      }
      const float4 b = *reinterpret_cast<const float4*>(&st.b[kk * LDS + tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// a[0, k) := the k largest of a[0, k) and b[0, k), both sorted descending
// (values only). One warp: each entry's place in the merged order is its
// own index plus the entries of the other list before it (a first on
// ties), so the merge needs no sort. a and b are shared memory.
__device__ __forceinline__ void merge_values(float* a, const float* b, int k) {
  constexpr int Q = MAX_EE_K / 32;
  const int lane = threadIdx.x & 31;
  float va[Q], vb[Q];
  int ra[Q], rb[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int e = q * 32 + lane;
    ra[q] = rb[q] = k;  // past the end: not written
    if (e < k) {
      va[q] = a[e];
      vb[q] = b[e];
      int na = 0, nb = 0;
      for (int j = 0; j < k; ++j) {
        na += b[j] > va[q];
        nb += a[j] >= vb[q];
      }
      ra[q] = e + na;
      rb[q] = e + nb;
    }
  }
  __syncwarp();  // every lane has read a before any lane writes it
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (ra[q] < k) a[ra[q]] = va[q];
    if (rb[q] < k) a[rb[q]] = vb[q];
  }
  __syncwarp();
}

// Row r's forward packet from its block_c scores srow: keep s >= t and
// gcol < nc_valid, count them and select the top-k (one warp). With Global,
// srow lies in device memory written by other thread blocks of this launch
// and is read through L2 (__ldcg), never from a stale L1 line.
template <bool Global>
__device__ __forceinline__ void rect_row_packet(const float* srow, int block_c, int gcol0,
                                                int nc_valid, float threshold, int k,
                                                float* out_v, int* out_i, int* out_c) {
  const int lane = threadIdx.x & 31;
  float v[MAX_BLOCK / 32];
  int id[MAX_BLOCK / 32];
  int count = 0;
#pragma unroll
  for (int q = 0; q < MAX_BLOCK / 32; ++q) {
    const int c = q * 32 + lane;
    bool ok = false;
    float sv = NEG_LARGE;
    if (c < block_c) {
      const int gcol = gcol0 + c;
      sv = Global ? __ldcg(srow + c) : srow[c];
      ok = sv >= threshold && gcol < nc_valid;
      id[q] = ok ? gcol : -1;
    } else {
      id[q] = -1;
    }
    v[q] = ok ? sv : NEG_LARGE;
    count += __popc(__ballot_sync(FULL, ok));
  }
  select_packet(v, id, count, k, out_v, out_i, out_c);
}

// ---------------------------------------------------------------------------
// Pipelined tiles (K1, K4, K6): a ring of cp.async stages
// ---------------------------------------------------------------------------

constexpr int PK = 32;  // features per stage of the ring

// 16 bytes from global to shared memory, asynchronously; with !valid the 16
// bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory layout of a ring of STAGES stages, each holding features
// [k0, k0 + PK) of BM rows of X (type TX) and BN rows of Y (type TY), row
// by row. A row is padded by 16 bytes (36 floats, 40 bf16 words), so the 8
// (f32) or 16 (bf16) threads of one access phase reading 8 consecutive rows
// at one feature hit distinct banks (f32; bf16 at most two-way).
template <int BM, int BN, int STAGES, typename TX, typename TY>
struct Ring {
  static constexpr int LDX = PK + 16 / (int)sizeof(TX);
  static constexpr int LDY = PK + 16 / (int)sizeof(TY);
  static constexpr size_t X_BYTES = size_t(BM) * LDX * sizeof(TX);
  static constexpr size_t STAGE = X_BYTES + size_t(BN) * LDY * sizeof(TY);
  static constexpr size_t BYTES = STAGES * STAGE;
};

// Stage `stage` := features [k0, k0 + PK) of the BM rows at x (row stride
// m; rows at or past x_rows zero) and the BN rows at y (past y_rows zero),
// as NT threads' 16-byte cp.async copies, consecutive threads along a row.
template <int BM, int BN, int STAGES, int NT, typename TX, typename TY>
__device__ __forceinline__ void ring_load(unsigned char* ring, int stage,
                                          const TX* __restrict__ x, int x_rows,
                                          const TY* __restrict__ y, int y_rows, long long m,
                                          long long k0) {
  using R = Ring<BM, BN, STAGES, TX, TY>;
  TX* sx = reinterpret_cast<TX*>(ring + stage * R::STAGE);
  TY* sy = reinterpret_cast<TY*>(ring + stage * R::STAGE + R::X_BYTES);
  constexpr int EX = 16 / sizeof(TX), EY = 16 / sizeof(TY);  // elements per copy
  constexpr int UX = PK / EX, UY = PK / EY;                    // copies per row
  for (int u = threadIdx.x; u < BM * UX; u += NT) {
    const int r = u / UX, p = (u % UX) * EX;
    const bool ok = r < x_rows;
    cp_async16(sx + r * R::LDX + p, ok ? x + (long long)r * m + k0 + p : x, ok);
  }
  for (int u = threadIdx.x; u < BN * UY; u += NT) {
    const int r = u / UY, p = (u % UY) * EY;
    const bool ok = r < y_rows;
    cp_async16(sy + r * R::LDY + p, ok ? y + (long long)r * m + k0 + p : y, ok);
  }
}

// acc[i][j] = X[ty + TYN*i] . Y[tx + TXN*j] over features [0, len) of the
// BM rows at x (rows at or past x_rows read as 0) and the BN rows at y (past
// y_rows 0), both at row stride m, for the thread (ty, tx) = (tid / TXN,
// tid % TXN) of NT = (BM / RM) * (BN / RN): one fmaf chain from 0 in
// increasing feature order per score, the order of score_tile and
// score_strip_part, so the bits are theirs. len is a multiple of PK; x, y
// and m * sizeof are 16-byte aligned.
//
// The features stream through STAGES ring stages by cp.async: while stage
// c is multiplied, the copies of stages c + 1 .. c + STAGES - 1 are in
// flight, and one barrier per stage both publishes the landed copies and
// frees the stage the next copy overwrites. Each thread reads its RM rows
// and RN columns four features at a time (one 16-byte load each), so a
// stage costs RM + RN loads per 4 * RM * RN fmaf. Rows are strided by TYN
// and columns by TXN, so a warp's loads of one row fall on consecutive
// padded rows (distinct banks). Ends with every copy landed and every
// thread past its last read of the ring.
template <int BM, int BN, int RM, int RN, int STAGES, typename TX, typename TY>
__device__ __forceinline__ void ring_tile(const TX* __restrict__ x, int x_rows,
                                          const TY* __restrict__ y, int y_rows, long long m,
                                          int len, unsigned char* ring, float (&acc)[RM][RN]) {
  using R = Ring<BM, BN, STAGES, TX, TY>;
  constexpr int TXN = BN / RN, TYN = BM / RM, NT = TXN * TYN;
  static_assert(STAGES >= 2, "a ring has at least two stages");
  const int tx = threadIdx.x % TXN, ty = threadIdx.x / TXN;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  const int nk = len / PK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      ring_load<BM, BN, STAGES, NT>(ring, s, x, x_rows, y, y_rows, m, (long long)s * PK);
    cp_async_commit();  // an empty group keeps the count of groups uniform
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage c have landed
    __syncthreads();  // everyone's have, and everyone is done with stage c - 1
    const int nxt = c + STAGES - 1;
    if (nxt < nk)
      ring_load<BM, BN, STAGES, NT>(ring, nxt % STAGES, x, x_rows, y, y_rows, m,
                                    (long long)nxt * PK);
    cp_async_commit();
    const unsigned char* st = ring + (c % STAGES) * R::STAGE;
    const TX* sx = reinterpret_cast<const TX*>(st) + ty * R::LDX;
    const TY* sy = reinterpret_cast<const TY*>(st + R::X_BYTES) + tx * R::LDY;
#pragma unroll
    for (int kk = 0; kk < PK; kk += 4) {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = load4(sx + i * TYN * R::LDX + kk);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float4 b = load4(sy + j * TXN * R::LDY + kk);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace apss

// Message of a status code returned by the entry points.
extern "C" const char* apss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
