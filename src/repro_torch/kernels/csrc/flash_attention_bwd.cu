// Flash attention's backward, sm_90a: dq, dk and dv of flash_attention.cu's
// forward, from its training instantiation's f32 O and row log-sum-exp.
//
//   p_ij  = exp(s_ij - lse_i) on the visible keys, 0 elsewhere (and on a row
//           with no visible key, whose lse is +inf)
//   dP_ij = dO_i . v_j                D_i = dO_i . O_i   (O in f32)
//   dS_ij = p_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_(query heads of j's kv head) sum_i dS_ij q_i
//   dv_j  = sum_(query heads of j's kv head) sum_i p_ij dO_i
//
// s_ij = (q_i . k_j) * scale and the masks (causal, window, pos_off) are the
// forward's.  D_i is the softmax derivative's sum_j p_ij dP_ij, which the
// reference forms over the keys: O_i = sum_j p_ij v_j, and the unrounded f32
// O makes D that sum up to the order of the f32 additions.  All sums are f32;
// each output is rounded to the inputs' type once.
//
// The function is the derivative that XLA takes of
// repro/models/layers.py:chunked_attention, the jnp twin of the Pallas kernel
// repro/kernels/flash_attention.py:flash_attention_pallas (which has no
// backward).  Two kernels a route, launched in this order on one stream (the
// second reads the D that the first writes), both deterministic: no atomics,
// every output element written by one thread after sums in a fixed order.
// The wrapper (kernels/flash_attention.py:flash_bwd_route) picks the route
// from the dtype and head_dim alone.
//
// What bounds it on an H100: operations.  Over the visible pairs the
// function needs five products of head_dim FMAs (S, dP, dQ, dK, dV).  On the
// bf16 tensor cores, with P and dS each split into three exact bf16 parts as
// the forward splits p (S and dP one product each, dV, dQ and dK three
// each), that is 11 bf16 products, 22 dh FLOP a pair at 989 TFLOP/s; with S
// and dP recomputed by both kernels, 13.  On the CUDA cores the five take
// 10 dh FLOP a pair at 67 TFLOP/s.
//
// The Hopper route, bf16 at head_dim 64, 128 and 256 (namespace hopper below,
// built from the forward's pieces in hopper.cuh): one producer warpgroup
// whose one thread loads by TMA (128-byte swizzled 64-column boxes, zero
// fill past the sequence's end, so nothing is padded) and two consumer
// warpgroups (setmaxnreg 40 / 232) that run every product as wgmma:
//   * S = Q K^T and dP = dO V^T (or S^T and dP^T) from shared memory, one
//     bf16 product each, f32 accumulators;
//   * p = ex2(s scale log2 e - lse log2 e), one FFMA and ex2.approx as in the
//     forward; masks tested only on the tiles that the causal, window, Sk or
//     Sq edge crosses (a second instantiation of the tile, as the forward's);
//     dS = p (dP - D) in f32;
//   * P and dS split in registers into three bf16 parts (split3: exact), and
//     each of dV, dQ, dK three register-A wgmma m64n64k16 per 16 rows and 64
//     columns with the other operand (K, dO or Q as it lies in shared
//     memory) MN-major, two 16-row chunks a commit group so that the next
//     chunks' split overlaps them.  The products are exact; the sums over tiles stay in
//     the wgmma accumulators (their f32 sums are not a chain of
//     round-to-nearest FMAs, which the 2-ulps-of-scale checks on the card
//     allow: PERF.md gives the measured ulps).
// flash_bwd_dq_wgmma_kernel -- one block per (128-query tile, head, batch
//   row), the heaviest causal tiles first; Q and dO loaded once, 64-key K/V
//   tiles through a ring (4 stages at head_dim 64, 3 at 128); each consumer
//   owns 64 query rows and every column: D = dO . O for its rows from the
//   f32 O in global memory (written for the second kernel), then per key
//   tile S, dP, dS and dQ += dS K.  A thread holds S 32, dP 32, dS's parts
//   48 and dQ 32 or 64 registers.  Head_dim 256: 64 queries a block, a
//   2-stage ring (192 KB), both consumers compute the same S and dP and
//   each owns 128 of dq's columns (dQ 64 registers): 7 products.
// flash_bwd_dkdv_wgmma_kernel -- one block per (key tile, kv head, batch
//   row); K and V loaded once; a ring of 4 stages of (Q, dO, the tile's 64
//   lse and 64 D by 1-D tensor maps, each box 68 elements from the 16-byte
//   aligned element at or before the tile's first row: TMA faults on a box
//   that starts unaligned, as at Sq = 257) over the H / Kv query heads of the kv
//   head and the 64-query tiles that see the block's keys, so that the GQA
//   sum stays in the block.  S^T = K Q^T and dP^T = V dO^T come out keys x
//   queries, which is the register-A layout of P^T and dS^T: dV += P^T dO is
//   issued first, dS^T formed while it runs, and dK += dS^T Q once P's parts
//   are free, so both splits are never live at once.  Head_dim 64: 128 keys
//   a block, 64 a consumer, every column (dK and dV 32 registers each);
//   head_dim 128: 64 keys a block, both consumers compute the same S^T and
//   dP^T (the same instructions on the same data) and each owns 64 columns
//   of dk and dv, since a row split would need 128 registers for dK and dV
//   alone (two products of eight computed twice).  Head_dim 256 (role
//   split, 2 stages): 64 keys a block; consumer 0 computes S^T and sums dV
//   over all 256 columns, consumer 1 computes S^T and dP^T and sums dK (128
//   accumulators each): 9 products.  With one kv head the blocks are few
//   (recurrentgemma-2b's training layer: 128, under one wave), so a key
//   tile's (query head, query tile) pairs are split over a cluster of
//   blocks (dkdv_split), whose partial dk and dv are added in rank order
//   through distributed shared memory and written once.
//
// The SIMT route, f32 at any head_dim and bf16 at 16 and 32 (the
// anonymous namespace below), the port's first backward: templated on T
// (bf16 or f32) and DH (16, 32, 64, 128, 256), instantiated for f32 at
// every head_dim and for bf16 at 16 and 32; 256 threads as 16 x 16; every
// operand staged in shared memory as f32 and every product an f32 FMA on the
// CUDA cores, seven of them over the visible pairs.
//
// flash_bwd_dq_kernel -- one block per (query tile, head, batch row), the
//   heaviest causal tiles first: D for its rows (written for the second
//   kernel), then a loop over the key tiles that hold a visible key for the
//   tile (the forward's block skips): S and dP from Q and dO (staged once)
//   and each K and V tile, P = exp(S - lse), dS = P (dP - D) through shared
//   memory, and dQ += dS K in registers.  dq is written once, times scale.
// flash_bwd_dkdv_kernel -- one block per (key tile, kv head, batch row): a
//   loop over the H / Kv query heads of its kv head and over the query tiles
//   that see its keys, recomputing S^T and dP^T, accumulating dV += P^T dO
//   and dK += dS^T Q in registers, so that the GQA sum happens inside the
//   block.  dk (times scale) and dv are written once.
//
// Tiles: the block's own rows (queries, or keys) are 64, 32 at head_dim 256
// so that the f32 tiles fit shared memory (the dq kernel takes 208,640 B
// there, the dkdv kernel 217,600 B); the tile looped over is 64 rows.

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kSide = 16;                // 16 x 16 threads
constexpr int kThreads = kSide * kSide;
constexpr int kTile = 64;                // rows of the tile looped over
constexpr int kPLd = kTile + 4;          // padded row of a P or dS tile (floats)

// the block's own rows: 64, or 32 at head_dim 256 (shared memory)
template <int DH>
constexpr int kOwnRows = DH == 256 ? 32 : 64;

template <int DH>
constexpr size_t dq_smem_bytes() {
  // Q, dO [R][DH + 4]; K, V [64][DH + 4]; dS [R][kPLd]; lse, D [R]
  return sizeof(float) *
         (2 * kOwnRows<DH> * (DH + 4) + 2 * kTile * (DH + 4) + kOwnRows<DH> * kPLd +
          2 * kOwnRows<DH>);
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  // K, V [R][DH + 4]; Q, dO [64][DH + 4]; P^T, dS^T [R][kPLd]; lse, D [64]
  return sizeof(float) *
         (2 * kOwnRows<DH> * (DH + 4) + 2 * kTile * (DH + 4) + 2 * kOwnRows<DH> * kPLd +
          2 * kTile);
}

static_assert(dq_smem_bytes<256>() <= 232448 && dkdv_smem_bytes<256>() <= 232448,
              "more shared memory than a block may use");

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float x[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo);
  x[2] = __low2float(hi); x[3] = __high2float(hi);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Rows r0 .. r0 + n - 1 of one head (src: its first position; `row`
// elements between positions) into dst[n][DH + 4] as f32; rows at or past
// `len` as zeros.
template <int DH, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n, int len,
                                      long long row) {
  for (int i = threadIdx.x; i < n * DH / 4; i += kThreads) {
    const int r = i * 4 / DH, c = i * 4 % DH;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < len) load4(src + (r0 + r) * row + c, x);
    *reinterpret_cast<float4*>(&dst[r * (DH + 4) + c]) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Key position kp visible to query position qp (both on k's positions).
__device__ __forceinline__ bool visible(int qp, int kp, int sk, int causal, int window) {
  return kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// ab[i][j] = a_r . b_c and cd[i][j] = c_r . d_c over DH, f32 FMAs in the
// forward's order, for the own tile's rows r = ty kR + i (a, c) and the
// looped tile's rows c = tx + 16 j (b, d).
template <int DH, int kR>
__device__ __forceinline__ void two_dots(const float* a, const float* c, const float* b,
                                         const float* d, float (&ab)[kR][4], float (&cd)[kR][4],
                                         int tx, int ty) {
  constexpr int kLd = DH + 4;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ab[i][j] = cd[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < DH; e += 4) {
    float4 av[kR], cv[kR], bv[4], dv[4];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      av[i] = *reinterpret_cast<const float4*>(&a[(ty * kR + i) * kLd + e]);
      cv[i] = *reinterpret_cast<const float4*>(&c[(ty * kR + i) * kLd + e]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = *reinterpret_cast<const float4*>(&b[(tx + kSide * j) * kLd + e]);
      dv[j] = *reinterpret_cast<const float4*>(&d[(tx + kSide * j) * kLd + e]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ab[i][j] = fmaf(av[i].x, bv[j].x, ab[i][j]);
        ab[i][j] = fmaf(av[i].y, bv[j].y, ab[i][j]);
        ab[i][j] = fmaf(av[i].z, bv[j].z, ab[i][j]);
        ab[i][j] = fmaf(av[i].w, bv[j].w, ab[i][j]);
        cd[i][j] = fmaf(cv[i].x, dv[j].x, cd[i][j]);
        cd[i][j] = fmaf(cv[i].y, dv[j].y, cd[i][j]);
        cd[i][j] = fmaf(cv[i].z, dv[j].z, cd[i][j]);
        cd[i][j] = fmaf(cv[i].w, dv[j].w, cd[i][j]);
      }
  }
}

// acc[i][c] += sum_j t[r][j] x[j][tx kC + c] over the looped tile's 64 rows j
// (in order), for the own rows r = ty kR + i: t is a P or dS tile [R][kPLd],
// x a staged tile [64][DH + 4].
template <int DH, int kR>
__device__ __forceinline__ void accumulate(float (&acc)[kR][DH / kSide], const float* t,
                                           const float* x, int tx, int ty) {
  constexpr int kLd = DH + 4, kC = DH / kSide;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 ta[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      ta[i] = *reinterpret_cast<const float4*>(&t[(ty * kR + i) * kPLd + j]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float xv[kC];
      const float* xrow = &x[(j + jj) * kLd + tx * kC];
      if constexpr (kC % 4 == 0) {
#pragma unroll
        for (int c = 0; c < kC; c += 4) load4(xrow + c, &xv[c]);
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) xv[c] = xrow[c];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float tv = jj == 0 ? ta[i].x : jj == 1 ? ta[i].y : jj == 2 ? ta[i].z : ta[i].w;
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(tv, xv[c], acc[i][c]);
      }
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ o, const float* __restrict__ lse,
                    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ dsum,
                    int sq, int sk, int n_heads, int n_kv, int causal, int window, int pos_off,
                    float scale) {
  constexpr int R = kOwnRows<DH>, kR = R / kSide, kC = DH / kSide, kLd = DH + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [R][kLd]
  float* dos = qs + R * kLd;                    // [R][kLd]
  float* ks = dos + R * kLd;                    // [kTile][kLd]
  float* vs = ks + kTile * kLd;                 // [kTile][kLd]
  float* dss = vs + kTile * kLd;                // [R][kPLd]
  float* lse_s = dss + R * kPLd;                // [R]
  float* d_s = lse_s + R;                       // [R]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // the heaviest causal tiles first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const long long q_row = static_cast<long long>(n_heads) * DH;
  const long long kv_row = static_cast<long long>(n_kv) * DH;
  const long long q_base = b * sq * q_row + static_cast<long long>(h) * DH;
  const long long kv_base = b * sk * kv_row + static_cast<long long>(kvh) * DH;
  const long long stat = (b * n_heads + h) * sq;  // this head's rows of lse and D

  stage<DH>(qs, q + q_base, q0, R, sq, q_row);
  stage<DH>(dos, dout + q_base, q0, R, sq, q_row);
  __syncthreads();
  // D = dO . O (the forward's f32 O); a row's 16 threads share a half-warp
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
    const bool in = q0 + r < sq;
    float d = 0.f;
    if (in) {
      const float* orow = o + q_base + (q0 + r) * q_row;
      for (int c = tx; c < DH; c += kSide) d = fmaf(dos[r * kLd + c], orow[c], d);
    }
#pragma unroll
    for (int off = kSide / 2; off > 0; off /= 2) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (tx == 0) {
      d_s[r] = d;
      lse_s[r] = in ? lse[stat + q0 + r] : pos_inf();
      if (in) dsum[stat + q0 + r] = d;
    }
  }

  // the key tiles that hold a visible key for some query of this tile
  const int p0 = q0 + pos_off;  // the tile's first query, on k's positions
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, p0 + R);
  if (window > 0) k_begin = max(0, p0 - window + 1) / kTile * kTile;

  float acc[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();  // D and lse are in; the last tile's readers are done
    stage<DH>(ks, k + kv_base, k0, kTile, sk, kv_row);
    stage<DH>(vs, v + kv_base, k0, kTile, sk, kv_row);
    __syncthreads();
    float s[kR][4], dp[kR][4];
    two_dots<DH, kR>(qs, dos, ks, vs, s, dp, tx, ty);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty * kR + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(p0 + r, k0 + tx + kSide * j, sk, causal, window)
                            ? expf(__fmul_rn(s[i][j], scale) - lse_s[r])
                            : 0.f;
        dss[r * kPLd + tx + kSide * j] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();
    accumulate<DH, kR>(acc, dss, ks, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
    if (q0 + r >= sq) continue;
    T* row = dq + q_base + (q0 + r) * q_row + tx * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) store1(row + c, acc[i][c] * scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ lse, const T* __restrict__ dout,
                      const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                      int sq, int sk, int n_heads, int n_kv, int causal, int window, int pos_off,
                      float scale) {
  constexpr int R = kOwnRows<DH>, kR = R / kSide, kC = DH / kSide, kLd = DH + 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [R][kLd]
  float* vs = ks + R * kLd;                     // [R][kLd]
  float* qs = vs + R * kLd;                     // [kTile][kLd]
  float* dos = qs + kTile * kLd;                // [kTile][kLd]
  float* pt = dos + kTile * kLd;                // P^T [R keys][kPLd]
  float* dst = pt + R * kPLd;                   // dS^T [R keys][kPLd]
  float* lse_s = dst + R * kPLd;                // [kTile]
  float* d_s = lse_s + kTile;                   // [kTile]

  const int k0 = blockIdx.x * R;  // the first key tiles see the most causal queries: first
  const int g = blockIdx.y;
  const long long b = blockIdx.z;
  const int rep = n_heads / n_kv;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const long long q_row = static_cast<long long>(n_heads) * DH;
  const long long kv_row = static_cast<long long>(n_kv) * DH;
  const long long kv_base = b * sk * kv_row + static_cast<long long>(g) * DH;

  stage<DH>(ks, k + kv_base, k0, R, sk, kv_row);
  stage<DH>(vs, v + kv_base, k0, R, sk, kv_row);

  // the queries i that see a key of this tile (query position i + pos_off)
  const long long len = sq, first = static_cast<long long>(k0) - pos_off;
  int q_begin = 0, q_end = sq;
  if (causal) q_begin = static_cast<int>(min(len, max(0ll, first)));
  if (window > 0) q_end = static_cast<int>(max(0ll, min(len, first + R - 1 + window)));

  float acc_k[kR][kC], acc_v[kR][kC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const long long q_base = b * sq * q_row + static_cast<long long>(h) * DH;
    const long long stat = (b * n_heads + h) * sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
      __syncthreads();  // K and V are in; the last tile's readers are done
      stage<DH>(qs, q + q_base, q0, kTile, sq, q_row);
      stage<DH>(dos, dout + q_base, q0, kTile, sq, q_row);
      if (threadIdx.x < kTile) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < sq ? lse[stat + i] : pos_inf();
        d_s[threadIdx.x] = i < sq ? dsum[stat + i] : 0.f;
      }
      __syncthreads();
      float s[kR][4], dp[kR][4];  // S^T = K Q^T and dP^T = V dO^T
      two_dots<DH, kR>(ks, vs, qs, dos, s, dp, tx, ty);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = ty * kR + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + kSide * j;
          const bool vis = q0 + c < sq && visible(q0 + c + pos_off, k0 + r, sk, causal, window);
          const float p = vis ? expf(__fmul_rn(s[i][j], scale) - lse_s[c]) : 0.f;
          pt[r * kPLd + c] = p;
          dst[r * kPLd + c] = p * (dp[i][j] - d_s[c]);
        }
      }
      __syncthreads();
      accumulate<DH, kR>(acc_v, pt, dos, tx, ty);
      accumulate<DH, kR>(acc_k, dst, qs, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
    if (k0 + r >= sk) continue;
    const long long at = kv_base + (k0 + r) * kv_row + tx * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      store1(dk + at + c, acc_k[i][c] * scale);
      store1(dv + at + c, acc_v[i][c]);
    }
  }
}

template <typename T, int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* lse,
              const void* dout, void* dq, void* dsum, int batch, int sq, int sk, int n_heads,
              int n_kv, int causal, int window, int pos_off, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DH>();
  const auto kernel = flash_bwd_dq_kernel<T, DH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kOwnRows<DH> - 1) / kOwnRows<DH>, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(o), static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(dsum), sq, sk, n_heads, n_kv, causal, window,
      pos_off, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkdv(const void* q, const void* k, const void* v, const void* lse, const void* dout,
                const void* dsum, void* dk, void* dv, int batch, int sq, int sk, int n_heads,
                int n_kv, int causal, int window, int pos_off, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<DH>();
  const auto kernel = flash_bwd_dkdv_kernel<T, DH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kOwnRows<DH> - 1) / kOwnRows<DH>, n_kv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(dsum), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, n_heads,
      n_kv, causal, window, pos_off, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(int head_dim, const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dsum, int batch, int sq,
                int sk, int n_heads, int n_kv, int causal, int window, int pos_off, float scale,
                cudaStream_t st) {
#define REPRO_DQ(DH)                                                                          \
  case DH:                                                                                     \
    return launch_dq<T, DH>(q, k, v, o, lse, dout, dq, dsum, batch, sq, sk, n_heads, n_kv,   \
                            causal, window, pos_off, scale, st);
  switch (head_dim) {
    REPRO_DQ(16)
    REPRO_DQ(32)
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 at 64, 128, 256: the wgmma route
    switch (head_dim) {
      REPRO_DQ(64)
      REPRO_DQ(128)
      REPRO_DQ(256)
    }
  }
#undef REPRO_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_dkdv(int head_dim, const void* q, const void* k, const void* v, const void* lse,
                  const void* dout, const void* dsum, void* dk, void* dv, int batch, int sq,
                  int sk, int n_heads, int n_kv, int causal, int window, int pos_off,
                  float scale, cudaStream_t st) {
#define REPRO_DKDV(DH)                                                                        \
  case DH:                                                                                     \
    return launch_dkdv<T, DH>(q, k, v, lse, dout, dsum, dk, dv, batch, sq, sk, n_heads,      \
                              n_kv, causal, window, pos_off, scale, st);
  switch (head_dim) {
    REPRO_DKDV(16)
    REPRO_DKDV(32)
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 at 64, 128, 256: the wgmma route
    switch (head_dim) {
      REPRO_DKDV(64)
      REPRO_DKDV(128)
      REPRO_DKDV(256)
    }
  }
#undef REPRO_DKDV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Sq, H, dh), k and v (B, Sk, Kv, dh), dout and dq like q, in T (bf16
// if is_bf16, else f32); o (B, Sq, H, dh) f32 and lse (B, H, Sq) f32 from the
// forward's training instantiation; dsum (B, H, Sq) f32 receives D.  window
// <= 0: no window; pos_off = q_off - k_off.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for another head_dim, and for bf16 at
// head_dim 64, 128 or 256: flash_attention_bwd_dq_wgmma takes those).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dq, void* dsum,
                                      int batch, int sq, int sk, int n_heads, int n_kv,
                                      int head_dim, int is_bf16, int causal, int window,
                                      int pos_off, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dq<__nv_bfloat16>(head_dim, q, k, v, o, lse, dout, dq, dsum, batch, sq, sk,
                                      n_heads, n_kv, causal, window, pos_off, scale, st);
  return dispatch_dq<float>(head_dim, q, k, v, o, lse, dout, dq, dsum, batch, sq, sk, n_heads,
                            n_kv, causal, window, pos_off, scale, st);
}

// dk and dv (B, Sk, Kv, dh) in T; dsum the D that flash_attention_bwd_dq
// wrote (launch that first, on the same stream); the rest as above.
extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                        const void* lse, const void* dout, const void* dsum,
                                        void* dk, void* dv, int batch, int sq, int sk,
                                        int n_heads, int n_kv, int head_dim, int is_bf16,
                                        int causal, int window, int pos_off, float scale,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_dkdv<__nv_bfloat16>(head_dim, q, k, v, lse, dout, dsum, dk, dv, batch, sq,
                                        sk, n_heads, n_kv, causal, window, pos_off, scale, st);
  return dispatch_dkdv<float>(head_dim, q, k, v, lse, dout, dsum, dk, dv, batch, sq, sk,
                              n_heads, n_kv, causal, window, pos_off, scale, st);
}

// ===========================================================================
// The Hopper route: bf16 at head_dim 64, 128 and 256
// (flash_bwd_dq_wgmma_kernel, flash_bwd_dkdv_wgmma_kernel)
// ===========================================================================

namespace hopper {

// setmaxnreg: the producer warpgroup's TMA loop, and the two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "more registers than an SM has");

// dq: a block loops over 64-key tiles; Q and dO are loaded once, K and V
// stream through a ring.  At head_dim 64 and 128 (row split) the block owns
// 128 query rows, 64 a consumer, and every column.  At head_dim 256 Q and dO
// of 128 rows and two K/V stages would take 256 KB, and dQ over every column
// 128 registers a thread, so (column split, as the forward's) the block owns
// 64 rows, both consumers compute the same S and dP (the same instructions
// on the same data), and each sums and writes its own 128 of dq's columns:
// dQ 64, S 32, dP 32 and dS's parts 48 registers; 2 stages, 192 KB.
template <int DH>
struct DqCfg {
  static constexpr bool kColSplit = DH == 256;
  static constexpr int kBQ = kColSplit ? 64 : 128;               // query rows per block
  static constexpr int kBK = 64;                                 // keys per tile
  static constexpr int kPanels = DH / kPanelCols;                // of Q, dO, K and V
  static constexpr int kOutPanels = kColSplit ? kPanels / 2 : kPanels;  // a consumer's dq panels
  static constexpr int kStages = DH == 64 ? 4 : DH == 128 ? 3 : 2;      // the K/V ring
  static constexpr int kQPanelBytes = kBQ * kRowBytes;
  static constexpr int kQTileBytes = kPanels * kQPanelBytes;     // Q, or dO
  static constexpr int kKPanelBytes = kBK * kRowBytes;
  static constexpr int kKTileBytes = kPanels * kKPanelBytes;     // one K or one V tile
  static constexpr int kStageBytes = 2 * kKTileBytes;            // K, then V
  static constexpr int kBarOffset = 2 * kQTileBytes + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);  // + 1024-B alignment
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// dk and dv: a block owns a key tile and loops over its kv head's query heads
// and the 64-query tiles that see its keys (at head_dim 256, its cluster
// rank's share of those pairs); K and V are loaded once, and Q, dO and their
// rows' lse and D stream through a ring.  At head_dim 64 (row split) the
// block owns 128 keys, 64 a consumer.  At head_dim 128 dK and dV alone
// would take 128 registers a thread, so (column split) the block owns 64
// keys, both consumers compute the same S^T and dP^T, and each sums and
// writes its own 64 of the 128 columns of dk and dv.  At head_dim 256 the
// column split would hold dK 64 + dV 64 + S^T 32 + dP^T 32 + a split's parts
// 48 = 240 registers, over the 232 a consumer has, so (role split) the block
// owns 64 keys, consumer 0 computes S^T alone and sums dV over every column
// (dV 128 + P 32 + its parts 48), consumer 1 computes S^T and dP^T and sums
// dK (dK 128 + S^T 32 + dP^T 32, then dS^T in dP^T's place and its parts
// 48): 9 products a tile, against 10 for the column split.  K and V take 64
// KB and a stage of Q, dO, lse and D 65 KB: 2 stages.
template <int DH>
struct DkdvCfg {
  static constexpr bool kColSplit = DH == 128;
  static constexpr bool kRoleSplit = DH == 256;                  // consumer 0 dv, consumer 1 dk
  static constexpr int kBK = kColSplit || kRoleSplit ? 64 : 128; // keys per block
  static constexpr int kBQ = 64;                                 // queries per tile
  static constexpr int kPanels = DH / kPanelCols;
  static constexpr int kOutPanels = kColSplit ? kPanels / 2 : kPanels;  // a consumer's columns
  static constexpr int kStages = kRoleSplit ? 2 : 4;
  static constexpr int kKPanelBytes = kBK * kRowBytes;
  static constexpr int kKTileBytes = kPanels * kKPanelBytes;     // K, or V
  static constexpr int kQPanelBytes = kBQ * kRowBytes;
  static constexpr int kQTileBytes = kPanels * kQPanelBytes;     // one Q or one dO tile
  // the tile's lse, or D: a 1-D TMA box must start 16-byte aligned, so kBQ
  // + 4 f32 from the aligned element at or before the tile's first row
  static constexpr int kStatBox = kBQ + 4;
  static constexpr int kStatBytes = kStatBox * 4;
  static constexpr int kStatSlot = 384;                          // a box's 128-B aligned slot
  static constexpr int kStageTx = 2 * kQTileBytes + 2 * kStatBytes;  // Q, dO, lse, D
  static constexpr int kStageBytes = (kStageTx + 1023) / 1024 * 1024;
  static constexpr int kBarOffset = 2 * kKTileBytes + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);
  static_assert(kStatBytes <= kStatSlot && 2 * kQTileBytes + kStatSlot + kStatBytes <= kStageBytes,
                "the lse and D boxes fit their slots");
  static_assert(kRoleSplit || kOutPanels == 1, "one 64-column panel of dk and dv a consumer");
  // the role split's partial sums of a cluster, stashed over the ring: a
  // float2 per pair of accumulators, [consumer][64 pairs][128 threads]
  static constexpr int kStashBytes = 2 * 64 * 128 * 8;
  static_assert(!kRoleSplit || kStashBytes <= kStages * kStageBytes, "the stash fits the ring");
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// dkdv at head_dim 256: the (key tile, kv head, batch row) blocks are few
// when the kv heads are (recurrentgemma-2b's layer: 64 x 1 x 2 = 128 blocks,
// under one wave of 132 SMs, the last key tiles of a window seeing 1 of 33
// query tiles), so a key tile's sequence of (query head, query tile) pairs
// is split over a cluster of n blocks, rank r taking pairs [r T / n, (r +
// 1) T / n) of its T (whole heads when n divides H / Kv); the cluster adds
// the n partial sums through distributed shared memory in rank order.  A
// cluster's blocks share a GPC, so n also sets how many SMs work at once
// (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3: 66 clusters of 2,
// 39 of 3, 30 of 4, 22 of 5, 15 of 8): n is the smallest power of two that
// gives kSplitWaves waves of the card's SMs, at most kMaxSplit (1 when the
// blocks alone give that many: a cluster of one adds its own stash).
// scripts/flash_probe.py times the choices; PERF.md gives the readings.
constexpr int kMaxSplit = 8;
constexpr int kSplitWaves = 2;

inline int dkdv_split(int blocks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int n = 1;
  while (n < kMaxSplit && blocks * n < kSplitWaves * sms) n *= 2;
  return n;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every block of the cluster: shared-memory writes before
// it are seen by the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The float2 at shared address `at` in the block of cluster rank `rank`.
__device__ __forceinline__ float2 ld_cluster_f2(uint32_t at, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(at), "r"(rank));
  float2 x;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(remote)
               : "memory");
  return x;
}

// A box of a 1-D f32 tensor map (a head's lse or D rows) into shared
// memory; `at`, the first element, must be 16-byte aligned (a multiple of
// 4), and elements past the end arrive as 0.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int at) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(at)
      : "memory");
}

// Key key visible to the query at position qpos (both on k's positions).
__device__ __forceinline__ bool sees(int qpos, int key, int sk, int causal, int window) {
  return key < sk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// p = exp(s scale - lse) as the forward's exp: one FFMA and ex2.approx, with
// nl = -lse log2 e (-inf where the row sees no key, so p = 0).
__device__ __forceinline__ float bwd_p(float s, float scale, float nl) {
  return ex2(fmaf(__fmul_rn(s, scale), kLog2e, nl));
}

// 16-key (or 16-query) chunks of a split tile a commit group: the split of
// a batch overlaps the products of the one before it (scripts/flash_probe.py
// times 1, 2 and 4; PERF.md gives the readings)
constexpr int kSplitBatch = 2;

// A 64 x 64 tile x (32 accumulators, the m64n64 layout) split into its three
// bf16 parts in the register-A layout (16-column chunk c, registers j = 0..3
// are accumulator pairs 8c + 2j, 8c + 2j + 1; see the forward's exp_split),
// and acc[panel] += A1 B + A2 B + A3 B over a 64-row tile of B (16 rows a
// chunk, MN-major, the panel's 64 columns at b_s + panel * panel_bytes),
// kSplitBatch chunks a commit group; issued and committed, not waited for.
template <int kPanels>
__device__ __forceinline__ void split_and_issue(const float (&x)[32], uint32_t (&pa)[3][4][4],
                                                float (&acc)[kPanels][32], uint32_t b_s,
                                                int panel_bytes) {
#pragma unroll
  for (int c0 = 0; c0 < 4; c0 += kSplitBatch) {
#pragma unroll
    for (int c = c0; c < c0 + kSplitBatch; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split3(x[8 * c + 2 * j], x[8 * c + 2 * j + 1], pa[0][c][j], pa[1][c][j], pa[2][c][j]);
    wgmma_fence();
#pragma unroll
    for (int panel = 0; panel < kPanels; ++panel)
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int c = c0; c < c0 + kSplitBatch; ++c)
          wgmma_rs_n64(acc[panel], pa[part][c],
                       smem_desc(b_s + panel * panel_bytes + c * 16 * kRowBytes), 1);
    wgmma_commit();
  }
}

// One 64 x 64 tile of S = A1 B1^T and dP = A2 B2^T from shared memory (both
// operands K-major over head_dim: a_* of 64 rows in panels of a_panel
// bytes, b_* of 64 rows in panels of b_panel bytes), waited for.
template <int DH>
__device__ __forceinline__ void s_and_dp(float (&sc)[32], float (&dp)[32], uint32_t a1,
                                         uint32_t b1, uint32_t a2, uint32_t b2, int a_panel,
                                         int b_panel) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    wgmma_ss(sc, smem_desc(a1 + (kc / 4) * a_panel + (kc % 4) * 32),
             smem_desc(b1 + (kc / 4) * b_panel + (kc % 4) * 32), kc > 0);
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    wgmma_ss(dp, smem_desc(a2 + (kc / 4) * a_panel + (kc % 4) * 32),
             smem_desc(b2 + (kc / 4) * b_panel + (kc % 4) * 32), kc > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
  fence_regs(dp);
}

// The rest of one dq tile after S and dP: dS = P (dP - D) in registers,
// masked only where an edge crosses the tile (kEdge), split into three bf16
// parts, and dQ += dS1 K + dS2 K + dS3 K (K MN-major, the consumer's first
// panel at k_s) in the wgmma accumulators, which carry the sum over every
// key tile.
template <bool kEdge, typename C>
__device__ __forceinline__ void dq_tile(float (&sc)[32], const float (&dp)[32],
                                        float (&acc)[C::kOutPanels][32], uint32_t k_s,
                                        const float (&nl)[2], const float (&dsum)[2], float scale,
                                        int k0, int ra, int kq, int sk, int causal, int window) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i / 2) & 1;
    float p = bwd_p(sc[i], scale, nl[r]);
    if (kEdge && !sees(ra + 8 * r, k0 + 8 * (i / 4) + kq + (i & 1), sk, causal, window)) p = 0.f;
    sc[i] = __fmul_rn(p, __fsub_rn(dp[i], dsum[r]));
  }
  uint32_t pa[3][4][4];
  split_and_issue(sc, pa, acc, k_s, C::kKPanelBytes);
  wgmma_wait_all();
#pragma unroll
  for (int panel = 0; panel < C::kOutPanels; ++panel) fence_regs(acc[panel]);
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(pa[part][c]);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ o, const float* __restrict__ lse,
                          const __nv_bfloat16* __restrict__ dout,
                          __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum_out, int sq,
                          int sk, int n_heads, int n_kv, int causal, int window, int pos_off,
                          float scale) {
  using C = DqCfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                         // [panel][128 rows][64 columns]
  const uint32_t do_s = base + C::kQTileBytes;
  const uint32_t ring = base + 2 * C::kQTileBytes;   // stage s: K tile, then V tile
  const uint32_t bars = base + C::kBarOffset;        // full[kStages], empty[kStages], q
  const uint32_t q_bar = bars + 16 * C::kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kBQ;  // the heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);

  // the key tiles that hold a visible key for some query of this block
  const int p0 = q0 + pos_off;  // the block's first query, on k's positions
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, p0 + C::kBQ);
  if (window > 0) k_begin = max(0, p0 - window + 1) / C::kBK * C::kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + C::kBK - 1) / C::kBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (C::kStages + s), kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: Q and dO once, then the ring of K/V tiles, by TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_bar, 2 * C::kQTileBytes);
#pragma unroll
      for (int panel = 0; panel < C::kPanels; ++panel) {
        const int col = h * DH + panel * kPanelCols;
        tma_load(q_s + panel * C::kQPanelBytes, &tm_q, q_bar, col, q0, b);
        tma_load(do_s + panel * C::kQPanelBytes, &tm_do, q_bar, col, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        mbar_wait(bars + 8 * (C::kStages + s), ((it / C::kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t k_s = ring + s * C::kStageBytes;
        const int k0 = k_begin + it * C::kBK;
        mbar_expect_tx(full, C::kStageBytes);
#pragma unroll
        for (int panel = 0; panel < C::kPanels; ++panel) {
          const int col = kvh * DH + panel * kPanelCols;
          tma_load(k_s + panel * C::kKPanelBytes, &tm_k, full, col, k0, b);
          tma_load(k_s + C::kKTileBytes + panel * C::kKPanelBytes, &tm_v, full, col, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: row split, 64 query rows each and every column; column
    // split, the block's 64 rows and 128 columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row0 = p0 + (C::kColSplit ? 0 : 64 * cw);  // this warpgroup's first row, on k's positions
    const int panel0 = C::kColSplit ? C::kOutPanels * cw : 0;  // its first column panel of dq
    const int ra = row0 + 16 * warp + lane / 4;    // this thread's rows ra and ra + 8
    const int kq = 2 * (lane % 4);                 // its first column in each 8-column block
    const int qa = ra - pos_off;                   // ... as query rows

    // D = dO . O (the forward's f32 O) for rows qa and qa + 8: each thread
    // of the row's quad sums a quarter of the columns, and the quad adds
    // them; the same value in all four.  Also the rows' -lse log2 e.
    const long long q_row = static_cast<long long>(n_heads) * DH;
    const long long stat = (static_cast<long long>(b) * n_heads + h) * sq;
    float dsum[2], nl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qa + 8 * r;
      float d = 0.f;
      if (row < sq) {
        const long long at = (static_cast<long long>(b) * sq + row) * q_row +
                             static_cast<long long>(h) * DH + (lane % 4) * (DH / 4);
        const float4* o4 = reinterpret_cast<const float4*>(o + at);
        const uint4* d8 = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
        for (int j = 0; j < DH / 32; ++j) {
          const uint4 w = d8[j];
          const float4 oa = o4[2 * j], ob = o4[2 * j + 1];
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          const float ov[8] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d = fmaf(__uint_as_float(words[e] << 16), ov[2 * e], d);
            d = fmaf(__uint_as_float(words[e] & 0xffff0000u), ov[2 * e + 1], d);
          }
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      dsum[r] = d;
      nl[r] = row < sq ? -lse[stat + row] * kLog2e : -pos_inf();
      if (row < sq && kq == 0 && (!C::kColSplit || cw == 0)) dsum_out[stat + row] = d;
    }

    float acc[C::kOutPanels][32];  // dQ per 64-column panel: the m64n64 accumulator layout
#pragma unroll
    for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[panel][i] = 0.f;
    if (n_tiles > 0) mbar_wait(q_bar, 0);
    const uint32_t wg_rows = C::kColSplit ? 0 : 64 * cw * kRowBytes;
    const uint32_t q_wg = q_s + wg_rows, do_wg = do_s + wg_rows;
    const uint32_t k_panel0 = panel0 * C::kKPanelBytes;  // the consumer's columns of K

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages;
      const int k0 = k_begin + it * C::kBK;
      const uint32_t k_s = ring + s * C::kStageBytes;
      mbar_wait(bars + 8 * s, (it / C::kStages) & 1);

      // S = Q K^T and dP = dO V^T (64 x 64, f32): bf16 products are exact
      float sc[32], dp[32];
      s_and_dp<DH>(sc, dp, q_wg, k_s, do_wg, k_s + C::kKTileBytes, C::kQPanelBytes,
                   C::kKPanelBytes);
      // masks only on tiles that an edge crosses for these rows
      if (k0 + C::kBK > sk || (causal && k0 + C::kBK - 1 > row0) ||
          (window > 0 && k0 <= row0 + 63 - window))
        dq_tile<true, C>(sc, dp, acc, k_s + k_panel0, nl, dsum, scale, k0, ra, kq, sk, causal,
                         window);
      else
        dq_tile<false, C>(sc, dp, acc, k_s + k_panel0, nl, dsum, scale, k0, ra, kq, sk, causal,
                          window);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + s));  // this warp is done with stage s
    }

    // dq = scale dQ, rounded to bf16 once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qa + 8 * r;
      if (row >= sq) continue;
      __nv_bfloat16* orow = dq + (static_cast<long long>(b) * sq + row) * q_row +
                            static_cast<long long>(h) * DH + panel0 * kPanelCols + kq;
#pragma unroll
      for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + panel * kPanelCols + 8 * j) =
              __floats2bfloat162_rn(acc[panel][4 * j + 2 * r] * scale,
                                    acc[panel][4 * j + 2 * r + 1] * scale);
    }
  }
}

// The rest of one dk/dv tile after S^T and dP^T (keys x queries): P^T =
// exp(S^T scale - lse) by column, split into three bf16 parts, and dV +=
// P^T dO issued; dS^T = P^T (dP^T - D) formed while it runs; then, once the
// parts of P are free, dS^T split and dK += dS^T Q (dO and Q MN-major; the
// consumer's columns start col_off bytes into each tile).  Masked only where
// an edge crosses the tile (kEdge).
// P^T = exp(S^T scale - lse) of one keys x queries tile in place, by query
// column (the tile's lse at lse_s), masked only where an edge crosses the
// tile (kEdge).
template <bool kEdge>
__device__ __forceinline__ void p_tile(float (&sc)[32], const float* lse_s, float scale, int q0,
                                       int kr, int kq, int sq, int sk, int causal, int window,
                                       int pos_off) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // 8-query blocks
    const float nl[2] = {-lse_s[8 * j + kq] * kLog2e, -lse_s[8 * j + kq + 1] * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float p = bwd_p(sc[i], scale, nl[e & 1]);
      if (kEdge) {
        const int qi = q0 + 8 * j + kq + (e & 1);
        if (qi >= sq || !sees(qi + pos_off, kr + 8 * (e >> 1), sk, causal, window)) p = 0.f;
      }
      sc[i] = p;
    }
  }
}

// dS^T = P^T (dP^T - D) in place of P^T, by query column (D at d_s).
__device__ __forceinline__ void ds_tile(float (&sc)[32], const float (&dp)[32], const float* d_s,
                                        int kq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d[2] = {d_s[8 * j + kq], d_s[8 * j + kq + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[4 * j + e] = __fmul_rn(sc[4 * j + e], __fsub_rn(dp[4 * j + e], d[e & 1]));
  }
}

template <bool kEdge, typename C>
__device__ __forceinline__ void dkdv_tile(float (&sc)[32], const float (&dp)[32],
                                          float (&dka)[C::kOutPanels][32],
                                          float (&dva)[C::kOutPanels][32], uint32_t st,
                                          uint32_t col_off, const float* lse_s, const float* d_s,
                                          float scale, int q0, int kr, int kq, int sq, int sk,
                                          int causal, int window, int pos_off) {
  p_tile<kEdge>(sc, lse_s, scale, q0, kr, kq, sq, sk, causal, window, pos_off);
  uint32_t pa[3][4][4];
  split_and_issue(sc, pa, dva, st + C::kQTileBytes + col_off, C::kQPanelBytes);
  ds_tile(sc, dp, d_s, kq);
  wgmma_wait_all();
#pragma unroll
  for (int panel = 0; panel < C::kOutPanels; ++panel) fence_regs(dva[panel]);
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(pa[part][c]);
  split_and_issue(sc, pa, dka, st + col_off, C::kQPanelBytes);
  wgmma_wait_all();
#pragma unroll
  for (int panel = 0; panel < C::kOutPanels; ++panel) fence_regs(dka[panel]);
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(pa[part][c]);
}

// S^T = K Q^T alone (64 x 64, f32), waited for: the dv consumer's product.
template <int DH>
__device__ __forceinline__ void s_only(float (&sc)[32], uint32_t a, uint32_t b, int a_panel,
                                       int b_panel) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    wgmma_ss(sc, smem_desc(a + (kc / 4) * a_panel + (kc % 4) * 32),
             smem_desc(b + (kc / 4) * b_panel + (kc % 4) * 32), kc > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
}

// One tile of the role split after S^T (and dP^T): P^T; for the dk
// consumer (kDk) dS^T in its place; then split into three bf16 parts and
// dV += P^T dO or dK += dS^T Q over every column (dO or Q MN-major),
// waited for.
template <bool kDk, bool kEdge, typename C>
__device__ __forceinline__ void role_tile(float (&sc)[32], const float (&dp)[32],
                                          float (&acc)[C::kOutPanels][32], uint32_t st,
                                          const float* lse_s, const float* d_s, float scale,
                                          int q0, int kr, int kq, int sq, int sk, int causal,
                                          int window, int pos_off) {
  p_tile<kEdge>(sc, lse_s, scale, q0, kr, kq, sq, sk, causal, window, pos_off);
  if constexpr (kDk) ds_tile(sc, dp, d_s, kq);
  uint32_t pa[3][4][4];
  split_and_issue(sc, pa, acc, kDk ? st : st + C::kQTileBytes, C::kQPanelBytes);
  wgmma_wait_all();
#pragma unroll
  for (int panel = 0; panel < C::kOutPanels; ++panel) fence_regs(acc[panel]);
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(pa[part][c]);
}

// A role-split consumer's loop over the ring: n_tiles tiles, the pairs
// it_lo on of the key tile's (query head from h0, query tile) sequence,
// per_head tiles a head.
template <bool kDk, int DH>
__device__ __forceinline__ void role_loop(float (&acc)[DkdvCfg<DH>::kOutPanels][32],
                                          uint32_t k_s, uint32_t v_s, uint32_t ring,
                                          uint32_t bars, const unsigned char* smem_at,
                                          uint32_t base, int n_tiles, int per_head, int h0,
                                          int it_lo,
                                          int q_begin, int b, int n_heads, int k0, int kr,
                                          int kq, int lane, int sq, int sk, int causal,
                                          int window, int pos_off, float scale) {
  using C = DkdvCfg<DH>;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::kStages;
    const int h = h0 + (it_lo + it) / per_head;
    const int q0 = q_begin + (it_lo + it) % per_head * C::kBQ;
    const uint32_t st = ring + s * C::kStageBytes;
    // the tile's first row in the stage's lse and D boxes
    const int shift = ((b * n_heads + h) * sq + q0) & 3;
    const float* lse_s =
        reinterpret_cast<const float*>(smem_at + (st - base) + 2 * C::kQTileBytes) + shift;
    const float* d_s = lse_s + C::kStatSlot / 4;
    mbar_wait(bars + 8 * s, (it / C::kStages) & 1);

    float sc[32], dp[32];  // S^T = K Q^T, and dP^T = V dO^T for dk (64 keys x 64 queries)
    if constexpr (kDk)
      s_and_dp<DH>(sc, dp, k_s, st, v_s, st + C::kQTileBytes, C::kKPanelBytes, C::kQPanelBytes);
    else
      s_only<DH>(sc, k_s, st, C::kKPanelBytes, C::kQPanelBytes);
    const int qp0 = q0 + pos_off;  // the tile's first query, on k's positions
    if (k0 + 64 > sk || q0 + C::kBQ > sq || (causal && k0 + 63 > qp0) ||
        (window > 0 && k0 <= qp0 + C::kBQ - 1 - window))
      role_tile<kDk, true, C>(sc, dp, acc, st, lse_s, d_s, scale, q0, kr, kq, sq, sk, causal,
                              window, pos_off);
    else
      role_tile<kDk, false, C>(sc, dp, acc, st, lse_s, d_s, scale, q0, kr, kq, sq, sk, causal,
                               window, pos_off);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + s));  // this warp is done with stage s
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_lse,
                            const __grid_constant__ CUtensorMap tm_dsum,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int sq, int sk, int n_heads, int n_kv, int causal, int window,
                            int pos_off, float scale) {
  using C = DkdvCfg<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base;                         // [panel][kBK rows][64 columns]
  const uint32_t v_s = base + C::kKTileBytes;
  const uint32_t ring = base + 2 * C::kKTileBytes;   // stage s: Q, dO, 64 lse, 64 D
  const uint32_t bars = base + C::kBarOffset;        // full[kStages], empty[kStages], kv
  const uint32_t kv_bar = bars + 16 * C::kStages;

  // the first key tiles see the most causal queries: first.  Role split:
  // the cluster's n blocks share a key tile, rank r summing its share of
  // the tile's (query head, query tile) pairs (dkdv_split).
  int n_split = 1, rank = 0;
  if constexpr (C::kRoleSplit) {
    n_split = static_cast<int>(cluster_size());
    rank = static_cast<int>(cluster_rank());
  }
  const int k0 = blockIdx.x / n_split * C::kBK;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = n_heads / n_kv;

  // the queries i that see a key of this block (query position i + pos_off)
  const long long first = static_cast<long long>(k0) - pos_off;
  int q_begin = 0, q_end = sq;
  if (causal) q_begin = static_cast<int>(min(static_cast<long long>(sq), max(0ll, first)));
  if (window > 0)
    q_end = static_cast<int>(max(0ll, min(static_cast<long long>(sq), first + C::kBK - 1 + window)));
  const int per_head = q_end > q_begin ? (q_end - q_begin + C::kBQ - 1) / C::kBQ : 0;
  // tile it is pair f = it_lo + it: query head g rep + f / per_head, query
  // tile f % per_head
  const int it_lo = rank * rep * per_head / n_split;
  const int n_tiles = (rank + 1) * rep * per_head / n_split - it_lo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (C::kStages + s), kConsumerWarps);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: K and V once, then the ring of Q, dO, lse and D tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(kv_bar, 2 * C::kKTileBytes);
#pragma unroll
      for (int panel = 0; panel < C::kPanels; ++panel) {
        const int col = g * DH + panel * kPanelCols;
        tma_load(k_s + panel * C::kKPanelBytes, &tm_k, kv_bar, col, k0, b);
        tma_load(v_s + panel * C::kKPanelBytes, &tm_v, kv_bar, col, k0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        const int h = g * rep + (it_lo + it) / per_head;
        const int q0 = q_begin + (it_lo + it) % per_head * C::kBQ;
        mbar_wait(bars + 8 * (C::kStages + s), ((it / C::kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t st = ring + s * C::kStageBytes;
        mbar_expect_tx(full, C::kStageTx);
#pragma unroll
        for (int panel = 0; panel < C::kPanels; ++panel) {
          const int col = h * DH + panel * kPanelCols;
          tma_load(st + panel * C::kQPanelBytes, &tm_q, full, col, q0, b);
          tma_load(st + C::kQTileBytes + panel * C::kQPanelBytes, &tm_do, full, col, q0, b);
        }
        // the tile's rows of lse and D from the aligned element at or before
        // them (the launcher keeps B H Sq < 2^31)
        const int at = ((b * n_heads + h) * sq + q0) & ~3;
        tma_load_1d(st + 2 * C::kQTileBytes, &tm_lse, full, at);
        tma_load_1d(st + 2 * C::kQTileBytes + C::kStatSlot, &tm_dsum, full, at);
      }
    }
    if constexpr (C::kRoleSplit) {  // the consumers' two cluster barriers (below)
      cluster_sync();
      cluster_sync();
    }
  } else if constexpr (C::kRoleSplit) {
    // ---- consumers: the block's 64 keys; consumer 0 dv, consumer 1 dk ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int kr = k0 + 16 * warp + lane / 4;  // this thread's keys kr and kr + 8
    const int kq = 2 * (lane % 4);             // its first query (column) in each 8-block
    const unsigned char* smem_at = smem_raw + (base - raw);  // base as a generic pointer

    float acc[C::kOutPanels][32];  // dV or dK over every column
#pragma unroll
    for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[panel][i] = 0.f;
    if (n_tiles > 0) mbar_wait(kv_bar, 0);
    const int h0 = g * rep;
    if (cw == 0)
      role_loop<false, DH>(acc, k_s, v_s, ring, bars, smem_at, base, n_tiles, per_head, h0,
                           it_lo, q_begin, b, n_heads, k0, kr, kq, lane, sq, sk, causal, window,
                           pos_off, scale);
    else
      role_loop<true, DH>(acc, k_s, v_s, ring, bars, smem_at, base, n_tiles, per_head, h0,
                          it_lo, q_begin, b, n_heads, k0, kr, kq, lane, sq, sk, causal, window,
                          pos_off, scale);

    // dv = dV and dk = scale dK, rounded to bf16 once; a cluster's partial
    // sums first added in rank order
    __nv_bfloat16* out = cw == 0 ? dv : dk;
    const float mul = cw == 0 ? 1.f : scale;
    const long long row0 = static_cast<long long>(b) * sk;
    const long long col0 = static_cast<long long>(g) * DH + kq;
    const long long kv_row = static_cast<long long>(n_kv) * DH;
    // pair p (accumulators 2p and 2p + 1 of the 128) of thread tid of
    // consumer cw at ring + ((cw 64 + p) 128 + tid) 8, once both
    // consumers are done with the ring
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const uint32_t stash = ring + (cw * 64 * 128 + tid) * 8;
#pragma unroll
    for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         stash + (panel * 16 + e / 2) * 128 * 8),
                     "f"(acc[panel][e]), "f"(acc[panel][e + 1])
                     : "memory");
    cluster_sync();
    // rank r adds and writes pairs [r 64 / n, (r + 1) 64 / n)
    for (int p = rank * 64 / n_split; p < (rank + 1) * 64 / n_split; ++p) {
      const uint32_t at = stash + p * 128 * 8;
      float2 x = ld_cluster_f2(at, 0);
      for (int src = 1; src < n_split; ++src) {
        const float2 y = ld_cluster_f2(at, src);
        x.x = __fadd_rn(x.x, y.x);
        x.y = __fadd_rn(x.y, y.y);
      }
      const int panel = p / 16, j = (p % 16) / 2, key = kr + 8 * (p & 1);
      if (key < sk)
        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + key) * kv_row + col0 +
                                           panel * kPanelCols + 8 * j) =
            __floats2bfloat162_rn(x.x * mul, x.y * mul);
    }
    cluster_sync();  // no block leaves while the cluster reads its stash
  } else {
    // ---- consumers: row split, 64 keys each and every column; column
    // split, the block's 64 keys and 64 columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int kr0 = k0 + (C::kColSplit ? 0 : 64 * cw);  // this warpgroup's first key
    const int kr = kr0 + 16 * warp + lane / 4;         // this thread's keys kr and kr + 8
    const int kq = 2 * (lane % 4);                     // its first query in each 8-query block
    const int panel0 = C::kColSplit ? cw : 0;          // its first column panel of dk and dv
    const unsigned char* smem_at = smem_raw + (base - raw);  // base as a generic pointer

    float dka[C::kOutPanels][32], dva[C::kOutPanels][32];
#pragma unroll
    for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[panel][i] = dva[panel][i] = 0.f;
    if (n_tiles > 0) mbar_wait(kv_bar, 0);
    const uint32_t k_wg = k_s + (C::kColSplit ? 0 : 64 * cw * kRowBytes);
    const uint32_t v_wg = v_s + (C::kColSplit ? 0 : 64 * cw * kRowBytes);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages;
      const int h = g * rep + (it_lo + it) / per_head;
      const int q0 = q_begin + (it_lo + it) % per_head * C::kBQ;
      const uint32_t st = ring + s * C::kStageBytes;
      // the tile's first row in the stage's lse and D boxes
      const int shift = ((b * n_heads + h) * sq + q0) & 3;
      const float* lse_s =
          reinterpret_cast<const float*>(smem_at + (st - base) + 2 * C::kQTileBytes) + shift;
      const float* d_s = lse_s + C::kStatSlot / 4;
      mbar_wait(bars + 8 * s, (it / C::kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, f32)
      float sc[32], dp[32];
      s_and_dp<DH>(sc, dp, k_wg, st, v_wg, st + C::kQTileBytes, C::kKPanelBytes,
                   C::kQPanelBytes);
      const int qp0 = q0 + pos_off;  // the tile's first query, on k's positions
      if (kr0 + 64 > sk || q0 + C::kBQ > sq || (causal && kr0 + 63 > qp0) ||
          (window > 0 && kr0 <= qp0 + C::kBQ - 1 - window))
        dkdv_tile<true, C>(sc, dp, dka, dva, st, panel0 * C::kQPanelBytes, lse_s, d_s, scale, q0,
                           kr, kq, sq, sk, causal, window, pos_off);
      else
        dkdv_tile<false, C>(sc, dp, dka, dva, st, panel0 * C::kQPanelBytes, lse_s, d_s, scale, q0,
                            kr, kq, sq, sk, causal, window, pos_off);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + s));  // this warp is done with stage s
    }

    // dk = scale dK and dv = dV, rounded to bf16 once
    const long long kv_row = static_cast<long long>(n_kv) * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kr + 8 * r;
      if (key >= sk) continue;
      const long long at = (static_cast<long long>(b) * sk + key) * kv_row +
                           static_cast<long long>(g) * DH + panel0 * kPanelCols + kq;
#pragma unroll
      for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * r;
          const long long e = at + panel * kPanelCols + 8 * j;
          *reinterpret_cast<__nv_bfloat162*>(dk + e) =
              __floats2bfloat162_rn(dka[panel][i] * scale, dka[panel][i + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + e) =
              __floats2bfloat162_rn(dva[panel][i], dva[panel][i + 1]);
        }
    }
  }
}

// A 1-D f32 tensor (n elements, 16-byte aligned) as TMA boxes of `box`.
bool make_map_1d(CUtensorMap* map, const void* ptr, long long n, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};  // rank 1: not read
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t steps[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides,
                boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* lse,
              const void* dout, void* dq, void* dsum, int batch, int sq, int sk, int n_heads,
              int n_kv, int causal, int window, int pos_off, float scale, cudaStream_t stream) {
  using C = DqCfg<DH>;
  // the runtime call first: it binds the device's context to this thread,
  // which the tensor maps' encoding reads (see make_map)
  const auto kernel = flash_bwd_dq_wgmma_kernel<DH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, n_heads * DH, sq, batch, C::kBQ) ||
      !make_map(&mdo, dout, n_heads * DH, sq, batch, C::kBQ) ||
      !make_map(&mk, k, n_kv * DH, sk, batch, C::kBK) ||
      !make_map(&mv, v, n_kv * DH, sk, batch, C::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((sq + C::kBQ - 1) / C::kBQ, n_heads, batch);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(dsum), sq, sk, n_heads, n_kv, causal, window, pos_off, scale);
  return static_cast<int>(cudaGetLastError());
}

// The head_dim-256 dkdv launch: a cluster of dkdv_split blocks a key tile.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster;
  int split;

  ClusterLaunch(int batch, int sk, int n_kv, cudaStream_t stream) {
    using C = DkdvCfg<256>;
    const int key_tiles = (sk + C::kBK - 1) / C::kBK;
    split = dkdv_split(key_tiles * n_kv * batch);
    cfg.gridDim = dim3(key_tiles * split, n_kv, batch);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = C::kSmem;
    cfg.stream = stream;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = split;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;  // cfg points at cluster
};

template <int DH>
int launch_dkdv(const void* q, const void* k, const void* v, const void* lse, const void* dout,
                const void* dsum, void* dk, void* dv, int batch, int sq, int sk, int n_heads,
                int n_kv, int causal, int window, int pos_off, float scale, cudaStream_t stream) {
  using C = DkdvCfg<DH>;
  const auto kernel = flash_bwd_dkdv_wgmma_kernel<DH>;  // first: see launch_dq
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(batch) * n_heads * sq;
  CUtensorMap mq, mk, mv, mdo, mlse, mdsum;
  if (rows >= (1ll << 31) || !make_map(&mq, q, n_heads * DH, sq, batch, C::kBQ) ||
      !make_map(&mdo, dout, n_heads * DH, sq, batch, C::kBQ) ||
      !make_map(&mk, k, n_kv * DH, sk, batch, C::kBK) ||
      !make_map(&mv, v, n_kv * DH, sk, batch, C::kBK) ||
      !make_map_1d(&mlse, lse, rows, C::kStatBox) || !make_map_1d(&mdsum, dsum, rows, C::kStatBox))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (C::kRoleSplit) {
    const ClusterLaunch launch(batch, sk, n_kv, stream);
    const cudaError_t launched = cudaLaunchKernelEx(
        &launch.cfg, kernel, mq, mk, mv, mdo, mlse, mdsum, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), sq, sk, n_heads, n_kv, causal, window, pos_off, scale);
    if (launched != cudaSuccess) return static_cast<int>(launched);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((sk + C::kBK - 1) / C::kBK, n_kv, batch);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, mlse, mdsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, sk, n_heads, n_kv, causal, window, pos_off, scale);
  return static_cast<int>(cudaGetLastError());
}

// The head_dim-256 dkdv launch's cluster: the split n that launch_dkdv
// takes for these shapes and how many such clusters the card holds at once.
int dkdv_grid(int batch, int sk, int n_kv, int* split, int* clusters) {
  const auto kernel = flash_bwd_dkdv_wgmma_kernel<256>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DkdvCfg<256>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ClusterLaunch launch(batch, sk, n_kv, nullptr);
  *split = launch.split;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &launch.cfg));
}

}  // namespace hopper

// The Hopper route: bf16 at head_dim 64, 128 or 256, the arguments of
// flash_attention_bwd_dq without is_bf16 (every pointer 16-byte aligned).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another head_dim or a tensor map that cuTensorMapEncodeTiled refuses).
extern "C" int flash_attention_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                            const void* o, const void* lse, const void* dout,
                                            void* dq, void* dsum, int batch, int sq, int sk,
                                            int n_heads, int n_kv, int head_dim, int causal,
                                            int window, int pos_off, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return hopper::launch_dq<64>(q, k, v, o, lse, dout, dq, dsum, batch, sq, sk, n_heads, n_kv,
                                   causal, window, pos_off, scale, st);
    case 128:
      return hopper::launch_dq<128>(q, k, v, o, lse, dout, dq, dsum, batch, sq, sk, n_heads,
                                    n_kv, causal, window, pos_off, scale, st);
    case 256:
      return hopper::launch_dq<256>(q, k, v, o, lse, dout, dq, dsum, batch, sq, sk, n_heads,
                                    n_kv, causal, window, pos_off, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same for dk and dv, as flash_attention_bwd_dkdv without is_bf16; also
// cudaErrorInvalidValue when B * H * Sq reaches 2^31 (the lse and D rows are
// addressed by one int).
extern "C" int flash_attention_bwd_dkdv_wgmma(const void* q, const void* k, const void* v,
                                              const void* lse, const void* dout,
                                              const void* dsum, void* dk, void* dv, int batch,
                                              int sq, int sk, int n_heads, int n_kv,
                                              int head_dim, int causal, int window, int pos_off,
                                              float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return hopper::launch_dkdv<64>(q, k, v, lse, dout, dsum, dk, dv, batch, sq, sk, n_heads,
                                     n_kv, causal, window, pos_off, scale, st);
    case 128:
      return hopper::launch_dkdv<128>(q, k, v, lse, dout, dsum, dk, dv, batch, sq, sk, n_heads,
                                      n_kv, causal, window, pos_off, scale, st);
    case 256:
      return hopper::launch_dkdv<256>(q, k, v, lse, dout, dsum, dk, dv, batch, sq, sk, n_heads,
                                      n_kv, causal, window, pos_off, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// At head_dim 256: the split (the cluster's blocks a key tile) that
// flash_attention_bwd_dkdv_wgmma takes for these shapes, and how many such
// clusters the card holds at once (cudaOccupancyMaxActiveClusters).
// Returns a cudaError_t.
extern "C" int flash_attention_bwd_dkdv_wgmma_grid(int batch, int sk, int n_kv, int* split,
                                                   int* clusters) {
  return hopper::dkdv_grid(batch, sk, n_kv, split, clusters);
}
