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
// backward).  Two kernels, launched in this order on one stream, both
// deterministic: no atomics, every output element written by one thread
// after sums in a fixed order.  Templated on T (bf16 or f32) and DH (16, 32,
// 64, 128, 256); 256 threads as 16 x 16; every operand staged in shared
// memory as f32 and every product an f32 FMA on the CUDA cores.
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
//
// What bounds it on an H100: operations.  Over the visible pairs the
// function needs five products of head_dim FMAs (S, dP, dQ, dK, dV); these
// kernels compute seven (each recomputes S and dP).  On the CUDA cores the
// five take 10 dh FLOP a pair at 67 TFLOP/s.  On the bf16 tensor cores, with
// P and dS each split into three bf16 parts as the forward splits p (S and dP
// one product each, dV, dQ and dK three each), 22 dh FLOP a pair at 989
// TFLOP/s.  This is the simple kernel; its redesign for the tensor cores
// waits in ROADMAP B.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
    REPRO_DQ(64)
    REPRO_DQ(128)
    REPRO_DQ(256)
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
    REPRO_DKDV(64)
    REPRO_DKDV(128)
    REPRO_DKDV(256)
  }
#undef REPRO_DKDV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Sq, H, dh), k and v (B, Sk, Kv, dh), dout and dq like q, in T (bf16
// if is_bf16, else f32); o (B, Sq, H, dh) f32 and lse (B, H, Sq) f32 from the
// forward's training instantiation; dsum (B, H, Sq) f32 receives D.  window
// <= 0: no window; pos_off = q_off - k_off.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for another head_dim).
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
