// Flash attention (online softmax) with causal and sliding-window masks, sm_90a.
//
//   out[b, i, h] = sum_j p_ij v[b, j, g] / sum_j p_ij,   g = h / (H / Kv)
//   p_ij = exp(s_ij - max_j s_ij) over the visible keys j, 0 elsewhere
//   s_ij = (q[b, i, h] . k[b, j, g]) * scale       (f32 dot, scale after it)
//   visible: j < Sk, j + k_off <= i + q_off when causal,
//            j + k_off > i + q_off - window when window > 0
//
// q_off and k_off are the positions of q's and k's first rows in the whole
// sequence, passed as their difference pos_off = q_off - k_off (0 for a call on
// whole sequences): the port's chunked_attention calls the kernel once per
// query chunk on the reference's key slice of that chunk (a window without
// causality) and the masks read absolute positions.  Each kernel has a second
// instantiation for pos_off != 0 (kOff); the one for 0 is the code without
// offsets, because an offset read at run time slowed the wgmma kernel at
// granite's 32k layer on an H100, with the same registers and spills (see
// PERF.md).
//
// q (B, Sq, H, dh), k and v (B, Sk, Kv, dh), out (B, Sq, H, dh), all
// contiguous; the softmax, p and the sums are f32 and the output is rounded
// to the input type once.  A row with no visible key gives 0.
//
// Each kernel has a training instantiation (kTrain, entry points *_train):
// it writes O unrounded in f32, and after O in the same buffer the row's
// log-sum-exp lse = m + log(l) in f32, (B, H, Sq), +inf for a row with no
// visible key (so exp(s - lse) = 0 for every key); the backward
// (flash_attention_bwd.cu) reads both.  Rounded to bf16 by the caller, O is
// the inference instantiation's output: the same f32 value, rounded to
// nearest.  The inference instantiations are the code without kTrain, so
// their SASS is the one they had before it (scripts/flash_probe.py
// --baseline compares them).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _flash_kernel), which the JAX package reaches
// through repro/kernels/ops.py:flash_attention and whose jnp twin
// repro/models/layers.py:chunked_attention is what the models call.  Two
// kernels, chosen by the wrapper from the dtype and head_dim alone (see
// kernels/flash_attention.py for the design note):
//
// flash_fwd_wgmma_kernel -- bf16 at head_dim 64, 128 and 256, on the tensor
// cores.
//   * one block of three warpgroups per (query tile, head, batch row) (short
//     sequences: the packed grid below), the heaviest causal tiles first:
//     warpgroup 0 is the producer, one thread of
//     which loads Q once and keeps a ring of K/V tiles full by TMA, signalled
//     through mbarriers; warpgroups 1 and 2 are the consumers (setmaxnreg:
//     24 / 240).  Cfg<DH> sets the tiles and the split:
//       dh 64, 128: 128 queries and 128-key tiles (3 stages at dh 64, 2 at
//       128); each consumer owns 64 query rows and every column (row split);
//       dh 256: 64 queries and 64-key tiles, 3 stages (Q 32 KB, a stage of K
//       and V 64 KB: 230,456 B with the alignment and the barriers).  Both
//       consumers own the same 64 rows and split the output columns: each
//       computes the whole S and the same softmax, so m and l are bitwise
//       equal in both and nothing is exchanged, and each writes 128 columns.
//       A thread holds S (32), the split p (48), O (2 x 32) and one P.V
//       accumulator (32): ~180 registers of 240, where 128-key tiles and a
//       row split would take ~320 (ptxas: 168 a thread at launch, before
//       setmaxnreg, no spills).  The cost is one product of five computed
//       twice (S), and its exponentials; splitting S by head_dim between
//       the consumers and adding the halves through shared memory ran
//       slower on an H100 (scripts/flash_probe.py);
//   * TMA boxes of 64 columns x (128 or 64) rows over (B, S, H*dh),
//     128-byte swizzled; a head_dim is dh / 64 such column panels; rows past
//     S arrive as zeros, so nothing is padded on the host and keys past Sk
//     are masked; GQA loads kv head h / (H / Kv) and repeats nothing;
//   * S = Q K^T by wgmma m64n128k16 (m64n64k16 at dh 256) from shared memory
//     with an f32 accumulator: q and k are bf16, so every product is exact
//     and this is the reference's f32 dot up to the order of the sums; then
//     s = S * scale;
//   * the running max, denominator and accumulator stay in registers;
//     masked logits are the -1e30 sentinel and give p = 0, tested only on the
//     tiles that the causal, window or Sk edge crosses for the warpgroup's
//     rows (a second instantiation of the softmax for them);
//     p = ex2(s log2 e - m log2 e), one FFMA and ex2.approx (about 2 f32
//     ulps of p);
//   * P.V at the reference's f32 p: each p is split in registers into
//     p1 = bf16(p), p2 = bf16(p - p1), p3 = p - p1 - p2 (exact: each part is
//     bf16 and each subtraction exact, for p >= 2^-110), and three
//     register-A wgmma m64n64k16 per 16 keys and 64 columns add P1 V, P2 V
//     and P3 V into one f32 accumulator; v is bf16, so every product is
//     exact.  The tensor cores' f32 accumulation does not round like a
//     chain of round-to-nearest FMAs, and accumulated over a 32k row its
//     drift exceeded one bf16 ulp near zero; so each tile's P.V starts from
//     zero and is added to the running O on the CUDA cores (O = O corr +
//     P.V, as the reference adds each tile's dot).  The one-bf16-ulp checks
//     on the card are what hold the result;
//   * P.V is issued in 4 batches a tile (32 keys at dh 64 and 128, 16 at
//     256): p and its split for a batch are computed while the products of
//     the batches before it run.  At dh 256, 4 batches and 3 stages ran
//     1-2% faster than 2 batches or 2 stages (scripts/flash_probe.py).
//   * short sequences, the packed grid (pack_shift): self-attention on
//     whole sequences whose length S divides the 128-row tile and is below
//     it (dh 64 and 128, inference) would leave a (query tile, head, batch
//     row) block S of its 128 rows: at the FedNL probe's backbone layer (B
//     512, S 16) 16,384 blocks, each paying the fixed cost of barriers,
//     setmaxnreg, the tensor maps and three TMA round trips for 16 rows,
//     where the bound is the 83.9 MB of q, k, v and out (25 us).  The packed
//     instantiation (kPack) takes the tensor maps over the flat (B S, H dh)
//     rows, so a block holds 128 / S whole sequences of one head (grid (B S
//     / 128, H): 2,048 blocks at the probe, both consumers full) and its one
//     key tile is its own rows; a key is visible only within its query's
//     sequence (key >> log2 S == row >> log2 S), causality and the window
//     compare flat positions, which within a sequence is the same, and every
//     tile takes the edge softmax.  Each row sees the same keys; their
//     columns, and so the order of the f32 row sums, differ;
//   What still holds it back: a consumer waits for its S before its softmax
//   and for each panel's P.V before the next, so its exponentials and
//   conversions overlap the tensor cores only through the other consumer
//   and the batches; at dh 256 the two consumers run the same softmax at
//   the same time, and S is computed twice; on the packed grid each block
//   still pays the fixed cost above for its one tile.
//
// flash_fwd_kernel -- the SIMT kernel: f32 at any head_dim, bf16 at 16 and 32
// (head dims that only reduced configurations have).
//   * one launch per attention call: blockIdx.x is a 64-query tile (the
//     heaviest causal tiles first), blockIdx.y the query head, blockIdx.z the
//     batch row; the kv head is h / (H / Kv), so GQA repeats nothing;
//   * the TPU grid's sequential kv axis is the loop over 64-key tiles inside
//     the block, carrying the running max m, denominator l and accumulator in
//     registers; tiles that the causal or window mask fully hides are never
//     visited, and keys past Sk and queries past Sq are bounds-checked, so
//     nothing is padded on the host;
//   * Q (once) and each K/V tile are staged in shared memory as f32; each of
//     the 256 threads computes a 4 x 4 block of the 64 x 64 logits with f32
//     FMA, the row max and sum go through 16-lane shuffles, P is staged in
//     shared memory in f32 and each thread accumulates a 4 x (dh/16) block of
//     P.V in f32 -- p is never rounded to bf16, as in the reference;
//   * masked logits are the reference's -1e30 sentinel and give p = 0 even
//     while the running max is still -1e30 (expf, not __expf, throughout);
//   * at head_dim 256 (f32) the tiles take smem_bytes<256>() = 216,064 B,
//     under the 227 KB a block may opt into, so one block runs on an SM, and
//     each thread carries 4 x 16 accumulators and 4 x 16 partial P.V sums.

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // keys per tile
constexpr int kSide = 16;              // 16 x 16 threads
constexpr int kThreads = kSide * kSide;
constexpr int kRows = kBQ / kSide;     // query rows per thread
constexpr int kKeys = kBK / kSide;     // keys per thread in the logits
constexpr int kPLd = kBK + 4;          // padded row of the P tile (floats)
constexpr float kNeg = -1e30f;         // the reference's _NEG

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

// The output type: the input type for inference, f32 for training.
template <typename T, bool kTrain>
using OutT = typename std::conditional<kTrain, float, T>::type;

// A row's log-sum-exp from its max m and sum l = sum exp(s - m); +inf where
// no key is visible (l = 0).
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K tiles [64][DH + 4], V tile [64][DH], P tile [64][kPLd], f32
  return sizeof(float) * (2 * kBQ * (DH + 4) + kBK * DH + kBQ * kPLd);
}

template <typename T, int DH, bool kOff, bool kTrain>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, OutT<T, kTrain>* __restrict__ out, int sq, int sk,
                 int n_heads, int n_kv, int causal, int window, int pos_off_arg,
                 float scale) {
  const int pos_off = kOff ? pos_off_arg : 0;  // kOff: the launcher saw pos_off != 0
  constexpr int kLd = DH + 4;          // padded row of the Q and K tiles
  constexpr int kCols = DH / kSide;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;                   // [kBK][kLd]
  float* vs = ks + kBK * kLd;                   // [kBK][DH]
  float* ps = vs + kBK * DH;                    // [kBQ][kPLd]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int tx = tid % kSide;          // key / output-column group
  const int ty = tid / kSide;          // query-row group: rows ty*kRows + i

  const long long q_row = (long long)n_heads * DH;  // stride of one position
  const long long kv_row = (long long)n_kv * DH;
  const T* qb = q + b * sq * q_row + (long long)h * DH;
  const T* kb = k + b * sk * kv_row + (long long)kvh * DH;
  const T* vb = v + b * sk * kv_row + (long long)kvh * DH;

  for (int i = tid; i < kBQ * DH / 4; i += kThreads) {
    const int r = i * 4 / DH, c = i * 4 % DH;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < sq) load4(qb + (q0 + r) * q_row + c, x);
    *reinterpret_cast<float4*>(&qs[r * kLd + c]) = make_float4(x[0], x[1], x[2], x[3]);
  }

  // the key tiles that hold a visible key for some query of this tile
  const int p0 = q0 + pos_off;  // the tile's first query, on k's positions
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, p0 + kBQ);
  if (window > 0) k_begin = max(0, p0 - window + 1) / kBK * kBK;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the Q tile is in; the last tile's readers are done
    for (int i = tid; i < kBK * DH / 4; i += kThreads) {
      const int r = i * 4 / DH, c = i * 4 % DH;
      float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < sk) {
        load4(kb + (k0 + r) * kv_row + c, x);
        load4(vb + (k0 + r) * kv_row + c, y);
      }
      *reinterpret_cast<float4*>(&ks[r * kLd + c]) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(&vs[r * DH + c]) = make_float4(y[0], y[1], y[2], y[3]);
    }
    __syncthreads();

    // logits: rows ty*kRows + i, keys tx + kSide*j
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[kRows], ka[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&qs[(ty * kRows + i) * kLd + d]);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&ks[(tx + kSide * j) * kLd + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // mask, online softmax; the 16 threads of a row group share a half-warp
    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = p0 + ty * kRows + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + tx + kSide * j;
        const bool visible = kpos < sk && (!causal || kpos <= qpos) &&
                             (window <= 0 || kpos > qpos - window);
        s[i][j] = visible ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = s[i][j] <= kNeg / 2 ? 0.f : expf(s[i][j] - m_new);
        ps[(ty * kRows + i) * kPLd + tx + kSide * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off /= 2)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * corr + P.V: rows ty*kRows + i, columns tx*kCols + c
    float pv[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) pv[i][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&ps[(ty * kRows + i) * kPLd + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kCols];
        const float* vrow = &vs[(j + jj) * DH + tx * kCols];
        if constexpr (kCols % 4 == 0) {
#pragma unroll
          for (int c = 0; c < kCols; c += 4) load4(vrow + c, &vv[c]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) pv[i][c] = fmaf(p, vv[c], pv[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = acc[i][c] * corr[i] + pv[i][c];
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = p0 - pos_off + ty * kRows + i;
    if (qpos >= sq) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
    OutT<T, kTrain>* orow = out + (b * sq + qpos) * q_row + (long long)h * DH + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store1(orow + c, acc[i][c] / safe);
    if constexpr (kTrain) {
      // the lse after O: (B, H, Sq)
      if (tx == 0)
        out[(long long)gridDim.z * sq * q_row + (b * n_heads + h) * sq + qpos] =
            row_lse(m[i], l[i]);
    }
  }
}

template <typename T, int DH, bool kTrain>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int sk, int n_heads, int n_kv, int causal, int window,
           int pos_off, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  const auto kernel = pos_off != 0 ? flash_fwd_kernel<T, DH, true, kTrain>
                                   : flash_fwd_kernel<T, DH, false, kTrain>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<OutT<T, kTrain>*>(out), sq, sk, n_heads, n_kv, causal, window, pos_off, scale);
  return static_cast<int>(cudaGetLastError());
}

// f32 at every head_dim; bf16 only where flash_route sends it to this kernel
// (16 and 32: the wgmma kernel takes 64, 128 and 256)
template <typename T, bool kTrain>
int dispatch(int head_dim, const void* q, const void* k, const void* v, void* out,
             int batch, int sq, int sk, int n_heads, int n_kv, int causal,
             int window, int pos_off, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16, kTrain>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, pos_off, scale, stream);
    case 32: return launch<T, 32, kTrain>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, pos_off, scale, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (head_dim) {
      case 64: return launch<T, 64, kTrain>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, pos_off, scale, stream);
      case 128: return launch<T, 128, kTrain>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, pos_off, scale, stream);
      case 256: return launch<T, 256, kTrain>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, pos_off, scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, out: device pointers (see above); is_bf16: 1 for bf16 (head_dim 16
// or 32), 0 for f32 (16, 32, 64, 128 or 256); window <= 0: no window;
// pos_off = q_off - k_off (0 on whole sequences).  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for another dtype and head_dim).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int batch, int sq, int sk,
                                   int n_heads, int n_kv, int head_dim,
                                   int is_bf16, int causal, int window, int pos_off,
                                   float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16, false>(head_dim, q, k, v, out, batch, sq, sk, n_heads,
                                          n_kv, causal, window, pos_off, scale, st);
  return dispatch<float, false>(head_dim, q, k, v, out, batch, sq, sk, n_heads, n_kv,
                                causal, window, pos_off, scale, st);
}

// The training instantiation of the same: out is f32, B * Sq * H * dh for O
// and then B * H * Sq for the lse.
extern "C" int flash_attention_fwd_train(const void* q, const void* k, const void* v,
                                         void* out, int batch, int sq, int sk,
                                         int n_heads, int n_kv, int head_dim,
                                         int is_bf16, int causal, int window, int pos_off,
                                         float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16, true>(head_dim, q, k, v, out, batch, sq, sk, n_heads,
                                         n_kv, causal, window, pos_off, scale, st);
  return dispatch<float, true>(head_dim, q, k, v, out, batch, sq, sk, n_heads, n_kv,
                               causal, window, pos_off, scale, st);
}

// ===========================================================================
// The Hopper route: bf16 at head_dim 64, 128 and 256 (flash_fwd_wgmma_kernel)
// ===========================================================================

namespace hopper {

// The tiles, and how the two consumer warpgroups share a block's work.  At
// head_dim 64 and 128 (row split) each consumer owns 64 of the block's 128
// query rows and every column, over 128-key tiles.  At head_dim 256 (column
// split) a 128-key K or V tile would take 64 KB and O 128 registers a thread,
// so a block has 64 query rows and 64-key tiles, and both consumers own those
// rows and write their own 128 of the 256 output columns.  Each computes the
// whole S and the same softmax: the same instructions on the same data, so m
// and l are bitwise equal in both and nothing is exchanged.
template <int DH>
struct Cfg {
  static constexpr bool kColSplit = DH == 256;
  static constexpr int kBQ = kColSplit ? 64 : 128;                // query rows per block
  static constexpr int kBK = kColSplit ? 64 : 128;                // keys per tile
  static constexpr int kPanels = DH / kPanelCols;                 // of Q, K and V
  static constexpr int kOutPanels = kColSplit ? kPanels / 2 : kPanels;  // a consumer's output
  static constexpr int kStages = DH == 128 ? 2 : 3;                // the K/V ring
  static constexpr int kPhases = 4;                               // P.V batches of a tile
  static constexpr int kPanelBytes = kBQ * kRowBytes;             // kBQ rows x 64 columns
  static constexpr int kTileBytes = kPanels * kPanelBytes;        // the Q tile, one K or one V tile
  static constexpr int kStageBytes = 2 * kTileBytes;              // K, then V
  static constexpr int kBarOffset = kTileBytes + kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);  // + 1024-B alignment
  static_assert(kBQ == kBK, "one box shape serves Q, K and V");
  static_assert((kBK / 16) % kPhases == 0, "whole 16-key chunks in each P.V batch");
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// The online softmax of one 64 x kBK tile in registers (N = kBK / 2
// accumulators a thread), first part: s = S * scale, masked to -1e30 on a
// tile that an edge crosses (kEdge), the running max m and the rescale
// factor corr of the earlier tiles.  kPack: rows and keys are positions in
// the flat (B S) sequence of a packed tile, and a key is visible only within
// its query's sequence (the same position >> seg_shift, S = 2**seg_shift);
// causality and the window then compare the same positions as within the
// sequence.
template <bool kEdge, bool kPack, int N>
__device__ __forceinline__ void softmax_max(float (&sc)[N], float (&m)[2], float (&corr)[2],
                                            float scale, int k0, int ra, int kq, int sk,
                                            int causal, int window, int seg_shift) {
  // row r's max in four independent chains (k = 8-column block % 4): two
  // warps per scheduler leave little else to hide a chain's latency
  float mx[4][2];
#pragma unroll
  for (int k = 0; k < 4; ++k) mx[k][0] = m[0], mx[k][1] = m[1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = __fmul_rn(sc[i], scale);  // scale after the dot, as the reference
    if (kEdge) {
      const int key = k0 + 8 * (i / 4) + kq + (i & 1);
      const int row = ra + 8 * ((i / 2) & 1);
      const bool visible = key < sk && (!kPack || ((key ^ row) >> seg_shift) == 0) &&
                           (!causal || key <= row) && (window <= 0 || key > row - window);
      x = visible ? x : kNeg;
    }
    sc[i] = x;
    mx[(i / 4) % 4][(i / 2) & 1] = fmaxf(mx[(i / 4) % 4][(i / 2) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float row_max = fmaxf(fmaxf(mx[0][r], mx[1][r]), fmaxf(mx[2][r], mx[3][r]));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    corr[r] = ex2(__fsub_rn(m[r], row_max) * kLog2e);
    m[r] = row_max;
  }
}

// Second part, for the keys 16 c0 .. 16 c1 - 1 of the tile: p = exp(s - m)
// (0 where masked), added to the row sums rs (four chains per row), and
// split into three exact bf16 parts in the register-A fragment layout: for
// keys 16c.., registers (row ra, keys +kq), (ra + 8, +kq), (ra, +8+kq),
// (ra + 8, +8+kq) are accumulator pairs 8c + 2j, 8c + 2j + 1.  exp is
// ex2.approx with log2 e folded into one FFMA: about 2 f32 ulps of p, and
// the rounding of m log2 e is a factor common to the row's p in one tile.
template <bool kEdge, int kChunks>
__device__ __forceinline__ void exp_split(float (&sc)[8 * kChunks], const float (&m)[2],
                                          float (&rs)[4][2], uint32_t (&pa)[3][kChunks][4],
                                          int c0, int n_chunks) {
  const float neg_m_log2e[2] = {-m[0] * kLog2e, -m[1] * kLog2e};
#pragma unroll
  for (int k = 0; k < 8 * n_chunks; ++k) {
    const int i = 8 * c0 + k;
    const int r = (i / 2) & 1;
    float p = ex2(fmaf(sc[i], kLog2e, neg_m_log2e[r]));
    if (kEdge && sc[i] <= kNeg / 2) p = 0.f;  // masked: 0 even while m is still -1e30
    sc[i] = p;
    rs[(i / 4) % 4][r] += p;
  }
#pragma unroll
  for (int c = c0; c < c0 + n_chunks; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split3(sc[8 * c + 2 * j], sc[8 * c + 2 * j + 1], pa[0][c][j], pa[1][c][j], pa[2][c][j]);
}
// The rest of one tile after S = Q K^T: the online softmax, P split into its
// three bf16 parts, this tile's P.V = P1 V + P2 V + P3 V in a fresh f32
// accumulator per 64-column panel of the consumer's output (V, keys x DH, is
// MN-major; v_s is its first output panel), then O = O corr + P.V on the
// CUDA cores, as the reference adds each tile's dot: the tensor cores'
// accumulation spans one tile's keys, never the whole row.  P.V is issued in
// C::kPhases batches of keys, and p of each batch is computed while the
// products of the batches before it run.
template <bool kEdge, bool kPack, typename C>
__device__ __forceinline__ void tile_pv(float (&sc)[C::kBK / 2], float (&m)[2], float (&l)[2],
                                        float (&o)[C::kOutPanels][32], uint32_t v_s, float scale,
                                        int k0, int ra, int kq, int sk, int causal, int window,
                                        int seg_shift) {
  constexpr int kChunks = C::kBK / 16;                 // 16-key chunks of the tile
  constexpr int kPhaseChunks = kChunks / C::kPhases;   // ... per batch
  float corr[2], rs[4][2] = {};
  uint32_t pa[3][kChunks][4];
  softmax_max<kEdge, kPack>(sc, m, corr, scale, k0, ra, kq, sk, causal, window, seg_shift);
#pragma unroll
  for (int panel = 0; panel < C::kOutPanels; ++panel) {
    float pv[32] = {};  // overwritten by the first product (scale_d = 0)
    const uint32_t v_panel = v_s + panel * C::kPanelBytes;
#pragma unroll
    for (int ph = 0; ph < C::kPhases; ++ph) {
      const int c0 = ph * kPhaseChunks;
      if (panel == 0) {
        // after the last batch's issue: keep this batch's p from being
        // computed before it
#pragma unroll
        for (int k = 0; k < 8 * kPhaseChunks; ++k)
          asm volatile("" : "+f"(sc[8 * c0 + k])::"memory");
        exp_split<kEdge>(sc, m, rs, pa, c0, kPhaseChunks);
      }
      if (panel == 0 || ph == 0) wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int c = c0; c < c0 + kPhaseChunks; ++c)
          wgmma_rs_n64(pv, pa[part][c], smem_desc(v_panel + c * 16 * kRowBytes),
                       part > 0 || c > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[panel][i] = o[panel][i] * corr[(i / 2) & 1] + pv[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((rs[0][r] + rs[1][r]) + (rs[2][r] + rs[3][r]));
#pragma unroll
  for (int part = 0; part < 3; ++part)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(pa[part][c]);
}

// kPack: the packed grid (see pack_shift): one block holds 128 / S whole
// sequences of one head, the tensor maps and sq = sk run over the flat (B S)
// rows, and the block's one key tile is its own rows.
template <int DH, bool kOff, bool kTrain, bool kPack = false>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       OutT<__nv_bfloat16, kTrain>* __restrict__ out, int sq, int sk, int n_heads,
                       int n_kv, int causal, int window, int pos_off_arg, float scale,
                       int seg_shift) {
  using C = Cfg<DH>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK;
  const int pos_off = kOff ? pos_off_arg : 0;  // kOff: the launcher saw pos_off != 0
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                      // [panel][kBQ rows][64 columns]
  const uint32_t ring = base + C::kTileBytes;     // stage s: K tile, then V tile
  const uint32_t bars = base + C::kBarOffset;     // full[kStages], empty[kStages], q
  const uint32_t q_bar = bars + 16 * C::kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);

  // the key tiles that hold a visible key for some query of this block
  const int p0 = q0 + pos_off;  // the block's first query, on k's positions
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, p0 + kBQ);
  if (window > 0) k_begin = max(0, p0 - window + 1) / kBK * kBK;
  if (kPack) k_begin = q0, k_end = min(sk, q0 + kBQ);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

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
    // ---- producer: one thread keeps the ring of K/V tiles filled by TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_bar, C::kTileBytes);
#pragma unroll
      for (int panel = 0; panel < C::kPanels; ++panel)
        tma_load(q_s + panel * C::kPanelBytes, &tm_q, q_bar, h * DH + panel * kPanelCols, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        mbar_wait(bars + 8 * (C::kStages + s), ((it / C::kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t k_s = ring + s * C::kStageBytes;
        const int k0 = k_begin + it * kBK;
        mbar_expect_tx(full, C::kStageBytes);
#pragma unroll
        for (int panel = 0; panel < C::kPanels; ++panel) {
          const int col = kvh * DH + panel * kPanelCols;
          tma_load(k_s + panel * C::kPanelBytes, &tm_k, full, col, k0, b);
          tma_load(k_s + C::kTileBytes + panel * C::kPanelBytes, &tm_v, full, col, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each; row split: rows 64 cw.. of the
    // block and every column; column split: the block's rows and output
    // panels kOutPanels cw.. ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int panel0 = C::kColSplit ? C::kOutPanels * cw : 0;  // its first output panel
    // this warpgroup's first row and this thread's rows (ra and ra + 8), on
    // k's positions; the output row is ra - pos_off.  (Row and Q offsets are
    // written out apart: formed from one shared term, the row split's code
    // was scheduled otherwise by ptxas and ran ~1.5% slower on an H100.)
    const int row0 = q0 + pos_off + (C::kColSplit ? 0 : 64 * cw);
    const int ra = row0 + 16 * warp + lane / 4;
    const int kq = 2 * (lane % 4);                 // its first column in each 8-column block

    float o[C::kOutPanels][32];  // per 64-column panel: the m64n64 accumulator layout
#pragma unroll
    for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[panel][i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    if (n_tiles > 0) mbar_wait(q_bar, 0);
    const uint32_t q_wg = q_s + (C::kColSplit ? 0 : 64 * cw * kRowBytes);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages;
      const int k0 = k_begin + it * kBK;
      const uint32_t k_s = ring + s * C::kStageBytes;
      const uint32_t v_s = k_s + C::kTileBytes + panel0 * C::kPanelBytes;
      mbar_wait(bars + 8 * s, (it / C::kStages) & 1);

      // S = Q K^T (64 x kBK, f32): bf16 products are exact, sums in f32
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        const uint32_t off = (kc / 4) * C::kPanelBytes + (kc % 4) * 32;
        wgmma_ss(sc, smem_desc(q_wg + off), smem_desc(k_s + off), kc > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // masked logits only on tiles that an edge crosses for these rows (a
      // packed tile's sequences are edges)
      if (kPack || k0 + kBK > sk || (causal && k0 + kBK - 1 > row0) ||
          (window > 0 && k0 <= row0 + 63 - window))
        tile_pv<true, kPack, C>(sc, m, l, o, v_s, scale, k0, ra, kq, sk, causal, window,
                                seg_shift);
      else
        tile_pv<false, kPack, C>(sc, m, l, o, v_s, scale, k0, ra, kq, sk, causal, window,
                                 seg_shift);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (C::kStages + s));  // this warp is done with stage s
    }

    // out = O / l (0 where no key is visible), rounded to bf16 once (training:
    // O / l in f32, and the lse)
    float safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      safe[r] = l[r] > 0.f ? l[r] : 1.f;
    }
    const long long q_row = static_cast<long long>(n_heads) * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra - pos_off + 8 * r;
      if (row >= sq) continue;
      OutT<__nv_bfloat16, kTrain>* orow =
          out + (static_cast<long long>(b) * sq + row) * q_row + static_cast<long long>(h) * DH +
          panel0 * kPanelCols + kq;
      if constexpr (kTrain) {
#pragma unroll
        for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(orow + panel * kPanelCols + 8 * j) =
                make_float2(o[panel][4 * j + 2 * r] / safe[r],
                            o[panel][4 * j + 2 * r + 1] / safe[r]);
        // the lse after O, (B, H, Sq): one lane of the row's quad, one consumer
        if (kq == 0 && (!C::kColSplit || cw == 0))
          out[static_cast<long long>(gridDim.z) * sq * q_row +
              (static_cast<long long>(b) * n_heads + h) * sq + row] = row_lse(m[r], l[r]);
      } else {
#pragma unroll
        for (int panel = 0; panel < C::kOutPanels; ++panel)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + panel * kPanelCols + 8 * j) =
                __floats2bfloat162_rn(o[panel][4 * j + 2 * r] / safe[r],
                                      o[panel][4 * j + 2 * r + 1] / safe[r]);
      }
    }
  }
}

// The packed grid's choice: log2 S where a call takes it, else -1.  It
// takes self-attention on whole sequences (sq = sk, pos_off 0) whose
// length S is a power of two below the 128-row tile, at head_dim 64 and 128,
// in the inference instantiation: there a (query tile, head, batch row)
// block would hold S of its 128 rows.  Every other call keeps the grid of
// (query tile, head, batch row).
inline int pack_shift(bool train, int head_dim, int sq, int sk, int pos_off) {
  if (train || (head_dim != 64 && head_dim != 128) || sq != sk || pos_off != 0) return -1;
  if (sq < 1 || sq >= 128 || 128 % sq != 0) return -1;
  int shift = 0;
  while ((1 << shift) < sq) ++shift;
  return shift;
}

template <int DH, bool kTrain>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int sq, int sk,
           int n_heads, int n_kv, int causal, int window, int pos_off, float scale,
           cudaStream_t stream) {
  using C = Cfg<DH>;
  const int shift = pack_shift(kTrain, DH, sq, sk, pos_off);
  // packed: the flat (B S) rows as one sequence of one batch row
  const bool packed = shift >= 0;
  const int rows_q = packed ? batch * sq : sq, rows_k = packed ? batch * sk : sk;
  const int batches = packed ? 1 : batch;
  // the runtime call first: it binds the device's context to this thread,
  // which the tensor maps' encoding reads (see make_map)
  auto kernel = pos_off != 0 ? flash_fwd_wgmma_kernel<DH, true, kTrain>
                             : flash_fwd_wgmma_kernel<DH, false, kTrain>;
  if constexpr (!kTrain && DH != 256) {
    if (packed) kernel = flash_fwd_wgmma_kernel<DH, false, false, true>;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, n_heads * DH, rows_q, batches, C::kBQ) ||
      !make_map(&mk, k, n_kv * DH, rows_k, batches, C::kBK) ||
      !make_map(&mv, v, n_kv * DH, rows_k, batches, C::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows_q + C::kBQ - 1) / C::kBQ, n_heads, batches);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<OutT<__nv_bfloat16, kTrain>*>(out), rows_q, rows_k, n_heads, n_kv,
      causal, window, pos_off, scale, packed ? shift : 0);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrain>
int dispatch(const void* q, const void* k, const void* v, void* out, int batch, int sq, int sk,
             int n_heads, int n_kv, int head_dim, int causal, int window, int pos_off,
             float scale, cudaStream_t st) {
  switch (head_dim) {
    case 64:
      return launch<64, kTrain>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window,
                                pos_off, scale, st);
    case 128:
      return launch<128, kTrain>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window,
                                 pos_off, scale, st);
    case 256:
      return launch<256, kTrain>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window,
                                 pos_off, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace hopper

// The Hopper route: q, k, v, out bf16 device pointers (layout above, 16-byte
// aligned); head_dim 64, 128 or 256; window <= 0: no window; pos_off = q_off -
// k_off (0 on whole sequences).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another head_dim or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                                         int batch, int sq, int sk, int n_heads, int n_kv,
                                         int head_dim, int causal, int window, int pos_off,
                                         float scale, void* stream) {
  return hopper::dispatch<false>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim, causal,
                                 window, pos_off, scale, static_cast<cudaStream_t>(stream));
}

// The grid the Hopper route launches for a call (train: the training
// instantiation): grid[0..2] = (x, y, z); returns log2 S on the packed grid,
// -1 on the grid of (query tile, head, batch row).
extern "C" int flash_attention_fwd_wgmma_grid(int batch, int sq, int sk, int n_heads,
                                              int head_dim, int pos_off, int train, int* grid) {
  const int shift = hopper::pack_shift(train != 0, head_dim, sq, sk, pos_off);
  const int rows = head_dim == 256 ? 64 : 128;
  grid[0] = shift >= 0 ? (batch * sq + rows - 1) / rows : (sq + rows - 1) / rows;
  grid[1] = n_heads;
  grid[2] = shift >= 0 ? 1 : batch;
  return shift;
}

// The training instantiation of the same: out is f32, B * Sq * H * dh for O
// and then B * H * Sq for the lse.
extern "C" int flash_attention_fwd_wgmma_train(const void* q, const void* k, const void* v,
                                               void* out, int batch, int sq, int sk,
                                               int n_heads, int n_kv, int head_dim, int causal,
                                               int window, int pos_off, float scale,
                                               void* stream) {
  return hopper::dispatch<true>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim, causal,
                                window, pos_off, scale, static_cast<cudaStream_t>(stream));
}
