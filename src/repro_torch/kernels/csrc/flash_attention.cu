// Flash attention (online softmax) with causal and sliding-window masks, sm_90a.
//
//   out[b, i, h] = sum_j p_ij v[b, j, g] / sum_j p_ij,   g = h / (H / Kv)
//   p_ij = exp(s_ij - max_j s_ij) over the visible keys j, 0 elsewhere
//   s_ij = (q[b, i, h] . k[b, j, g]) * scale       (f32 dot, scale after it)
//   visible: j < Sk, j <= i when causal, j > i - window when window > 0
//
// q (B, Sq, H, dh), k and v (B, Sk, Kv, dh), out (B, Sq, H, dh), all
// contiguous, bf16 or f32; everything inside is f32 and the output is
// rounded to the input type once (__float2bfloat16_rn for bf16).  A row
// with no visible key gives 0.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _flash_kernel), which the JAX package reaches
// through repro/kernels/ops.py:flash_attention and whose jnp twin
// repro/models/layers.py:chunked_attention is what the models call.  See
// kernels/flash_attention.py for the design note; in short:
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
//     while the running max is still -1e30 (expf, not __expf, throughout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K tiles [64][DH + 4], V tile [64][DH], P tile [64][kPLd], f32
  return sizeof(float) * (2 * kBQ * (DH + 4) + kBK * DH + kBQ * kPLd);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
                 int n_heads, int n_kv, int causal, int window, float scale) {
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
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, q0 + kBQ);
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;

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
      const int qpos = q0 + ty * kRows + i;
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
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= sq) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
    T* orow = out + (b * sq + qpos) * q_row + (long long)h * DH + tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store1(orow + c, acc[i][c] / safe);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int sq, int sk, int n_heads, int n_kv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, n_heads, n_kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v, void* out,
             int batch, int sq, int sk, int n_heads, int n_kv, int causal,
             int window, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, batch, sq, sk, n_heads, n_kv, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: device pointers (see above); is_bf16: 1 for bf16, 0 for f32;
// window <= 0: no window.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int batch, int sq, int sk,
                                   int n_heads, int n_kv, int head_dim,
                                   int is_bf16, int causal, int window,
                                   float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(head_dim, q, k, v, out, batch, sq, sk, n_heads,
                                   n_kv, causal, window, scale, st);
  return dispatch<float>(head_dim, q, k, v, out, batch, sq, sk, n_heads, n_kv,
                         causal, window, scale, st);
}
