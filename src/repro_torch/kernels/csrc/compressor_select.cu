// Batched TopK selection over packed upper-triangle vectors, FP64 payload, sm_90a.
//
//   keys  = f32(|u|) as int32 bit patterns (the pinned selection keys)
//   thr   = the k-th largest key, by a 31-step binary search on the bits
//   keep  = key > thr, plus the first k - n_gt keys equal to thr in index order
//   out   = keep ? u : +0.0,   sent = k
//
// Replaces the Pallas TPU kernel repro/kernels/compressor_select.py:
// select_topk_pallas (body _topk_kernel), reached through
// repro/kernels/ops.py:select_topk.  See kernels/compressor_select.py for the
// design note; in short: one block of 1024 threads per client; the keys live
// in dynamic shared memory when they fit (T*4 bytes: 181.8 KB at w8a) and are
// recomputed from u in global memory when they do not; every search step is
// one block-wide count; the tie split is an exact block-wide exclusive scan in
// index order, tile by tile, so the lowest indices win as in lax.top_k.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the block reductions use one warp over the warp totals");

__device__ __forceinline__ int rank_key(double v) {
  return __float_as_int(__double2float_rn(fabs(v)));
}

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ int block_sum(int v, int* part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  const int total = __reduce_add_sync(0xffffffffu, part[lane]);
  __syncthreads();  // part is reused by the next call
  return total;
}

template <bool kKeysInShared>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const double* __restrict__ u, double* __restrict__ out,
                   int* __restrict__ sent, int t, int k) {
  extern __shared__ int keys[];  // t entries when kKeysInShared
  __shared__ int part[kWarps];

  const long long c = blockIdx.x;
  const double* uc = u + c * t;
  double* oc = out + c * t;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (kKeysInShared) {
    for (int i = threadIdx.x; i < t; i += kThreads) keys[i] = rank_key(uc[i]);
    __syncthreads();
  }
  auto key_at = [&](int i) -> int {
    return kKeysInShared ? keys[i] : rank_key(uc[i]);
  };

  // k-th largest key: greedy bit-by-bit search, high bit first
  int thr = 0;
  for (int bit = 30; bit >= 0; --bit) {
    const int cand = thr | (1 << bit);
    int cnt = 0;
    for (int i = threadIdx.x; i < t; i += kThreads) cnt += key_at(i) >= cand;
    if (block_sum(cnt, part) >= k) thr = cand;
  }
  int gt_local = 0;
  for (int i = threadIdx.x; i < t; i += kThreads) gt_local += key_at(i) > thr;
  const int need = k - block_sum(gt_local, part);  // ties to keep

  // ordered pass: exclusive count of ties before each index, tile by tile
  int carry = 0;
  for (int base = 0; base < t; base += kThreads) {
    const int i = base + threadIdx.x;
    const int key = i < t ? key_at(i) : -1;
    const bool eq = key == thr;
    const unsigned ties = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) part[warp] = __popc(ties);
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals, in place
      int incl = part[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      part[lane] = incl;
    }
    __syncthreads();
    const int before = carry + (warp == 0 ? 0 : part[warp - 1]) +
                       __popc(ties & ((1u << lane) - 1u));
    if (i < t) {
      const bool keep = key > thr || (eq && before < need);
      oc[i] = keep ? uc[i] : 0.0;
    }
    carry += part[kWarps - 1];
    __syncthreads();  // part is rewritten by the next tile
  }
  if (threadIdx.x == 0) sent[c] = k;
}

}  // namespace

// Dynamic shared memory the kernel takes for a vector of length t on this
// device: t*4 bytes of keys when they fit the opt-in limit, else 0 (the keys
// are then recomputed from u on every pass).
extern "C" int topk_select_smem_bytes(int t) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long long need = 4LL * t;
  const long long static_bytes = 4LL * kWarps;
  return need + static_bytes <= optin ? static_cast<int>(need) : 0;
}

// u: (n_clients, t) FP64, out: (n_clients, t) FP64, sent: (n_clients,) int32,
// all contiguous on the current device; 1 <= k <= t.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int topk_select_f64(const void* u, void* out, void* sent,
                               int n_clients, int t, int k, void* stream) {
  const int smem = topk_select_smem_bytes(t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* up = static_cast<const double*>(u);
  double* op = static_cast<double*>(out);
  int* sp = static_cast<int*>(sent);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_select_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_select_kernel<true><<<n_clients, kThreads, smem, s>>>(up, op, sp, t, k);
  } else {
    topk_select_kernel<false><<<n_clients, kThreads, 0, s>>>(up, op, sp, t, k);
  }
  return static_cast<int>(cudaGetLastError());
}
