// Batched selection kernels over packed upper-triangle vectors, FP64 payload, sm_90a.
//
// TopK      keys  = f32(|u|) as int32 bit patterns (the pinned selection keys)
//           thr   = the k-th largest key, by a radix select on the 31 bits
//           keep  = key > thr, plus the first k - n_gt keys equal to thr in index order
//           out   = keep ? u : +0.0,   sent = k
// TopK by keys (RandK)
//           the same with keys given as a second (n_clients, T) f32 operand
//           (non-negative, so their int32 bit patterns order as their values):
//           lax.top_k of RandK's uniforms, lowest index first on ties
// RandSeqK  keep  = (pos - s) mod T < k,   out = keep ? u : +0.0,   sent = k
// TopLEK    the TopK set, sorted by (key descending, index ascending); f64
//           prefix energies alpha_m = csum_m / sum(u*u); m* = min(1 + #{alpha <
//           k/T}, k); kept = m* - 1 if unif < p else m* (0 for an all-zero
//           row); out = u on the first `kept` of the order, +0.0 elsewhere;
//           sent = kept
// Index forms (a non-null idx (n_clients, k) int32 operand, for the wire
//           codecs): the same out and sent, and the kept indices in index
//           order in idx[c, :sent], zeros after them.  Kept entries whose
//           value is 0.0 keep their index there, which out cannot show.
//
// Replace the Pallas TPU kernels of repro/kernels/compressor_select.py:
// select_topk_pallas, select_randseqk_pallas and select_toplek_pallas, reached
// through repro/kernels/ops.py:select_topk / select_randseqk / select_toplek;
// TopK by keys is select_topk_pallas's selection run on RandK's keys
// (repro/compressors/core.py:randk's lax.top_k).
// See kernels/compressor_select.py for the design notes.  In short: TopK and
// TopLEK run one block of 1024 threads per client, share the threshold search
// (radix_threshold: four histogram passes) and the keep pass (keep_pass: one
// plain pass when every tie is kept, else one ordered tie scan in per-warp
// segments), and keep the keys in dynamic shared memory when they fit (T*4
// bytes: 181.8 KB at w8a); RandSeqK is a grid-stride masked copy that reads u
// only inside the window.

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

constexpr int kRadixBins = 256;
// at least the static shared memory of the selection kernels' part, hist and
// pick (the compiler may align them further)
constexpr int kSelectStaticSmem = 4 * (kWarps + kRadixBins + 4);

// The k-th largest key by a radix select on its 31 bits, high digits first
// (bits 30-24, 23-16, 15-8, 7-0): each pass histograms the digit of the keys
// that match the prefix found so far, and one warp finds the bin that holds
// the rank-th largest of them.  Returns the threshold; *need is the number of
// keys equal to it that are kept (k minus the keys above it) and *n_eq the
// number of keys equal to it.  hist: kRadixBins ints, pick: 3 ints, shared.
template <class KeyAt>
__device__ int radix_threshold(KeyAt key_at, int t, int k, int* hist, int* pick, int* need,
                               int* n_eq) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kRadixBins; i += kThreads) hist[i] = 0;
  __syncthreads();
  int prefix = 0;  // the digits found so far
  int rank = k;    // the threshold's rank from the top among the keys that match them
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const int hi_mask =
        pass == 0 ? 0 : static_cast<int>(0x7fffffffu & ~((1u << (shift + 8)) - 1u));
    for (int base = 0; base < t; base += kThreads) {
      const int i = base + threadIdx.x;
      const int key = i < t ? key_at(i) : -1;
      const bool hit = i < t && (key & hi_mask) == prefix;
      const int digit = (key >> shift) & 0xff;
      if (pass == 0) {
        // the exponent's high bits take few values: the lanes of a warp that
        // share a digit add to its bin once
        const unsigned peers = __match_any_sync(0xffffffffu, hit ? digit : kRadixBins + lane);
        if (hit && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
      } else if (hit) {
        atomicAdd(&hist[digit], 1);
      }
    }
    __syncthreads();
    if (warp == 0) {  // lane owns bins 8 lane .. 8 lane + 7, and clears them
      int c[8], own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[8 * lane + j];
        hist[8 * lane + j] = 0;
        own += c[j];
      }
      int from_here = own;  // keys in this lane's bins and above
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(0xffffffffu, from_here, o);
        if (lane + o < 32) from_here += y;
      }
      int above = from_here - own;
      if (above < rank && rank <= from_here) {
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          if (above + c[j] >= rank) {
            pick[0] = 8 * lane + j;
            pick[1] = above;
            pick[2] = c[j];
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();  // pick is rewritten only after the next pass's barrier
    prefix |= pick[0] << shift;
    rank -= pick[1];
  }
  *need = rank;
  *n_eq = pick[2];
  return prefix;
}

// Every index once, visit(i, valid, key, keep) called by all lanes of each
// warp together, where keep is the TopK set: every key above thr and the
// `need` lowest-index keys equal to it.  When all n_eq ties are kept (the
// common case) it is one block-strided pass, keep = key >= thr.  Otherwise
// each warp owns a contiguous segment: a pass counts its ties, one scan of
// the 32 warp counts gives each warp the rank of its first tie, and a second
// pass ranks each tie by ballot.  part: kWarps ints, shared.
template <class KeyAt, class Visit>
__device__ void keep_pass(KeyAt key_at, int t, int thr, int need, int n_eq, int* part,
                          Visit visit) {
  if (n_eq == need) {
    for (int base = 0; base < t; base += kThreads) {
      const int i = base + threadIdx.x;
      const bool valid = i < t;
      const int key = valid ? key_at(i) : -1;
      visit(i, valid, key, key >= thr);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = ((t + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int lo = warp * seg;
  const int hi = min(t, lo + seg);
  int ties = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    ties += __popc(__ballot_sync(0xffffffffu, i < hi && key_at(i) == thr));
  }
  if (lane == 0) part[warp] = ties;
  __syncthreads();
  int before = __reduce_add_sync(0xffffffffu, lane < warp ? part[lane] : 0);
  __syncthreads();  // part is reused by the caller
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool valid = i < hi;
    const int key = valid ? key_at(i) : -1;
    const unsigned eq = __ballot_sync(0xffffffffu, key == thr);
    const bool keep = key > thr || (key == thr && before + __popc(eq & lanes_below) < need);
    before += __popc(eq);
    visit(i, valid, key, keep);
  }
}

// keep_pass for the index forms: the same set, with each kept index's rank
// among the kept in index order.  visit(i, valid, keep, slot) is called by all
// lanes of each warp together; slot is meaningful where keep.  Each warp owns
// a contiguous segment: a first pass counts its keys above thr and its ties,
// one scan of the 32 warp counts gives each warp the rank of its first kept
// index (the ties kept before it are the lowest-index ones), and the second
// pass ranks each kept index by ballot.  part, part_gt: kWarps ints, shared.
template <class KeyAt, class Visit>
__device__ void keep_pass_ordered(KeyAt key_at, int t, int thr, int need, int* part,
                                  int* part_gt, Visit visit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = ((t + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int lo = warp * seg;
  const int hi = min(t, lo + seg);
  int ties = 0, gts = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int key = i < hi ? key_at(i) : -1;
    ties += __popc(__ballot_sync(0xffffffffu, key == thr));
    gts += __popc(__ballot_sync(0xffffffffu, key > thr));
  }
  if (lane == 0) {
    part[warp] = ties;
    part_gt[warp] = gts;
  }
  __syncthreads();
  // lane l: warp l's ties before it, then its kept count
  const int ties_l = part[lane];
  int ties_incl = ties_l;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, ties_incl, o);
    if (lane >= o) ties_incl += y;
  }
  const int ties_before_l = ties_incl - ties_l;
  const int kept_l = part_gt[lane] + max(0, min(ties_l, need - ties_before_l));
  int before = __reduce_add_sync(0xffffffffu, lane < warp ? ties_l : 0);
  int slot0 = __reduce_add_sync(0xffffffffu, lane < warp ? kept_l : 0);
  __syncthreads();  // part and part_gt are reused by the caller
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool valid = i < hi;
    const int key = valid ? key_at(i) : -1;
    const unsigned eq = __ballot_sync(0xffffffffu, key == thr);
    const bool keep = key > thr || (key == thr && before + __popc(eq & lanes_below) < need);
    before += __popc(eq);
    const unsigned kept = __ballot_sync(0xffffffffu, valid && keep);
    visit(i, valid, keep, slot0 + __popc(kept & lanes_below));
    slot0 += __popc(kept);
  }
}

// ---------------------------------------------------------------------------
// TopK
// ---------------------------------------------------------------------------

// kByKeys: the keys are the bit patterns of the f32 operand kf (RandK's
// uniforms), else rank_key(u).  kEmitIdx: also write the kept indices, in
// index order, to idx (n_clients, k).
template <bool kKeysInShared, bool kByKeys, bool kEmitIdx>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const double* __restrict__ u, const float* __restrict__ kf,
                   double* __restrict__ out, int* __restrict__ sent, int* __restrict__ idx,
                   int t, int k) {
  extern __shared__ int keys[];  // t entries when kKeysInShared
  __shared__ int part[kWarps];
  __shared__ int part_gt[kEmitIdx ? kWarps : 1];
  __shared__ int hist[kRadixBins];
  __shared__ int pick[3];

  const long long c = blockIdx.x;
  const double* uc = u + c * t;
  const float* kc = kByKeys ? kf + c * t : nullptr;
  double* oc = out + c * t;

  auto key_in_memory = [&](int i) -> int {
    return kByKeys ? __float_as_int(kc[i]) : rank_key(uc[i]);
  };
  if (kKeysInShared) {  // radix_threshold's first barrier covers keys[]
    for (int i = threadIdx.x; i < t; i += kThreads) keys[i] = key_in_memory(i);
  }
  auto key_at = [&](int i) -> int {
    return kKeysInShared ? keys[i] : key_in_memory(i);
  };

  int need, n_eq;
  const int thr = radix_threshold(key_at, t, k, hist, pick, &need, &n_eq);
  if (kEmitIdx) {
    int* ic = idx + c * k;
    keep_pass_ordered(key_at, t, thr, need, part, part_gt,
                      [&](int i, bool valid, bool keep, int slot) {
                        if (!valid) return;
                        oc[i] = keep ? uc[i] : 0.0;
                        if (keep) ic[slot] = i;
                      });
  } else {
    keep_pass(key_at, t, thr, need, n_eq, part, [&](int i, bool valid, int, bool keep) {
      if (valid) oc[i] = keep ? uc[i] : 0.0;  // u is read again only where kept
    });
  }
  if (threadIdx.x == 0) sent[c] = k;
}

// ---------------------------------------------------------------------------
// RandSeqK
// ---------------------------------------------------------------------------

__global__ void randseqk_select_kernel(const double* __restrict__ u,
                                       const long long* __restrict__ s,
                                       double* __restrict__ out, int* __restrict__ sent,
                                       int n_clients, int t, int k) {
  for (long long c = blockIdx.y; c < n_clients; c += gridDim.y) {
    long long s0 = s[c] % t;  // C++ keeps the dividend's sign: bring s into [0, t)
    if (s0 < 0) s0 += t;
    const double* uc = u + c * t;
    double* oc = out + c * t;
    for (int pos = blockIdx.x * blockDim.x + threadIdx.x; pos < t;
         pos += gridDim.x * blockDim.x) {
      long long rel = pos - s0;
      if (rel < 0) rel += t;
      oc[pos] = rel < k ? uc[pos] : 0.0;  // u is read only inside the window
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) sent[c] = k;
  }
}

// ---------------------------------------------------------------------------
// TopLEK
// ---------------------------------------------------------------------------

// Sum of v over the block in f64, rounded at every step; every thread gets it.
__device__ __forceinline__ double block_sum_f64(double v, double* dpart) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) dpart[warp] = v;
  __syncthreads();
  double w = dpart[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) w = __dadd_rn(w, __shfl_down_sync(0xffffffffu, w, o));
  w = __shfl_sync(0xffffffffu, w, 0);
  __syncthreads();
  return w;
}

// Inclusive f64 scan of v over the block in thread order, plus `carry`;
// `carry` grows by the block's total.  Every thread calls it.
__device__ __forceinline__ double block_inclusive_sum_f64(double v, double* dpart,
                                                          double& carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = __dadd_rn(incl, y);
  }
  if (lane == 31) dpart[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double w = dpart[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = __dadd_rn(w, y);
    }
    dpart[lane] = w;
  }
  __syncthreads();
  const double before = warp == 0 ? 0.0 : dpart[warp - 1];
  const double out = __dadd_rn(carry, __dadd_rn(before, incl));
  carry = __dadd_rn(carry, dpart[kWarps - 1]);
  __syncthreads();
  return out;
}

// Bitonic sort of p (a power of two) 64-bit values in place, ascending, by
// the whole block; ends on a barrier.
__device__ void bitonic_sort(unsigned long long* v, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int h = threadIdx.x; h < (p >> 1); h += kThreads) {
        const int lo = 2 * h - (h & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = v[lo], b = v[hi];
        if ((a > b) == ((lo & size) == 0)) {
          v[lo] = b;
          v[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ __forceinline__ int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// 64-bit sort key of a survivor: ascending order = key descending, then
// index ascending (keys are non-negative int32, so 0x7fffffff - key >= 0).
__device__ __forceinline__ unsigned long long composite(int key, int i) {
  return (static_cast<unsigned long long>(0x7fffffff - key) << 32) |
         static_cast<unsigned int>(i);
}

// Memory paths: 0 keys, composites and prefix sums in shared memory (the
// prefix sums reuse the keys' region); 1 keys recomputed from u, composites
// and prefix sums in shared memory; 2 keys recomputed from u, composites and
// prefix sums in the scratch buffer in device memory.
struct TopLekPlan {
  int path;
  int smem;                      // dynamic shared memory, bytes
  long long scratch_per_client;  // bytes of device memory per client (path 2)
  long long comp_offset;         // byte offset of the composites in their buffer
  long long csum_offset;         // byte offset of the prefix sums in their buffer
};

constexpr int kTopLekStaticSmem = kSelectStaticSmem + 8 * kWarps + 64;

TopLekPlan toplek_plan(int t, int k) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long long budget = static_cast<long long>(optin) - kTopLekStaticSmem;
  const long long p = pow2_at_least(k);
  const long long keys = (4LL * t + 15) / 16 * 16;
  const long long comps = 8 * p;
  const long long csums = 8LL * k;
  if (csums <= keys && keys + comps <= budget) {  // csum reuses the keys' region
    return {0, static_cast<int>(keys + comps), 0, keys, 0};
  }
  if (csums > keys && keys + comps + csums <= budget) {
    return {0, static_cast<int>(keys + comps + csums), 0, keys, keys + comps};
  }
  if (comps + csums <= budget) return {1, static_cast<int>(comps + csums), 0, 0, comps};
  return {2, 0, comps + csums, 0, comps};
}

// kEmitIdx: also write the kept indices, in index order, to idx (n_clients,
// k), zeros after them.
template <int kPath, bool kEmitIdx>
__global__ void __launch_bounds__(kThreads)
toplek_select_kernel(const double* __restrict__ u, const double* __restrict__ unif,
                     double* __restrict__ out, int* __restrict__ sent, int* __restrict__ idx,
                     int t, int k, unsigned char* scratch, long long scratch_per_client,
                     long long comp_offset, long long csum_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int part[kWarps];
  __shared__ int hist[kRadixBins];
  __shared__ int pick[3];
  __shared__ double dpart[kWarps];
  __shared__ int kept_shared;
  __shared__ int n_comp;

  const long long c = blockIdx.x;
  const double* uc = u + c * t;
  double* oc = out + c * t;
  const int p = pow2_at_least(k);
  int* keys = reinterpret_cast<int*>(smem);  // t entries on path 0
  unsigned char* buf = kPath == 2 ? scratch + c * scratch_per_client : smem;
  unsigned long long* comp = reinterpret_cast<unsigned long long*>(buf + comp_offset);
  double* csum = reinterpret_cast<double*>(buf + csum_offset);

  // keys (path 0) and total = sum(u*u), one read of u
  double sq_local = 0.0;
  for (int i = threadIdx.x; i < t; i += kThreads) {
    const double v = uc[i];
    if (kPath == 0) keys[i] = rank_key(v);
    sq_local = __dadd_rn(sq_local, __dmul_rn(v, v));
  }
  const double total = block_sum_f64(sq_local, dpart);  // its barriers cover keys[]
  auto key_at = [&](int i) -> int { return kPath == 0 ? keys[i] : rank_key(uc[i]); };

  // the TopK set, compacted in any order (the sort below orders it); +0.0
  // over the whole row
  if (threadIdx.x == 0) n_comp = 0;  // radix_threshold's barriers publish it
  int need, n_eq;
  const int thr = radix_threshold(key_at, t, k, hist, pick, &need, &n_eq);
  keep_pass(key_at, t, thr, need, n_eq, part, [&](int i, bool valid, int key, bool keep) {
    if (valid) oc[i] = 0.0;
    const unsigned kept = __ballot_sync(0xffffffffu, valid && keep);
    if (kept == 0) return;  // the same for every lane of the warp
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(kept) - 1;
    int slot = 0;
    if (lane == leader) slot = atomicAdd(&n_comp, __popc(kept));
    slot = __shfl_sync(0xffffffffu, slot, leader) + __popc(kept & ((1u << lane) - 1u));
    if (valid && keep) comp[slot] = composite(key, i);
  });
  for (int j = k + threadIdx.x; j < p; j += kThreads) comp[j] = ~0ull;
  __syncthreads();
  bitonic_sort(comp, p);

  // prefix energies in rank order (csum reuses the keys' region on path 0:
  // the keys are dead after the compaction, and the sort ended on a barrier)
  const double delta = static_cast<double>(k) / static_cast<double>(t);
  const double safe_total = total > 0.0 ? total : 1.0;
  double carry = 0.0;
  int below = 0;  // #{alpha < delta} over this thread's ranks
  for (int base = 0; base < k; base += kThreads) {
    const int j = base + threadIdx.x;
    const double v = j < k ? uc[static_cast<unsigned int>(comp[j])] : 0.0;
    const double cs = block_inclusive_sum_f64(__dmul_rn(v, v), dpart, carry);
    if (j < k) {
      csum[j] = cs;
      below += cs / safe_total < delta;
    }
  }
  const int n_below = block_sum(below, part);  // its barriers cover csum[]
  if (threadIdx.x == 0) {
    const int m_star = min(n_below + 1, k);
    const double alpha_hi = csum[m_star - 1] / safe_total;
    const double alpha_lo = m_star > 1 ? csum[m_star - 2] / safe_total : 0.0;
    const double gap = alpha_hi - alpha_lo;
    double prob = gap > 0.0 ? (alpha_hi - delta) / gap : 0.0;
    prob = fmin(fmax(prob, 0.0), 1.0);
    const int kept = unif[c] < prob ? m_star - 1 : m_star;
    kept_shared = total > 0.0 ? kept : 0;
    sent[c] = kept_shared;
  }
  __syncthreads();  // also orders the zeros of the ordered pass before the values
  const int kept = kept_shared;
  for (int j = threadIdx.x; j < kept; j += kThreads) {
    const unsigned int i = static_cast<unsigned int>(comp[j]);
    oc[i] = uc[i];
  }
  if (kEmitIdx) {
    // the first `kept` of the rank order, sorted again by index alone
    for (int j = threadIdx.x; j < p; j += kThreads) {
      comp[j] = j < kept ? static_cast<unsigned int>(comp[j]) : ~0ull;
    }
    __syncthreads();
    bitonic_sort(comp, p);
    int* ic = idx + c * k;
    for (int j = threadIdx.x; j < k; j += kThreads) {
      ic[j] = j < kept ? static_cast<int>(comp[j]) : 0;
    }
  }
}

template <int kPath, bool kEmitIdx>
cudaError_t launch_toplek_form(const TopLekPlan& plan, const double* u, const double* unif,
                          double* out, int* sent, int* idx, int n_clients, int t, int k,
                          unsigned char* scratch, cudaStream_t s) {
  if (plan.smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(toplek_select_kernel<kPath, kEmitIdx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return err;
  }
  toplek_select_kernel<kPath, kEmitIdx><<<n_clients, kThreads, plan.smem, s>>>(
      u, unif, out, sent, idx, t, k, scratch, plan.scratch_per_client, plan.comp_offset,
      plan.csum_offset);
  return cudaGetLastError();
}

template <int kPath>
cudaError_t launch_toplek(const TopLekPlan& plan, const double* u, const double* unif,
                          double* out, int* sent, int* idx, int n_clients, int t, int k,
                          unsigned char* scratch, cudaStream_t s) {
  return idx != nullptr
             ? launch_toplek_form<kPath, true>(plan, u, unif, out, sent, idx, n_clients, t, k,
                                          scratch, s)
             : launch_toplek_form<kPath, false>(plan, u, unif, out, sent, idx, n_clients, t, k,
                                           scratch, s);
}

}  // namespace

// Dynamic shared memory the TopK kernel (kByKeys: the TopK by keys kernel)
// takes for a vector of length t on this device: t*4 bytes of keys when they
// fit the opt-in limit beside the kernel's static shared memory (as compiled),
// else 0 (the keys are then read or recomputed from device memory on every
// pass).
template <bool kByKeys, bool kEmitIdx = false>
int topk_smem_bytes(int t) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, topk_select_kernel<true, kByKeys, kEmitIdx>) != cudaSuccess) {
    return 0;
  }
  const long long need = 4LL * t;
  return need + static_cast<long long>(attr.sharedSizeBytes) <= optin ? static_cast<int>(need)
                                                                        : 0;
}

template <bool kByKeys, bool kEmitIdx>
int launch_topk_form(const double* u, const float* kf, double* out, int* sent, int* idx,
                int n_clients, int t, int k, cudaStream_t s) {
  const int smem = topk_smem_bytes<kByKeys, kEmitIdx>(t);
  if (smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(topk_select_kernel<true, kByKeys, kEmitIdx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_select_kernel<true, kByKeys, kEmitIdx>
        <<<n_clients, kThreads, smem, s>>>(u, kf, out, sent, idx, t, k);
  } else {
    topk_select_kernel<false, kByKeys, kEmitIdx>
        <<<n_clients, kThreads, 0, s>>>(u, kf, out, sent, idx, t, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kByKeys>
int launch_topk(const double* u, const float* kf, double* out, int* sent, int* idx,
                int n_clients, int t, int k, cudaStream_t s) {
  return idx != nullptr ? launch_topk_form<kByKeys, true>(u, kf, out, sent, idx, n_clients, t, k, s)
                        : launch_topk_form<kByKeys, false>(u, kf, out, sent, idx, n_clients, t, k, s);
}

extern "C" int topk_select_smem_bytes(int t) { return topk_smem_bytes<false>(t); }

extern "C" int topk_select_by_keys_smem_bytes(int t) { return topk_smem_bytes<true>(t); }

// u: (n_clients, t) FP64, out: (n_clients, t) FP64, sent: (n_clients,) int32,
// idx: null, or (n_clients, k) int32 for the index form; all contiguous on
// the current device; 1 <= k <= t.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int topk_select_f64(const void* u, void* out, void* sent, void* idx,
                               int n_clients, int t, int k, void* stream) {
  return launch_topk<false>(static_cast<const double*>(u), nullptr, static_cast<double*>(out),
                            static_cast<int*>(sent), static_cast<int*>(idx), n_clients, t, k,
                            static_cast<cudaStream_t>(stream));
}

// As topk_select_f64, with the selection keys given: keys (n_clients, t)
// FP32, non-negative (no -0.0, no NaN), contiguous on the current device.
extern "C" int topk_select_by_keys_f64(const void* u, const void* keys, void* out, void* sent,
                                       void* idx, int n_clients, int t, int k, void* stream) {
  return launch_topk<true>(static_cast<const double*>(u), static_cast<const float*>(keys),
                           static_cast<double*>(out), static_cast<int*>(sent),
                           static_cast<int*>(idx), n_clients, t, k,
                           static_cast<cudaStream_t>(stream));
}

// u, out: (n_clients, t) FP64; s: (n_clients,) int64 window starts (any
// integer; taken mod t); sent: (n_clients,) int32; contiguous on the current
// device; 1 <= k <= t.  Returns cudaGetLastError() after the launch.
extern "C" int randseqk_select_f64(const void* u, const void* s, void* out, void* sent,
                                   int n_clients, int t, int k, void* stream) {
  constexpr int kBlock = 256;
  const dim3 grid(static_cast<unsigned>((t + kBlock - 1) / kBlock),
                  static_cast<unsigned>(n_clients < 65535 ? n_clients : 65535));
  randseqk_select_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(u), static_cast<const long long*>(s),
      static_cast<double*>(out), static_cast<int*>(sent), n_clients, t, k);
  return static_cast<int>(cudaGetLastError());
}

// Which memory path the TopLEK kernel takes for (t, k) on this device (see
// TopLekPlan), and how many bytes of device-memory scratch it needs per
// client (0 unless path 2).
// The shared memory a block may opt in to on the current device, bytes
// (what the plans above budget from).
extern "C" int select_smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

extern "C" int toplek_select_memory_path(int t, int k) { return toplek_plan(t, k).path; }

extern "C" long long toplek_select_scratch_bytes(int t, int k) {
  return toplek_plan(t, k).scratch_per_client;
}

// u, out: (n_clients, t) FP64; unif: (n_clients,) FP64 Bernoulli uniforms;
// sent: (n_clients,) int32; idx: null, or (n_clients, k) int32 for the index
// form; scratch: n_clients * toplek_select_scratch_bytes bytes of device
// memory, or null when that is 0; contiguous on the current device;
// 1 <= k <= t < 2**30.  Returns cudaGetLastError() after the launch.
extern "C" int toplek_select_f64(const void* u, const void* unif, void* out, void* sent,
                                 void* idx, int n_clients, int t, int k, void* scratch,
                                 void* stream) {
  const TopLekPlan plan = toplek_plan(t, k);
  if (plan.path == 2 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const double* up = static_cast<const double*>(u);
  const double* fp = static_cast<const double*>(unif);
  double* op = static_cast<double*>(out);
  int* sp = static_cast<int*>(sent);
  int* ip = static_cast<int*>(idx);
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (plan.path == 0) {
    err = launch_toplek<0>(plan, up, fp, op, sp, ip, n_clients, t, k, buf, s);
  } else if (plan.path == 1) {
    err = launch_toplek<1>(plan, up, fp, op, sp, ip, n_clients, t, k, buf, s);
  } else {
    err = launch_toplek<2>(plan, up, fp, op, sp, ip, n_clients, t, k, buf, s);
  }
  return static_cast<int>(err);
}
