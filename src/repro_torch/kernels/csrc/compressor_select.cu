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
// bytes: 181.8 KB at w8a); where TopLEK's keys do not fit but its k
// composites do (the FedNL probe's T = 2,098,176), its spread route reads u
// twice over a grid of blocks a client and finishes each client's
// candidates in one block's shared memory; RandSeqK is a grid-stride masked
// copy that reads u only inside the window.

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

// Bitonic sort of p (a power of two) values in place, ascending, by the
// whole block; ends on a barrier.  A stage's pairs are disjoint, so a
// thread loads up to kLook of its pairs before it compares any: their
// shared-memory latencies overlap (kSortAhead on the spread route; 1, the
// registers' worth, where a block has 32 registers a thread).
constexpr int kSortAhead = 4;

template <int kLook, class T>
__device__ void bitonic_sort(T* v, int p) {
  const int pairs = p >> 1;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int h0 = threadIdx.x; h0 < pairs; h0 += kLook * kThreads) {
        T a[kLook], b[kLook];
        int lo[kLook];
#pragma unroll
        for (int q = 0; q < kLook; ++q) {
          const int h = h0 + q * kThreads;
          lo[q] = 2 * h - (h & (stride - 1));
          if (h < pairs) a[q] = v[lo[q]], b[q] = v[lo[q] + stride];
        }
#pragma unroll
        for (int q = 0; q < kLook; ++q) {
          if (h0 + q * kThreads < pairs && (a[q] > b[q]) == ((lo[q] & size) == 0)) {
            v[lo[q]] = b[q];
            v[lo[q] + stride] = a[q];
          }
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

__device__ __forceinline__ int composite_key(unsigned long long e) {
  return 0x7fffffff - static_cast<int>(e >> 32);
}

__device__ __forceinline__ int composite_index(unsigned long long e) {
  return static_cast<int>(static_cast<unsigned int>(e));
}

// The prefix energies of the rank order in f64 (a block scan over chunks of
// kThreads ranks, rounded at every step); returns #{alpha < delta} to every
// thread.  kStore: the sums into csum[0 .. k).  Else none is stored: the
// sums do not decrease, so {alpha < delta} is a prefix of the ranks, and
// the scan writes the sums at ranks m* - 1 (the first rank outside that
// prefix, or k - 1) and m* - 2 (0.0 where m* = 1) into ends[0], ends[1] as
// it passes them (where the scan's roundings put two neighbouring sums
// within an ulp of delta * total out of order, more than one rank may
// write: kept is still m* or m* - 1, inside the stated allowance); lastw
// holds each warp's last sum of a chunk.
// index_at(j): the index of rank j.  A thread gathers its values of kLook
// chunks from u before it scans the first of them: the same scan, the
// gathers' latencies overlapped (kAhead on the spread route, 1 at 32
// registers a thread).
constexpr int kAhead = 8;

template <bool kStore, int kLook, class IndexAt>
__device__ int prefix_energies(IndexAt index_at, const double* uc, int k, double safe_total,
                               double delta, double* csum, double* lastw, double* ends,
                               double* dpart, int* part) {
  double carry = 0.0;
  double prev_last = 0.0;  // the sum at the rank before this chunk's first
  int below = 0;           // #{alpha < delta} over this thread's ranks
  for (int base0 = 0; base0 < k; base0 += kLook * kThreads) {
    double v[kLook];
#pragma unroll
    for (int a = 0; a < kLook; ++a) {
      const int j = base0 + a * kThreads + threadIdx.x;
      v[a] = j < k ? uc[index_at(j)] : 0.0;
    }
#pragma unroll
    for (int a = 0; a < kLook; ++a) {
      const int j = base0 + a * kThreads + threadIdx.x;
      if (base0 + a * kThreads >= k) break;  // the same for every thread
      const double cs = block_inclusive_sum_f64(__dmul_rn(v[a], v[a]), dpart, carry);
      if constexpr (kStore) {
        if (j < k) {
          csum[j] = cs;
          below += cs / safe_total < delta;
        }
        continue;
      }
      // the sum at rank j - 1: the lane below, the warp below's last, or
      // the chunk before's last (lastw is next written after the next
      // scan's barriers)
      const int lane = threadIdx.x & 31;
      const int warp = threadIdx.x >> 5;
      const double up = __shfl_up_sync(0xffffffffu, cs, 1);
      if (lane == 31) lastw[warp] = cs;
      __syncthreads();
      const double prev = lane > 0 ? up : (warp > 0 ? lastw[warp - 1] : prev_last);
      prev_last = lastw[kWarps - 1];
      if (j < k) {
        const bool in = cs / safe_total < delta;
        below += in;
        if (in ? j == k - 1 : (j == 0 || prev / safe_total < delta)) {
          ends[0] = cs;
          ends[1] = j > 0 ? prev : 0.0;
        }
      }
    }
  }
  return block_sum(below, part);  // its barriers cover csum[] and ends[]
}

// kept as the reference: m* = min(1 + #{alpha < delta}, k), p = (alpha_m* -
// delta) / (alpha_m* - alpha_m*-1), m* - 1 if unif < p else m*, 0 for an
// all-zero row; sum_hi, sum_lo: the prefix sums at ranks m* - 1 and m* - 2
// (0.0 where m* = 1).  One thread.
__device__ __forceinline__ int toplek_kept(double sum_hi, double sum_lo, int m_star, double total,
                                           double delta, double unif) {
  const double safe_total = total > 0.0 ? total : 1.0;
  const double alpha_hi = sum_hi / safe_total;
  const double alpha_lo = sum_lo / safe_total;
  const double gap = alpha_hi - alpha_lo;
  double prob = gap > 0.0 ? (alpha_hi - delta) / gap : 0.0;
  prob = fmin(fmax(prob, 0.0), 1.0);
  const int kept = unif < prob ? m_star - 1 : m_star;
  return total > 0.0 ? kept : 0;
}

// Memory paths: 0 keys, composites and prefix sums in shared memory (the
// prefix sums reuse the keys' region), one block a client; 2 keys
// recomputed from u, composites and prefix sums in the scratch buffer in
// device memory, one block a client; 3 the spread route below
// (toplek_tally_kernel, toplek_spread_kernel): the row over many blocks, the
// candidates in the scratch buffer, the survivors finished in one block's
// shared memory.
struct TopLekPlan {
  int path;
  int smem;                      // dynamic shared memory, bytes
  long long scratch_per_client;  // bytes of device memory per client (paths 2 and 3)
  long long comp_offset;         // byte offset of the composites in their buffer
  long long csum_offset;         // byte offset of the prefix sums in their buffer
};

constexpr int kTopLekStaticSmem = kSelectStaticSmem + 8 * kWarps + 64;

// The spread route: a key's top kTallyBits bits are its tally bin; a
// client's row is split over at most kMaxSpread blocks, each thread reading
// kUnroll entries at a time.
constexpr int kTallyBits = 12;
constexpr int kTallyBins = 1 << kTallyBits;
constexpr int kTallyShift = 31 - kTallyBits;
constexpr int kMaxSpread = 16;
constexpr int kUnroll = 4;
static_assert(kTallyBins == 4 * kThreads, "a thread owns four tally bins");
// at least toplek_spread_kernel's static shared memory (the compiler may
// align it further)
constexpr int kSpreadStaticSmem = 4 * (kWarps + kRadixBins + 16) + 8 * (2 * kWarps + 3) + 64;

// One client's scratch on the spread route: the tallies (kMaxSpread rows of
// kTallyBins int32, one a block), the blocks' f64 partial sums of u*u, the
// count of blocks done, then the candidates (at most T composites).
constexpr long long kSpreadHistBytes = 4LL * kMaxSpread * kTallyBins;
constexpr long long kSpreadHeadBytes = kSpreadHistBytes + 8 * kMaxSpread + 16;

long long spread_scratch_bytes(int t) { return (kSpreadHeadBytes + 8LL * t + 15) / 16 * 16; }

struct SpreadScratch {
  int* hist;
  double* partial;
  unsigned int* done;
  unsigned long long* cand;
};

__device__ __forceinline__ SpreadScratch spread_scratch(unsigned char* base) {
  return {reinterpret_cast<int*>(base), reinterpret_cast<double*>(base + kSpreadHistBytes),
          reinterpret_cast<unsigned int*>(base + kSpreadHistBytes + 8 * kMaxSpread),
          reinterpret_cast<unsigned long long*>(base + kSpreadHeadBytes)};
}

// Blocks a client on the spread route: the card's SMs shared among the
// clients, at most kMaxSpread, at least one.
int toplek_spread(int n_clients, int sms) {
  const int share = sms / (n_clients > 0 ? n_clients : 1);
  return share < 1 ? 1 : (share > kMaxSpread ? kMaxSpread : share);
}

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
  // spread: the composites alone (the prefix sums are not stored)
  if (comps <= static_cast<long long>(optin) - kSpreadStaticSmem) {
    return {3, static_cast<int>(comps), spread_scratch_bytes(t), 0, 0};
  }
  return {2, 0, comps + csums, 0, comps};
}

// kEmitIdx: also write the kept indices, in index order, to idx (n_clients,
// k), zeros after them.  Paths 0 and 2.  Path 0 takes at most 32 registers
// a thread, so that two blocks share an SM where their shared memory allows
// (a9a's and phishing's 142 clients then run in one wave on 132 SMs, not
// two); path 2 keeps one block an SM, its bound before the spread route.
// The sort and the scan take no look-ahead, whose registers would spill.
template <int kPath, bool kEmitIdx>
__global__ void __launch_bounds__(kThreads, kPath == 0 ? 2 : 1)
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
  bitonic_sort<1>(comp, p);

  // prefix energies in rank order (csum reuses the keys' region on path 0:
  // the keys are dead after the compaction, and the sort ended on a barrier)
  const double delta = static_cast<double>(k) / static_cast<double>(t);
  const int n_below =
      prefix_energies<true, 1>([&](int j) { return composite_index(comp[j]); }, uc, k,
                               total > 0.0 ? total : 1.0, delta, csum, nullptr, nullptr, dpart,
                               part);
  if (threadIdx.x == 0) {
    const int m_star = min(n_below + 1, k);
    kept_shared = toplek_kept(csum[m_star - 1], m_star > 1 ? csum[m_star - 2] : 0.0, m_star,
                              total, delta, unif[c]);
    sent[c] = kept_shared;
  }
  __syncthreads();  // also orders the zeros of the ordered pass before the values
  const int kept = kept_shared;
  for (int j = threadIdx.x; j < kept; j += kThreads) {
    const int i = composite_index(comp[j]);
    oc[i] = uc[i];
  }
  if (kEmitIdx) {
    // the first `kept` of the rank order, sorted again by index alone
    for (int j = threadIdx.x; j < p; j += kThreads) {
      comp[j] = j < kept ? static_cast<unsigned int>(comp[j]) : ~0ull;
    }
    __syncthreads();
    bitonic_sort<1>(comp, p);
    int* ic = idx + c * k;
    for (int j = threadIdx.x; j < k; j += kThreads) {
      ic[j] = j < kept ? static_cast<int>(comp[j]) : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// TopLEK's spread route (path 3): T too large for the keys in shared memory,
// k small enough for the composites there.  Two kernels over a grid of
// (client, block); a client's row is split into gridDim.y contiguous
// segments, the same in both.
// ---------------------------------------------------------------------------

// Pass 1: each block reads its segment of u once: the f64 sum of u*u and a
// tally of its keys' top kTallyBits bits, both into the client's scratch;
// block 0 clears the client's count of blocks done.
__global__ void __launch_bounds__(kThreads)
toplek_tally_kernel(const double* __restrict__ u, unsigned char* scratch,
                    long long scratch_per_client, int t) {
  __shared__ int hist[kTallyBins];
  __shared__ double dpart[kWarps];
  const long long c = blockIdx.x;
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const double* uc = u + c * t;
  const SpreadScratch sc = spread_scratch(scratch + c * scratch_per_client);
  for (int b = threadIdx.x; b < kTallyBins; b += kThreads) hist[b] = 0;
  if (j == 0 && threadIdx.x == 0) *sc.done = 0;
  __syncthreads();
  const int seg = (t + gridDim.y - 1) / gridDim.y;
  const int lo = j * seg;
  const int hi = min(t, lo + seg);
  double sq = 0.0;
  for (int b0 = lo; b0 < hi; b0 += kThreads * kUnroll) {
    double v[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int i = b0 + r * kThreads + threadIdx.x;
      v[r] = i < hi ? uc[i] : 0.0;
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const bool valid = b0 + r * kThreads + static_cast<int>(threadIdx.x) < hi;
      const int bin = rank_key(v[r]) >> kTallyShift;
      // a warp whose keys all share one bin (an all-zero row, mass ties)
      // adds to it once; otherwise each lane adds its own
      const int bin0 = __shfl_sync(0xffffffffu, bin, 0);
      if (__all_sync(0xffffffffu, valid && bin == bin0)) {
        if (lane == 0) atomicAdd(&hist[bin0], 32);
      } else if (valid) {
        atomicAdd(&hist[bin], 1);
      }
      if (valid) sq = __dadd_rn(sq, __dmul_rn(v[r], v[r]));
    }
  }
  const double part_sum = block_sum_f64(sq, dpart);  // its barriers cover hist[]
  if (threadIdx.x == 0) sc.partial[j] = part_sum;
  for (int b = threadIdx.x; b < kTallyBins; b += kThreads) sc.hist[j * kTallyBins + b] = hist[b];
}

// Pass 2 and the finish.  Every block sums the client's tallies: the bin of
// the k-th largest key (bin*), the candidates (the keys in bin* or above,
// which hold the TopK set) above bin* and in it, before its segment and in
// all, and the total (the blocks' partial sums added in block order).  It
// reads its segment of u again, writes +0.0 over it and its candidates as
// composites into the client's scratch: those above bin* (all kept) from
// its first slot among them on, those in bin* after all of those (in any
// order within the block).  The client's last block to finish (a count in
// device memory) then finishes alone, in shared memory: the radix
// threshold over bin*'s candidates only; where not every tie is kept, the
// need-th smallest index among the ties by a second radix select; the k
// composites sorted; the f64 prefix sums scanned in that order but not
// stored (prefix_energies<false>); kept, and the kept values over the
// zeros.
template <bool kEmitIdx>
__global__ void __launch_bounds__(kThreads)
toplek_spread_kernel(const double* __restrict__ u, const double* __restrict__ unif,
                     double* __restrict__ out, int* __restrict__ sent, int* __restrict__ idx,
                     int t, int k, unsigned char* scratch, long long scratch_per_client) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int part[kWarps];
  __shared__ int hist[kRadixBins];
  __shared__ int pick[3];
  __shared__ double dpart[kWarps];
  __shared__ double lastw[kWarps];
  __shared__ double ends[2];
  __shared__ double total_shared;
  __shared__ int bin_star;
  __shared__ int n_local_hi, n_local_eq;
  __shared__ int last;
  __shared__ int kept_shared;
  __shared__ int n_comp;

  const long long c = blockIdx.x;
  const int j = blockIdx.y;
  const int spread = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const double* uc = u + c * t;
  double* oc = out + c * t;
  const SpreadScratch sc = spread_scratch(scratch + c * scratch_per_client);

  // the client's tallies: thread i owns bins 4i .. 4i + 3
  int cnt[4] = {0, 0, 0, 0};
  for (int jj = 0; jj < spread; ++jj) {
    const int4 h = reinterpret_cast<const int4*>(sc.hist + jj * kTallyBins)[threadIdx.x];
    cnt[0] += h.x, cnt[1] += h.y, cnt[2] += h.z, cnt[3] += h.w;
  }
  const int own = cnt[0] + cnt[1] + cnt[2] + cnt[3];
  int from_here = own;  // keys in this thread's bins and those of the lanes above it
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, from_here, o);
    if (lane + o < 32) from_here += y;
  }
  if (lane == 0) part[warp] = from_here;
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int jj = 0; jj < spread; ++jj) total = __dadd_rn(total, sc.partial[jj]);
    total_shared = total;
  }
  __syncthreads();
  int above = __reduce_add_sync(0xffffffffu, lane > warp ? part[lane] : 0) + from_here - own;
  if (above < k && k <= above + own) {
#pragma unroll
    for (int r = 3; r >= 0; --r) {
      if (above + cnt[r] >= k) {
        bin_star = 4 * threadIdx.x + r;
        break;
      }
      above += cnt[r];
    }
  }
  __syncthreads();
  const int bin = bin_star;
  const double total = total_shared;
  // the candidates above bin* (all kept) and in it, in the segments before
  // this block's and in all: the ones above bin* go first in the scratch,
  // those in bin* after them
  int before_hi = 0, all_hi = 0, before_eq = 0, all_eq = 0;
  for (int jj = 0; jj < spread; ++jj) {
    const int4 h4 = reinterpret_cast<const int4*>(sc.hist + jj * kTallyBins)[threadIdx.x];
    const int h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b = 4 * static_cast<int>(threadIdx.x) + r;
      const int above_bin = b > bin ? h[r] : 0, in_bin = b == bin ? h[r] : 0;
      all_hi += above_bin;
      all_eq += in_bin;
      if (jj < j) before_hi += above_bin, before_eq += in_bin;
    }
  }
  before_hi = block_sum(before_hi, part);
  before_eq = block_sum(before_eq, part);
  const int n_hi = block_sum(all_hi, part);
  const int n_cand = n_hi + block_sum(all_eq, part);

  // pass 2: +0.0 over the segment, and its candidates (none for an all-zero
  // row, which keeps nothing)
  if (threadIdx.x == 0) n_local_hi = 0, n_local_eq = 0;
  __syncthreads();
  const bool compact = total > 0.0;
  const int seg = (t + spread - 1) / spread;
  const int lo = j * seg;
  const int hi = min(t, lo + seg);
  for (int b0 = lo; b0 < hi; b0 += kThreads * kUnroll) {
    double v[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int i = b0 + r * kThreads + threadIdx.x;
      v[r] = i < hi ? uc[i] : 0.0;
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int i = b0 + r * kThreads + threadIdx.x;
      const bool valid = i < hi;
      if (valid) oc[i] = 0.0;
      if (compact) {
        const int key = rank_key(v[r]);
        const bool is_hi = valid && (key >> kTallyShift) > bin;
        const bool is_eq = valid && (key >> kTallyShift) == bin;
        const unsigned m_hi = __ballot_sync(0xffffffffu, is_hi);
        const unsigned m_eq = __ballot_sync(0xffffffffu, is_eq);
        if (m_hi != 0) {
          const int leader = __ffs(m_hi) - 1;
          int slot = 0;
          if (lane == leader) slot = atomicAdd(&n_local_hi, __popc(m_hi));
          slot = __shfl_sync(0xffffffffu, slot, leader) + __popc(m_hi & lanes_below);
          if (is_hi) sc.cand[before_hi + slot] = composite(key, i);
        }
        if (m_eq != 0) {
          const int leader = __ffs(m_eq) - 1;
          int slot = 0;
          if (lane == leader) slot = atomicAdd(&n_local_eq, __popc(m_eq));
          slot = __shfl_sync(0xffffffffu, slot, leader) + __popc(m_eq & lanes_below);
          if (is_eq) sc.cand[n_hi + before_eq + slot] = composite(key, i);
        }
      }
    }
  }
  __threadfence();  // this block's zeros and candidates, before its count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sc.done, 1u) == static_cast<unsigned>(spread - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // ---- the finish, in the client's last block ----
  int* ic = kEmitIdx ? idx + c * k : nullptr;
  if (!compact) {
    if (threadIdx.x == 0) sent[c] = 0;
    if (kEmitIdx) {
      for (int jj = threadIdx.x; jj < k; jj += kThreads) ic[jj] = 0;
    }
    return;
  }
  const int p = pow2_at_least(k);
  unsigned long long* comp = reinterpret_cast<unsigned long long*>(smem);
  // the other blocks' candidates: read past L1
  auto cand_at = [&](int jj) -> unsigned long long { return __ldcg(sc.cand + jj); };
  // the threshold is in bin*: the (k - n_hi)-th largest of bin*'s candidates
  auto key_at = [&](int jj) -> int { return composite_key(cand_at(n_hi + jj)); };
  if (threadIdx.x == 0) n_comp = 0;  // radix_threshold's barriers publish it
  int need, n_eq;
  const int thr = radix_threshold(key_at, n_cand - n_hi, k - n_hi, hist, pick, &need, &n_eq);
  int idx_cut = 0x7fffffff;  // the ties kept: those at this index or below
  if (n_eq != need) {
    // a tie's key 0x3fffffff - index (>= 1, as T < 2**30), the rest 0: the
    // need-th largest is the need-th smallest index among the ties, which
    // are all in bin*
    auto tie_at = [&](int jj) -> int {
      const unsigned long long e = cand_at(n_hi + jj);
      return composite_key(e) == thr ? 0x3fffffff - composite_index(e) : 0;
    };
    int need_tie, n_eq_tie;
    idx_cut = 0x3fffffff - radix_threshold(tie_at, n_cand - n_hi, need, hist, pick, &need_tie,
                                           &n_eq_tie);
  }
  for (int base = 0; base < n_cand; base += kThreads) {
    const int jj = base + threadIdx.x;
    const unsigned long long e = jj < n_cand ? cand_at(jj) : ~0ull;
    const int key = composite_key(e);
    const bool keep =
        jj < n_cand && (key > thr || (key == thr && composite_index(e) <= idx_cut));
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (m == 0) continue;  // the same for every lane of the warp
    const int leader = __ffs(m) - 1;
    int slot = 0;
    if (lane == leader) slot = atomicAdd(&n_comp, __popc(m));
    slot = __shfl_sync(0xffffffffu, slot, leader) + __popc(m & lanes_below);
    if (keep) comp[slot] = e;
  }
  for (int jj = k + threadIdx.x; jj < p; jj += kThreads) comp[jj] = ~0ull;
  __syncthreads();
  bitonic_sort<kSortAhead>(comp, p);
  const double delta = static_cast<double>(k) / static_cast<double>(t);
  const int n_below =
      prefix_energies<false, kAhead>([&](int jj) { return composite_index(comp[jj]); }, uc,
                                     k, total, delta, nullptr, lastw, ends, dpart, part);
  if (threadIdx.x == 0) {
    kept_shared = toplek_kept(ends[0], ends[1], min(n_below + 1, k), total, delta, unif[c]);
    sent[c] = kept_shared;
  }
  __syncthreads();
  const int kept = kept_shared;
  for (int jj = threadIdx.x; jj < kept; jj += kThreads) {
    const int i = composite_index(comp[jj]);
    oc[i] = uc[i];
  }
  if (kEmitIdx) {
    // the first `kept` of the rank order as 4-byte indices, the rest ~0, in
    // place (a chunk's writes land on composites that it or an earlier
    // chunk has read), then sorted by index alone
    unsigned int* order = reinterpret_cast<unsigned int*>(smem);
    for (int base = 0; base < p; base += kThreads) {
      const int jj = base + threadIdx.x;
      const unsigned int i = jj < kept ? static_cast<unsigned int>(comp[jj]) : ~0u;
      __syncthreads();
      if (jj < p) order[jj] = i;
    }
    __syncthreads();
    bitonic_sort<kSortAhead>(order, p);
    for (int jj = threadIdx.x; jj < k; jj += kThreads) {
      ic[jj] = jj < kept ? static_cast<int>(order[jj]) : 0;
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

// The spread route's two launches: grid (clients, blocks a client).
template <bool kEmitIdx>
cudaError_t launch_toplek_spread(const TopLekPlan& plan, const double* u, const double* unif,
                                 double* out, int* sent, int* idx, int n_clients, int t, int k,
                                 unsigned char* scratch, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(toplek_spread_kernel<kEmitIdx>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_clients),
                  static_cast<unsigned>(toplek_spread(n_clients, sms)));
  toplek_tally_kernel<<<grid, kThreads, 0, s>>>(u, scratch, plan.scratch_per_client, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  toplek_spread_kernel<kEmitIdx><<<grid, kThreads, plan.smem, s>>>(
      u, unif, out, sent, idx, t, k, scratch, plan.scratch_per_client);
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

// The shared memory a block may opt in to on the current device, bytes
// (what the plans above budget from).
extern "C" int select_smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// Which memory path the TopLEK kernels take for (t, k) on this device (see
// TopLekPlan), and how many bytes of device-memory scratch they need per
// client (0 on path 0).
extern "C" int toplek_select_memory_path(int t, int k) { return toplek_plan(t, k).path; }

extern "C" long long toplek_select_scratch_bytes(int t, int k) {
  return toplek_plan(t, k).scratch_per_client;
}

// Blocks a client on the spread route (path 3) for n_clients on this device.
extern "C" int toplek_select_spread(int n_clients) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return toplek_spread(n_clients, sms);
}

// u, out: (n_clients, t) FP64; unif: (n_clients,) FP64 Bernoulli uniforms;
// sent: (n_clients,) int32; idx: null, or (n_clients, k) int32 for the index
// form; scratch: n_clients * toplek_select_scratch_bytes bytes of device
// memory, or null when that is 0; contiguous on the current device;
// 1 <= k <= t < 2**30.  Returns cudaGetLastError() after the launch (path 3:
// after its second launch, or the first's error).
extern "C" int toplek_select_f64(const void* u, const void* unif, void* out, void* sent,
                                 void* idx, int n_clients, int t, int k, void* scratch,
                                 void* stream) {
  const TopLekPlan plan = toplek_plan(t, k);
  if (plan.scratch_per_client > 0 && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  } else if (plan.path == 3) {
    err = ip != nullptr
              ? launch_toplek_spread<true>(plan, up, fp, op, sp, ip, n_clients, t, k, buf, s)
              : launch_toplek_spread<false>(plan, up, fp, op, sp, ip, n_clients, t, k, buf, s);
  } else {
    err = launch_toplek<2>(plan, up, fp, op, sp, ip, n_clients, t, k, buf, s);
  }
  return static_cast<int>(err);
}
