// Threefry-2x32 uniforms on the card, bit-exact with jax.random.uniform
// (jax 0.9.0, x64, the partitionable branch), sm_90a.
//
// out[c, j] = uniform(keys[c], (T,), dtype)[j]: element j of client c hashes
// its own counter (hi, lo) = (0, j) (T < 2**32, so the high word is 0) under
// the client's key with the 20-round Threefry-2x32 hash, giving words (b1, b2);
//   f32  bits = b1 ^ b2,            f = ((bits >> 9)  | 0x3F800000)         - 1
//   f64  bits = b1 << 32 | b2,      f = ((bits >> 12) | 0x3FF0000000000000) - 1
// and out = max(0, f).  RandK draws the f32 form (its selection keys), Natural
// the f64 form (its Bernoulli uniforms).
//
// Not a port of a Pallas kernel: it is what jax.random computes on the device
// in the reference (src/repro/compressors/core.py: randk's uniform, natural's
// bernoulli).  See kernels/threefry.py for the design notes.  In short: it is
// bound by its integer instructions (the stores at f64 take about as long),
// and those run on two pipes, the INT32 pipe (adds, logic, shifts) and the
// FMA pipe's IMAD, 64 a clock a SM each.  So:
//   - each thread hashes kCounters counters interleaved, so one counter's
//     dependent chain of adds, rotations and xors hides another's latency;
//   - a block walks a contiguous share of the rows' tiles (a tile: 256
//     threads' runs of one row), so a client's key words and injection
//     constants are computed once a thread a row, not once an element, and
//     the grid is the tiles or the SMs' resident blocks, not T / 256 a row;
//   - a thread's run is one aligned 16-byte vector of the output, so a warp
//     stores 512 contiguous bytes in one instruction; the elements before a
//     row's first aligned run and after its last (at most 3 at f32, 1 at
//     f64) are a scalar tail loop, from the last block back;
//   - kSteer puts the adds of the hash (the rounds', the key injections')
//     and the float's words on the FMA pipe as IMAD (x * one + y, one a
//     run-time 1, so that neither nvcc nor ptxas turns it back into an
//     IADD3); the 20 rotations stay funnel shifts on the INT32 pipe beside
//     the 21 xors: IMAD.WIDE and IMAD.HI issue at half rate on an H100, so
//     a rotation moved to the FMA pipe (kFmaRotations) costs two of its
//     slots to save one INT32 slot, and every mix measured was slower;
//   - jax's max(0, f) is not taken: f = 1.m - 1 is exact and >= +0, so it
//     is the identity, and the bits are jax's;
//   - a draw of at most kSmallPerThread elements a resident thread (one
//     client of w8a, phishing's round) takes the small route: one element a
//     thread, a row of blocks a client, no division, so it keeps its warps.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>
#include <utility>

namespace {

constexpr int kBlock = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

// The design's choices, one a line (scripts/threefry_probe.py builds variants
// of this file by replacing these lines):
constexpr int kCounters = 4;                   // counters a thread, main route: 1, 2 or 4
constexpr int kSmallPerThread = 2;             // small route up to this many elements a thread
constexpr bool kVectorStores = true;           // a thread's run one aligned vector store
constexpr bool kSteer = true;                  // the hash's adds and the words as IMAD
constexpr uint32_t kFmaRotations = 0x00000u;   // bit i: round i's rotation on the FMA pipe

static_assert(kCounters == 1 || kCounters == 2 || kCounters == 4, "1, 2 or 4 counters");

// Threefry-2x32's rotation in round i (0..19): 13 15 26 6, 17 29 16 24, ...
__host__ __device__ constexpr int rotation(int i) {
  switch ((i / 4 % 2) * 4 + i % 4) {
    case 0: return 13;
    case 1: return 15;
    case 2: return 26;
    case 3: return 6;
    case 4: return 17;
    case 5: return 29;
    case 6: return 16;
    default: return 24;
  }
}

// Multipliers passed at run time: a multiply by 1 or 2^r that the compiler
// can see is turned back into an add or a shift on the INT32 pipe.
struct Mults {
  uint32_t one;
  uint32_t rot[8];     // 2^rotation(i) for i = 0..7
  uint32_t f32_shift;  // 2^23: hi(s * 2^23) = s >> 9
  uint32_t f64_shift;  // 2^20: x * 2^20 = (x >> 12 : x << 20)
};

// One client's constants: its key words and what each of the 5 key
// injections adds to x1 (ks[(g + 2) % 3] + g + 1; to x0 it adds ks[(g + 1) % 3]).
struct Key {
  uint32_t k0, k1, k2;
  uint32_t inj[5];
};

__device__ __forceinline__ Key client_key(const uint32_t* __restrict__ keys, long long c) {
  Key k;
  k.k0 = __ldg(keys + 2 * c);
  k.k1 = __ldg(keys + 2 * c + 1);
  k.k2 = k.k0 ^ k.k1 ^ kParity;
  k.inj[0] = k.k2 + 1u;
  k.inj[1] = k.k0 + 2u;
  k.inj[2] = k.k1 + 3u;
  k.inj[3] = k.k2 + 4u;
  k.inj[4] = k.k0 + 5u;
  return k;
}

// x0's injection after round group g (0..4): k1, k2, k0, k1, k2
template <int kG>
__device__ __forceinline__ uint32_t inj0(const Key& k) {
  return kG % 3 == 0 ? k.k1 : kG % 3 == 1 ? k.k2 : k.k0;
}

// a + b, on the FMA pipe when steered (IMAD a * one + b)
__device__ __forceinline__ uint32_t add32(uint32_t a, uint32_t b, uint32_t one) {
  if constexpr (kSteer) {
    uint32_t d;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
    return d;
  } else {
    return a + b;
  }
}

// rotl(x, kR) ^ y: a funnel shift and a LOP3 on the INT32 pipe, or one
// IMAD.WIDE x * 2^kR (lo = x << kR, hi = x >> (32 - kR)) on the FMA pipe and
// one LOP3 (lo | hi) ^ y
template <int kR, bool kFma>
__device__ __forceinline__ uint32_t rotl_xor(uint32_t x, uint32_t y, uint32_t pow2) {
  if constexpr (kFma) {
    uint32_t lo, hi;
    asm("{\n\t.reg .u64 w;\n\tmul.wide.u32 w, %2, %3;\n\tmov.b64 {%0, %1}, w;\n\t}"
        : "=r"(lo), "=r"(hi)
        : "r"(x), "r"(pow2));
    return (lo | hi) ^ y;
  } else {
    return __funnelshift_l(x, x, kR) ^ y;
  }
}

// Round kI of kC interleaved hashes, with the key injection before it.
// x0 starts as the counter's high word plus k0 = k0, so round 0's add is
// x1 + k0.  Steered, the injection into x0 is an IMAD of its own (two FMA
// slots for the one INT32 slot of an IADD3 joining it to the round's add: the
// INT32 pipe is the busier).
template <int kI, int kC>
__device__ __forceinline__ void tf_round(uint32_t (&x0)[kC], uint32_t (&x1)[kC], const Key& k,
                                         const Mults& mu) {
  constexpr int kG = kI / 4;
  constexpr int kRot = (kG % 2) * 4 + kI % 4;
  constexpr bool kFma = kSteer && ((kFmaRotations >> kI) & 1u);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if constexpr (kI == 0) {
      x0[c] = add32(x1[c], k.k0, mu.one);
    } else if constexpr (kI % 4 == 0) {
      x1[c] = add32(x1[c], k.inj[kG - 1], mu.one);
      if constexpr (kSteer) {
        x0[c] = add32(add32(x0[c], inj0<kG - 1>(k), mu.one), x1[c], mu.one);
      } else {
        x0[c] = x0[c] + inj0<kG - 1>(k) + x1[c];
      }
    } else {
      x0[c] = add32(x0[c], x1[c], mu.one);
    }
    x1[c] = rotl_xor<rotation(kI), kFma>(x1[c], x0[c], mu.rot[kRot]);
  }
}

template <int kC, int... kIs>
__device__ __forceinline__ void tf_rounds(uint32_t (&x0)[kC], uint32_t (&x1)[kC], const Key& k,
                                          const Mults& mu, std::integer_sequence<int, kIs...>) {
  (tf_round<kIs>(x0, x1, k, mu), ...);
}

// The Threefry-2x32 hash (20 rounds) of kC counters (0, j) given as
// x1 = j + k1; leaves the two words of each in (x0, x1).
template <int kC>
__device__ __forceinline__ void threefry2x32(uint32_t (&x0)[kC], uint32_t (&x1)[kC], const Key& k,
                                             const Mults& mu) {
  tf_rounds(x0, x1, k, mu, std::make_integer_sequence<int, 20>{});
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    x0[c] = add32(x0[c], k.k2, mu.one);
    x1[c] = add32(x1[c], k.inj[4], mu.one);
  }
}

// The float from the words, as jax builds it: the top mantissa bits OR the
// exponent of 1.0, minus 1.0, rounded to nearest, no contraction.  jax then
// takes max(0, f), which is the identity here (1.m - 1 is exact and >= +0, never
// -0 or NaN), so it is left out: the same bits, and at f64 a compare and two
// selects fewer on the INT32 pipe.
// Steered, the shift and the OR are one IMAD.HI (hi(s * 2^23) + 0x3F800000,
// the bits disjoint); at f64 one IMAD.WIDE makes the high word and one
// IMAD.HI the low.
__device__ __forceinline__ float uniform_f32(uint32_t x0, uint32_t x1, const Mults& mu) {
  const uint32_t s = x0 ^ x1;
  uint32_t bits;
  if constexpr (kSteer) {
    asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(bits) : "r"(s), "r"(mu.f32_shift), "r"(0x3F800000u));
  } else {
    bits = (s >> 9) | 0x3F800000u;
  }
  return __fsub_rn(__uint_as_float(bits), 1.0f);
}

__device__ __forceinline__ double uniform_f64(uint32_t x0, uint32_t x1, const Mults& mu) {
  uint32_t hi, lo;
  if constexpr (kSteer) {
    uint32_t x0_lo;  // x0 << 20
    asm("{\n\t.reg .u64 w;\n\tmad.wide.u32 w, %2, %3, %4;\n\tmov.b64 {%0, %1}, w;\n\t}"
        : "=r"(x0_lo), "=r"(hi)
        : "r"(x0), "r"(mu.f64_shift), "l"(0x3FF0000000000000ull));
    asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(lo) : "r"(x1), "r"(mu.f64_shift), "r"(x0_lo));
  } else {
    hi = (x0 >> 12) | 0x3FF00000u;
    lo = (x0 << 20) | (x1 >> 12);
  }
  return __dsub_rn(__hiloint2double(static_cast<int>(hi), static_cast<int>(lo)), 1.0);
}

template <bool kF64>
__device__ __forceinline__ std::conditional_t<kF64, double, float> uniform(uint32_t x0,
                                                                           uint32_t x1,
                                                                           const Mults& mu) {
  if constexpr (kF64) {
    return uniform_f64(x0, x1, mu);
  } else {
    return uniform_f32(x0, x1, mu);
  }
}

// A thread's run: kV elements stored as one vector (16 bytes at most: four
// floats or two doubles), kC / kV runs a thread a tile, kBlock apart.
constexpr int vector_width(bool f64, int counters) {
  return !kVectorStores ? 1 : f64 ? (counters < 2 ? counters : 2) : (counters < 4 ? counters : 4);
}

template <bool kF64, int kC>
struct Route {
  static constexpr int kV = vector_width(kF64, kC);
  static constexpr int kRuns = kC / kV;
  static constexpr uint32_t kTileRuns = kBlock * kRuns;  // a tile: kTileRuns runs of one row
  static constexpr int kEdgeSlots = 2 * (kV - 1);       // a row's elements outside its runs
  static long long tiles_per_row(uint32_t t) { return (t / kV + kTileRuns - 1) / kTileRuns; }
};

// The first j of row c whose element is aligned to kV in the output.
template <int kV>
__device__ __forceinline__ uint32_t first_aligned(long long c, uint32_t t) {
  return (0u - static_cast<uint32_t>(c) * t) & (kV - 1);
}

template <bool kF64, int kC>
__global__ void __launch_bounds__(kBlock)
threefry_uniform_kernel(const uint32_t* __restrict__ keys, void* __restrict__ out, int n_clients,
                        uint32_t t, uint32_t tiles_per_row, long long share, int extra,
                        const Mults mu) {
  using Elem = std::conditional_t<kF64, double, float>;
  using R = Route<kF64, kC>;
  constexpr int kV = R::kV;
  Elem* const base = static_cast<Elem*>(out);

  // The main loop: this block's contiguous share of the tiles (the first
  // `extra` blocks one more), row by row.  Run m of a row holds its
  // elements j = a + kV * m + v.
  const int b = blockIdx.x;
  long long tile = b * share + (b < extra ? b : extra);
  const long long end = tile + share + (b < extra ? 1 : 0);
  while (tile < end) {
    const long long c = tile < (1LL << 32) ? static_cast<uint32_t>(tile) / tiles_per_row
                                           : tile / tiles_per_row;
    const long long row_tiles_end = (c + 1) * tiles_per_row;
    const long long q0 = tile - c * tiles_per_row;
    const long long q1 = (end < row_tiles_end ? end : row_tiles_end) - c * tiles_per_row;
    tile = c * tiles_per_row + q1;
    const Key k = client_key(keys, c);
    const uint32_t a = first_aligned<kV>(c, t);
    const uint32_t n_runs = t >= a ? (t - a) / kV : 0;  // whole aligned runs of the row
    const long long m0 = q0 * R::kTileRuns + threadIdx.x;
    const long long lim = q1 * R::kTileRuns < n_runs ? q1 * R::kTileRuns : n_runs;
    int trips = m0 < lim ? static_cast<int>((lim - m0 + R::kTileRuns - 1) / R::kTileRuns) : 0;
    uint32_t left = n_runs - static_cast<uint32_t>(m0);  // runs from this thread's first on
    uint32_t x1_base = kV * static_cast<uint32_t>(m0) + a + k.k1;
    Elem* p = base + c * static_cast<long long>(t) + a + kV * m0;
#pragma unroll 1
    for (; trips > 0; --trips) {
      uint32_t x0[kC], x1[kC];
#pragma unroll
      for (int r = 0; r < R::kRuns; ++r) {
#pragma unroll
        for (int v = 0; v < kV; ++v) x1[r * kV + v] = x1_base + (r * kBlock * kV + v);
      }
      threefry2x32<kC>(x0, x1, k, mu);
#pragma unroll
      for (int r = 0; r < R::kRuns; ++r) {
        if (r > 0 && static_cast<uint32_t>(r * kBlock) >= left) break;
        Elem* const q = p + r * kBlock * kV;
        const int i = r * kV;
        if constexpr (kV == 4) {
          *reinterpret_cast<float4*>(q) =
              make_float4(uniform<false>(x0[i], x1[i], mu), uniform<false>(x0[i + 1], x1[i + 1], mu),
                          uniform<false>(x0[i + 2], x1[i + 2], mu),
                          uniform<false>(x0[i + 3], x1[i + 3], mu));
        } else if constexpr (kV == 2 && kF64) {
          *reinterpret_cast<double2*>(q) =
              make_double2(uniform<true>(x0[i], x1[i], mu), uniform<true>(x0[i + 1], x1[i + 1], mu));
        } else if constexpr (kV == 2) {
          *reinterpret_cast<float2*>(q) =
              make_float2(uniform<false>(x0[i], x1[i], mu), uniform<false>(x0[i + 1], x1[i + 1], mu));
        } else {
          *q = uniform<kF64>(x0[i], x1[i], mu);
        }
      }
      x1_base += kV * R::kTileRuns;
      p += kV * R::kTileRuns;
      left -= R::kTileRuns;
    }
  }

  // The tail loop: each row's elements before its first run (j < a) and
  // after its last (the rest of T - a after whole runs), one a thread, from
  // the last block back: the blocks with one tile fewer, or (on a launch
  // with room) blocks of their own.
  if constexpr (kV > 1) {
    const long long n_slots = static_cast<long long>(n_clients) * R::kEdgeSlots;
    const long long from_last = static_cast<long long>(gridDim.x - 1 - b) * kBlock + threadIdx.x;
#pragma unroll 1
    for (long long e = from_last; e < n_slots; e += static_cast<long long>(gridDim.x) * kBlock) {
      const long long c = e / R::kEdgeSlots;
      const int s = static_cast<int>(e - c * R::kEdgeSlots);
      const uint32_t a = first_aligned<kV>(c, t);
      const long long n_runs = t >= a ? (t - a) / kV : 0;
      const long long j = s < kV - 1 ? s : a + kV * n_runs + (s - (kV - 1));
      if (j >= (s < kV - 1 ? (a < t ? a : t) : t)) continue;
      const Key k = client_key(keys, c);
      uint32_t x0[1], x1[1] = {static_cast<uint32_t>(j) + k.k1};
      threefry2x32<1>(x0, x1, k, mu);
      base[c * static_cast<long long>(t) + j] = uniform<kF64>(x0[0], x1[0], mu);
    }
  }
}

// The small route, for draws of at most kSmallPerThread elements a resident
// thread (one client of w8a, phishing's round): one element a thread, a row
// of blocks a client (the client its blockIdx.y, no division), as many
// blocks as 256-element runs of the rows for the hardware to spread over
// every SM; the key words once a block.
template <bool kF64>
__global__ void __launch_bounds__(kBlock)
threefry_uniform_small_kernel(const uint32_t* __restrict__ keys, void* __restrict__ out,
                              int n_clients, uint32_t t, const Mults mu) {
  using Elem = std::conditional_t<kF64, double, float>;
  for (long long c = blockIdx.y; c < n_clients; c += gridDim.y) {
    const Key k = client_key(keys, c);
    Elem* const row = static_cast<Elem*>(out) + c * static_cast<long long>(t);
#pragma unroll 1
    for (long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; j < t;
         j += static_cast<long long>(gridDim.x) * kBlock) {
      uint32_t x0[1], x1[1] = {static_cast<uint32_t>(j) + k.k1};
      threefry2x32<1>(x0, x1, k, mu);
      row[j] = uniform<kF64>(x0[0], x1[0], mu);
    }
  }
}

Mults run_time_multipliers() {
  Mults m{};
  m.one = 1u;
  for (int i = 0; i < 8; ++i) m.rot[i] = 1u << rotation(i);
  m.f32_shift = 1u << 23;
  m.f64_shift = 1u << 20;
  return m;
}

// SMs of the current device, read once a device
int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev >= 0 && dev < 64 && cached[dev].load() > 0) return cached[dev].load();
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) {
    return 1;
  }
  if (dev >= 0 && dev < 64) cached[dev].store(n);
  return n;
}

template <typename Kernel>
int resident_blocks_per_sm(Kernel kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBlock, 0);
  return n > 0 ? n : 1;
}

template <bool kF64>
int main_blocks_per_sm() {
  static const int n = resident_blocks_per_sm(threefry_uniform_kernel<kF64, kCounters>);
  return n;
}

template <bool kF64>
int small_blocks_per_sm() {
  static const int n = resident_blocks_per_sm(threefry_uniform_small_kernel<kF64>);
  return n;
}

// How a launch is cut: [counters a thread, elements a run, tiles a row,
// tiles, tail slots, blocks, resident blocks a SM, small route]; on the
// small route a tile is one block's 256 elements of a row.
struct Plan {
  long long counters, run, tiles_per_row, tiles, slots, blocks, per_sm, small;
};

template <bool kF64>
Plan plan(int n_clients, uint32_t t, int sms) {
  const long long elems = static_cast<long long>(n_clients) * t;
  const int small_per_sm = small_blocks_per_sm<kF64>();
  if (elems <= static_cast<long long>(kSmallPerThread) * sms * small_per_sm * kBlock) {
    const long long x = (t + kBlock - 1) / kBlock;
    const long long gx = x < 0x7fffffffLL ? x : 0x7fffffffLL;
    const long long gy = n_clients < 65535 ? n_clients : 65535;
    return Plan{1, 1, x, n_clients * x, 0, gx * gy, small_per_sm, 1};
  }
  using R = Route<kF64, kCounters>;
  const int per_sm = main_blocks_per_sm<kF64>();
  Plan p{kCounters, R::kV, R::tiles_per_row(t), 0,
         static_cast<long long>(n_clients) * R::kEdgeSlots, 0, per_sm, 0};
  p.tiles = n_clients * p.tiles_per_row;
  const long long resident = static_cast<long long>(sms) * per_sm;
  p.blocks = p.tiles + (p.slots + kBlock - 1) / kBlock;
  p.blocks = p.blocks < resident ? p.blocks : resident;
  p.blocks = p.blocks > 1 ? p.blocks : 1;
  return p;
}

template <bool kF64>
int launch(const void* keys, void* out, int n_clients, long long t, void* stream) {
  if (n_clients <= 0 || t <= 0) return 0;
  if (t >= (1LL << 32)) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t tt = static_cast<uint32_t>(t);
  const Plan p = plan<kF64>(n_clients, tt, sm_count());
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.small) {
    const dim3 grid(static_cast<unsigned>(p.blocks / (n_clients < 65535 ? n_clients : 65535)),
                    static_cast<unsigned>(n_clients < 65535 ? n_clients : 65535));
    threefry_uniform_small_kernel<kF64><<<grid, kBlock, 0, s>>>(k, out, n_clients, tt,
                                                                run_time_multipliers());
  } else {
    threefry_uniform_kernel<kF64, kCounters><<<static_cast<unsigned>(p.blocks), kBlock, 0, s>>>(
        k, out, n_clients, tt, static_cast<uint32_t>(p.tiles_per_row), p.tiles / p.blocks,
        static_cast<int>(p.tiles % p.blocks), run_time_multipliers());
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: (n_clients, 2) uint32 threefry keys; out: (n_clients, t) float32 or
// float64, 16-byte aligned; contiguous on the current device; t < 2**32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int threefry_uniform_f32(const void* keys, void* out, int n_clients, long long t,
                                    void* stream) {
  return launch<false>(keys, out, n_clients, t, stream);
}

extern "C" int threefry_uniform_f64(const void* keys, void* out, int n_clients, long long t,
                                    void* stream) {
  return launch<true>(keys, out, n_clients, t, stream);
}

// The cut a launch of (n_clients, t) takes on the current device, into
// out[8] (Plan's fields in order).  Returns 0, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int threefry_uniform_plan(int f64, int n_clients, long long t, long long* out) {
  if (n_clients <= 0 || t <= 0 || t >= (1LL << 32)) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  const Plan p = f64 ? plan<true>(n_clients, static_cast<uint32_t>(t), sms)
                     : plan<false>(n_clients, static_cast<uint32_t>(t), sms);
  const long long fields[8] = {p.counters, p.run, p.tiles_per_row, p.tiles, p.slots, p.blocks,
                               p.per_sm, p.small};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return 0;
}
