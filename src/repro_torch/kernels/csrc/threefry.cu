// Threefry-2x32 uniforms on the card, bit-exact with jax.random.uniform
// (jax 0.9.0, x64, the partitionable branch), sm_90a.
//
// out[c, j] = uniform(keys[c], (T,), dtype)[j]: element j of client c hashes
// its own counter (hi, lo) = (j >> 32, j & 0xffffffff) under the client's key
// with the 20-round Threefry-2x32 hash, giving words (b1, b2);
//   f32  bits = b1 ^ b2,            f = ((bits >> 9)  | 0x3F800000)         - 1
//   f64  bits = b1 << 32 | b2,      f = ((bits >> 12) | 0x3FF0000000000000) - 1
// and out = max(0, f).  RandK draws the f32 form (its selection keys), Natural
// the f64 form (its Bernoulli uniforms).
//
// Not a port of a Pallas kernel: it is what jax.random computes on the device
// in the reference (src/repro/compressors/core.py: randk's uniform, natural's
// bernoulli).  See kernels/threefry.py for the design notes.  In short: one
// thread per element, the key words and the 20 rounds in registers, the
// rotations as __funnelshift_l; what the function must do is ~70 integer
// instructions per element, spread over the two integer pipes at 64 a clock
// per SM each, and one 4- or 8-byte store, so it is bound by those
// instructions at f32 and by the stores at f64, nearly evenly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// The Threefry-2x32 hash (20 rounds) of the counter (x0, x1) under (k0, k1),
// in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
}

template <bool kF64>
__global__ void __launch_bounds__(kBlock)
threefry_uniform_kernel(const uint32_t* __restrict__ keys, void* __restrict__ out,
                        int n_clients, long long t) {
  for (long long c = blockIdx.y; c < n_clients; c += gridDim.y) {
    const uint32_t k0 = keys[2 * c];
    const uint32_t k1 = keys[2 * c + 1];
    for (long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; j < t;
         j += static_cast<long long>(gridDim.x) * kBlock) {
      uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(j) >> 32);
      uint32_t x1 = static_cast<uint32_t>(j);
      threefry2x32(k0, k1, x0, x1);
      if (kF64) {
        const unsigned long long bits =
            (static_cast<unsigned long long>(x0) << 32) | static_cast<unsigned long long>(x1);
        const double f = __dsub_rn(
            __longlong_as_double(static_cast<long long>((bits >> 12) | 0x3FF0000000000000ull)),
            1.0);
        static_cast<double*>(out)[c * t + j] = fmax(0.0, f);
      } else {
        const float f = __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
        static_cast<float*>(out)[c * t + j] = fmaxf(0.0f, f);
      }
    }
  }
}

template <bool kF64>
int launch(const void* keys, void* out, int n_clients, long long t, void* stream) {
  if (n_clients <= 0 || t <= 0) return 0;
  const long long blocks = (t + kBlock - 1) / kBlock;
  const dim3 grid(static_cast<unsigned>(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL),
                  static_cast<unsigned>(n_clients < 65535 ? n_clients : 65535));
  threefry_uniform_kernel<kF64><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), out, n_clients, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys: (n_clients, 2) uint32 threefry keys; out: (n_clients, t) float32 or
// float64; contiguous on the current device.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int threefry_uniform_f32(const void* keys, void* out, int n_clients, long long t,
                                    void* stream) {
  return launch<false>(keys, out, n_clients, t, stream);
}

extern "C" int threefry_uniform_f64(const void* keys, void* out, int n_clients, long long t,
                                    void* stream) {
  return launch<true>(keys, out, n_clients, t, stream);
}
