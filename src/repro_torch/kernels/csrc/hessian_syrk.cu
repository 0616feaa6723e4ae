// Batched packed SYRK for the FedNL client Hessians, FP64, sm_90a.
//
//   out[c, off(r, q)] = sum_s z[c, s, r] * (hw[c, s] * z[c, s, q])  (+ lam if q == r)
//   for every client c and every q >= r, off(r, q) = r*d - r*(r-1)/2 + (q - r).
//
// Replaces the Pallas TPU kernel repro/kernels/hessian_syrk.py:hessian_syrk_pallas
// (body _syrk_kernel), which the round reaches through
// repro/kernels/ops.py:hessian_syrk_packed.  See kernels/hessian_syrk.py for the
// design note; in short:
//   * one launch for all clients: blockIdx.x walks the upper tile pairs
//     (ti <= tj) of one client, blockIdx.y is the client, so the blocks that
//     run together read the same client's Z (0.84 MB at w8a) out of L2;
//   * the TPU grid's sequential sample axis is the loop over KC-sample chunks
//     inside the block; the chunk of column strips ti and tj is staged in
//     shared memory, with hw folded into the tj strip as it loads;
//   * each of the 256 threads keeps a 4x4 block of the 64x64 tile in FP64
//     registers (plain FMA; WGMMA has no FP64 shape);
//   * the ragged edge (d = 301) is masked at load and at store;
//   * the epilogue writes the packed upper triangle directly, +lam on the
//     diagonal and +lam*0.0 off it -- the plain version's
//     `hp + lam * packed_eye`, element for element.  No (d, d) matrix exists.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;            // output tile edge
constexpr int kChunk = 32;           // samples staged per step
constexpr int kSide = 16;            // threads per tile side (16 x 16 = 256)
constexpr int kMicro = kTile / kSide;  // outputs per thread per side
constexpr int kThreads = kSide * kSide;

__global__ void __launch_bounds__(kThreads)
syrk_packed_kernel(const double* __restrict__ z, const double* __restrict__ hw,
                   double* __restrict__ out, int n, int d, int n_tiles,
                   double lam) {
  __shared__ double sa[kChunk][kTile];
  __shared__ double sb[kChunk][kTile];

  // pair index -> (ti, tj) with ti <= tj, row-major over the upper tiles
  int p = blockIdx.x;
  int ti = 0;
  while (p >= n_tiles - ti) {
    p -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int r0 = ti * kTile;
  const int q0 = tj * kTile;
  const long long c = blockIdx.y;
  const double* zc = z + c * n * d;
  const double* hc = hw + c * n;
  const long long t_size = (long long)d * (d + 1) / 2;
  double* oc = out + c * t_size;

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;

  double acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0;

  for (int s0 = 0; s0 < n; s0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int ss = e / kTile;
      const int cc = e % kTile;
      const int s = s0 + ss;
      double a = 0.0, b = 0.0;
      if (s < n) {
        const double* row = zc + (long long)s * d;
        if (r0 + cc < d) a = row[r0 + cc];
        if (q0 + cc < d) b = row[q0 + cc] * hc[s];
      }
      sa[ss][cc] = a;
      sb[ss][cc] = b;
    }
    __syncthreads();
#pragma unroll 4
    for (int ss = 0; ss < kChunk; ++ss) {
      double av[kMicro], bv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) av[i] = sa[ss][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) bv[j] = sb[ss][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const double off_diag = lam * 0.0;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const long long r = r0 + ty + kSide * i;
    if (r >= d) continue;
    const long long row_off = r * d - r * (r - 1) / 2 - r;  // + q gives off(r, q)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const long long q = q0 + tx + kSide * j;
      if (q >= d || q < r) continue;
      oc[row_off + q] = acc[i][j] + (q == r ? lam : off_diag);
    }
  }
}

}  // namespace

// z: (n_clients, n, d) FP64, hw: (n_clients, n) FP64, out: (n_clients, T) FP64,
// all contiguous on the current device.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int syrk_packed_f64(const void* z, const void* hw, void* out,
                               int n_clients, int n, int d, double lam,
                               void* stream) {
  const int n_tiles = (d + kTile - 1) / kTile;
  const dim3 grid(n_tiles * (n_tiles + 1) / 2, n_clients);
  syrk_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(z), static_cast<const double*>(hw),
      static_cast<double*>(out), n, d, n_tiles, lam);
  return static_cast<int>(cudaGetLastError());
}
