// Batched packed SYRK for the FedNL client Hessians, FP64 on the tensor cores, sm_90a.
//
//   out[c, off(r, q)] = sum_s z[c', s, r] * (hw[c, s] * z[c', s, q])  (+ lam if q == r,
//                                                                      + lam*0.0 otherwise)
//   for every client c and every q >= r, off(r, q) = r*d - r*(r-1)/2 + (q - r),
//   where c' = c mod n_z: z holds n_z clients' data, which a batched sweep
//   group of specs on one dataset shares (n_z = n_clients when it does not).
//
// Replaces the Pallas TPU kernel repro/kernels/hessian_syrk.py:hessian_syrk_pallas
// (body _syrk_kernel), which the round reaches through
// repro/kernels/ops.py:hessian_syrk_packed.
//
// What bounds it on an H100 (w8a: 142 clients, n = 348, d = 301): the exact
// triangle is 4.49 GFLOP, 67 us at the 67 TFLOP/s of the FP64 tensor cores;
// Z read once and the packed result written once are 171 MB, 51 us of HBM.
// Z (0.84 MB a client) is read again out of L2 by each block that needs its
// columns: 447 MB a call at w8a (kernels/hessian_syrk.py:syrk_l2_bytes).
//
// What the design does about each:
//   * operations: the products run on the FP64 tensor cores as DMMA,
//     mma.sync.m16n8k8 f64 (WGMMA has no FP64 shape; mma.sync.m8n8k4 runs
//     at half that rate on this card, see scripts/syrk_probe.py); A = Z^T
//     of the block's rows r, B = hw * Z of its columns q, one FP64 multiply
//     z[s, q] * hw[s] per B element as the fragment is read (the
//     reference's product, the same IEEE multiply); a warp's accumulators
//     stay in registers over the whole sample loop;
//   * shared-memory traffic: a warp owns a 32 x 32 tile, 2 x 4 DMMA tiles
//     of 16 x 8, so each fragment it reads feeds 2 or 4 DMMAs: 18 8-byte
//     reads a lane per 8 DMMAs of 16 x 8 x 8;
//   * wasted work: DMMA tiles wholly below the diagonal or past d are
//     skipped (380 a client at d = 301, 1.07x the exact triangle); a block
//     with at most 64 columns below d lays its warps out as 16 x 32 tiles
//     over those columns, so all 8 warps share its work (a block holds its
//     slot until its busiest warp is done);
//   * L2 bytes: a block is 64 rows x 128 columns, its column chunks start at
//     its own diagonal, so the diagonal block's 64 rows lie inside its 128
//     columns and one strip is loaded for both; 9 blocks a client at d = 301
//     stage 1,121 of Z's columns (the 64 x 64 pair grid: 1,806);
//   * latency: a double-buffered ring of 32-sample chunks in shared memory,
//     filled by 8-byte cp.async (one thread a column, walking the samples;
//     a row of Z is 8 d bytes, at odd d only 8-byte aligned, so neither
//     16-byte copies nor TMA take it) while the warps multiply the chunk
//     that has landed; missing samples (n not a multiple of kChunk) and
//     columns past d are zero-filled by the copy;
//   * bank conflicts: a shared row is kRowPitch = 196 doubles, 4 mod 16, so
//     a fragment read (lane -> sample lane%4, column lane/4) hits 16
//     distinct 8-byte banks in each half warp;
//   * schedule: grid (column chunk, row strip, client), the client slowest,
//     so the blocks in flight share one client's Z in L2; a chunk that
//     starts past d exits at once (6 of 15 a client at d = 301); two blocks
//     an SM (at most 128 registers, 100,864 bytes of shared memory each);
//   * epilogue: the packed triangle and the +lam are written straight from
//     the accumulators, +lam on the diagonal and +lam*0.0 off it -- the
//     plain version's `hp + lam * packed_eye`, element for element.  No
//     (d, d) matrix exists.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;        // rows r of a block tile
constexpr int kCols = 128;       // columns q of a block tile
constexpr int kWarpTile = 32;    // edge of a warp's tile: 2 x 4 DMMA tiles of 16 x 8
constexpr int kNarrowCols = 64;  // at most this many columns below d: 16 x 32 warp tiles
constexpr int kWarps = (kRows / kWarpTile) * (kCols / kWarpTile);
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;       // samples a stage holds
constexpr int kStages = 2;       // stages in the ring
constexpr int kRowPitch = kCols + kRows + 4;  // B columns, then A rows, then 4 of padding
constexpr int kStageDoubles = kChunk * kRowPitch;
constexpr int kSmemBytes = kStages * (kStageDoubles + kChunk) * 8;
static_assert(kRowPitch % 16 == 4, "fragment reads would conflict");
static_assert(kChunk % 8 == 0, "a DMMA takes 8 samples");
static_assert(kCols + kRows + 32 <= kThreads, "a loader thread per staged column, and hw's");
static_assert(kChunk <= 32, "the last warp stages hw");

// D = A B + D on the FP64 tensor cores, one 16 x 8 tile over 8 samples.
// Fragments (g = lane / 4, t = lane % 4): a = A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4]; b = B[t][g], B[t + 4][g]; c = C[g][2t],
// C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1].
__device__ __forceinline__ void dmma16x8x8(double (&c)[4], const double (&a)[4],
                                           const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// 8 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async8(double* dst, const double* src, bool valid) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// one stage of the warp's products: kChunk / 8 DMMA steps over its kI x 4
// tiles of 16 x 8, each tile only where its bit of `mask` is set (all, with
// no predicate, when kFull)
template <int kI, bool kFull>
__device__ __forceinline__ void multiply_stage(const double* __restrict__ sz,
                                               const double* __restrict__ sh, int a_col,
                                               int b_col, unsigned int mask,
                                               double (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k0 = 0; k0 < kChunk; k0 += 8) {
    const int s = k0 + (lane & 3);
    const double h_lo = sh[s], h_hi = sh[s + 4];
    const double* lo = sz + s * kRowPitch + (lane >> 2);
    const double* hi = lo + 4 * kRowPitch;
    double a[kI][4], b[4][2];
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      a[i][0] = lo[a_col + 16 * i];
      a[i][1] = lo[a_col + 16 * i + 8];
      a[i][2] = hi[a_col + 16 * i];
      a[i][3] = hi[a_col + 16 * i + 8];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j][0] = lo[b_col + 8 * j] * h_lo;
      b[j][1] = hi[b_col + 8 * j] * h_hi;
    }
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kFull || ((mask >> (4 * i + j)) & 1u)) dmma16x8x8(acc[i][j], a[i], b[j]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
syrk_packed_dmma_kernel(const double* __restrict__ z, const double* __restrict__ hw,
                        double* __restrict__ out, int n_z, int n, int d, double lam) {
  const int r0 = kRows * blockIdx.y;
  const int q0 = r0 + kCols * blockIdx.x;
  if (q0 >= d) return;  // this row strip has fewer column chunks
  // the diagonal block's rows [r0, r0 + 64) lie inside its columns
  // [q0, q0 + 128): one strip serves both operands
  const bool diagonal = q0 == r0;
  const long long c = blockIdx.z;
  const double* zc = z + static_cast<long long>(blockIdx.z % static_cast<unsigned>(n_z)) * n * d;
  const double* hc = hw + c * n;

  extern __shared__ double smem[];
  double* sz = smem;                               // kStages x kChunk x kRowPitch
  double* sh = smem + kStages * kStageDoubles;     // kStages x kChunk

  // warp tiles: 32 x 32 (2 x 4 DMMA tiles, warp (w % 2, w / 2)); a block
  // with at most kNarrowCols columns below d takes 16 x 32 (1 x 4 tiles,
  // warp (w % 4, w / 4)) over its first 64 columns, so all 8 warps share
  // the work and the block ends in half the time
  const bool narrow = d - q0 <= kNarrowCols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp_rows = narrow ? 16 : kWarpTile;
  const int wr = narrow ? warp & 3 : warp & 1;
  const int wc = narrow ? warp >> 2 : warp >> 1;
  const int row0 = r0 + warp_rows * wr;
  const int col0 = q0 + kWarpTile * wc;
  // DMMA tiles (i, j), 16 rows from row0 + 16i by 8 columns from
  // col0 + 8j, that hold an entry q >= r with q < d: with row starts on 16
  // and column starts on 8, column start >= row start and column start < d
  unsigned int mask = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rt = row0 + 16 * i, qt = col0 + 8 * j;
      if ((i == 0 || !narrow) && qt >= rt && qt < d) mask |= 1u << (4 * i + j);
    }
  const int a_col = (diagonal ? 0 : kCols) + warp_rows * wr;
  const int b_col = kWarpTile * wc;

  // loader threads: thread cc < width stages column cc of the shared row --
  // columns q0.. into [0, 128), rows r0.. into [128, 192) unless the block
  // is diagonal -- for every sample of a chunk; the last warp stages hw
  const int width = diagonal ? kCols : kCols + kRows;
  const int cc = threadIdx.x;
  const int col = cc < kCols ? q0 + cc : r0 + (cc - kCols);
  const bool col_ok = cc < width && col < d;
  const int h_sample = threadIdx.x - (kThreads - 32);
  auto load = [&](int st, int s0) {
    if (cc < width) {
      double* dst = sz + st * kStageDoubles + cc;
      const double* src = zc + (long long)s0 * d + col;
#pragma unroll 4
      for (int ss = 0; ss < kChunk; ++ss) {
        const bool valid = col_ok && s0 + ss < n;
        cp_async8(dst + ss * kRowPitch, valid ? src + (long long)ss * d : zc, valid);
      }
    } else if (h_sample >= 0 && h_sample < kChunk) {
      const int s = s0 + h_sample;
      cp_async8(sh + st * kChunk + h_sample, s < n ? hc + s : hc, s < n);
    }
  };

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  const int n_chunks = (n + kChunk - 1) / kChunk;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_chunks) load(st, st * kChunk);
    cp_async_commit();
  }
  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk `it` landed
    __syncthreads();               // everyone's; and stage (it - 1) % kStages is free
    const int next = it + kStages - 1;
    if (next < n_chunks) load(next % kStages, next * kChunk);
    cp_async_commit();
    const double* z_stage = sz + (it % kStages) * kStageDoubles;
    const double* h_stage = sh + (it % kStages) * kChunk;
    if (mask == 0xffu) {
      multiply_stage<2, true>(z_stage, h_stage, a_col, b_col, mask, acc);
    } else if (narrow && mask == 0xfu) {
      multiply_stage<1, true>(z_stage, h_stage, a_col, b_col, mask, acc);
    } else if (narrow && mask != 0) {
      multiply_stage<1, false>(z_stage, h_stage, a_col, b_col, mask, acc);
    } else if (mask != 0) {
      multiply_stage<2, false>(z_stage, h_stage, a_col, b_col, mask, acc);
    }
  }

  // accumulator (i, j) element e holds row row0 + 16i + lane/4 + 8(e/2),
  // column col0 + 8j + 2(lane%4) + e%2
  const long long t_size = (long long)d * (d + 1) / 2;
  double* oc = out + c * t_size;
  const double off_diag = lam * 0.0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = row0 + 16 * i + 8 * half + (lane >> 2);
      const long long row_off = r * d - r * (r - 1) / 2 - r;  // + q gives off(r, q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!((mask >> (4 * i + j)) & 1u)) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long q = col0 + 8 * j + 2 * (lane & 3) + e;
          if (q < d && q >= r) oc[row_off + q] = acc[i][j][2 * half + e] + (q == r ? lam : off_diag);
        }
      }
    }
}

}  // namespace

// z: (n_z, n, d) FP64, hw: (n_clients, n) FP64, out: (n_clients, T) FP64,
// all contiguous on the current device; n_clients a multiple of n_z, client
// c reads z[c mod n_z].  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int syrk_packed_f64(const void* z, const void* hw, void* out,
                               int n_clients, int n_z, int n, int d, double lam,
                               void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      syrk_packed_dmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_strips = (d + kRows - 1) / kRows;
  const int col_chunks = (d + kCols - 1) / kCols;  // those of the first row strip
  const dim3 grid(col_chunks, row_strips, n_clients);
  syrk_packed_dmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(z), static_cast<const double*>(hw),
      static_cast<double*>(out), n_z, n, d, lam);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a block of the kernel takes, in bytes.
extern "C" int syrk_packed_smem_bytes() { return kSmemBytes; }
