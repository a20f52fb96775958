// Short-range pair interaction over packed per-block source tables.
//
// Replaces the TPU kernel shenqi_tpu/ops/pallas_p2p.py (`p2p_blocked`,
// body `_make_kernel`): for each of `nb` target blocks, `blk` targets
// against that block's `S` packed source lanes (zero mass marks a
// padding lane).  Per pair:
//   1. minimum-image separation: the uint32 difference read as int32,
//      times box / 2^32;
//   2. the cubic-spline softened force factor (u < 0.5 and 0.5 <= u < 1
//      inside h, Newtonian m / r^3 beyond it), with one rsqrt;
//   3. that factor times the PM-calibrated Chebyshev window, evaluated
//      by Clenshaw, clipped to [0, 1] and zero for x = r / (cell xmax)
//      >= 1;
//   4. optionally the potential with its own spline and window.
// Outputs acc [nb, blk, 3] and pot [nb, blk], both times G.
//
// What bounds it: f32 arithmetic.  A pair costs 79 f32 operations
// without the potential and 125 with it, at the 13-coefficient window
// of the 128^3 run (ops/p2p.py p2p_flops_per_pair keeps the tally: an
// FMA counts 2).  Each block reads its S source lanes once (16 bytes
// each) for blk * S pairs, so at blk = 32 the kernel does ~160
// operations per byte of device memory, far above the H100's
// 67 TFLOP/s / 3.35 TB/s = 20.
//
// The design is the simple one: one thread per target, one block per
// target block, source tiles of kTile lanes staged in shared memory by
// all the block's threads (coalesced word loads of the [S, 3] table),
// the window coefficients in shared memory, rsqrtf and FMA, `want_pot`
// a template parameter, the separation taken as (int32_t)(s - t) on
// uint32_t, which wraps with defined behaviour.  Padding lanes (m == 0)
// are skipped; the test is uniform across the block.
//
// Left for later: (a) blk = 1 (the per-target cover fallback of the
// stencil) runs one useful thread in a 32-thread block, so 31 lanes of
// the warp idle; (b) blk = 32 gives one warp per block, which caps the
// SM at 32 resident warps; (c) no register tiling (several targets
// per thread) to reuse each shared-memory read; (d) the Clenshaw loop
// reads its coefficients from shared memory with a run-time degree.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;      // source lanes per shared-memory tile
constexpr int kMaxCoef = 64;    // Chebyshev coefficients per window
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float clenshaw(float t, const float* c, int n) {
  float b1 = 0.f, b2 = 0.f;
  const float t2 = 2.f * t;
  for (int k = n - 1; k > 0; --k) {
    const float b0 = c[k] + t2 * b1 - b2;
    b2 = b1;
    b1 = b0;
  }
  return c[0] + t * b1 - b2;
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

template <bool WANT_POT>
__global__ void __launch_bounds__(kMaxThreads)
p2p_kernel(const uint32_t* __restrict__ tgt, const uint32_t* __restrict__ src,
           const float* __restrict__ smass, const float* __restrict__ cf,
           const float* __restrict__ cp, float* __restrict__ acc,
           float* __restrict__ pot, int blk, int S, int ncf, int ncp,
           float to_f, float soft, float inv_cellxmax, float g) {
  __shared__ uint32_t spos[3][kTile];
  __shared__ float sm[kTile];
  __shared__ float scf[kMaxCoef];
  __shared__ float scp[kMaxCoef];

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const bool live = i < blk;
  for (int k = i; k < ncf; k += blockDim.x) scf[k] = cf[k];
  if (WANT_POT)
    for (int k = i; k < ncp; k += blockDim.x) scp[k] = cp[k];

  uint32_t tx = 0, ty = 0, tz = 0;
  if (live) {
    const uint32_t* t = tgt + (static_cast<size_t>(b) * blk + i) * 3;
    tx = t[0];
    ty = t[1];
    tz = t[2];
  }
  const float hinv = 1.f / soft;
  const float h3i = hinv * hinv * hinv;
  const float soft2 = soft * soft;
  float ax = 0.f, ay = 0.f, az = 0.f, ap = 0.f;

  const uint32_t* srcb = src + static_cast<size_t>(b) * S * 3;
  const float* smb = smass + static_cast<size_t>(b) * S;
  for (int base = 0; base < S; base += kTile) {
    const int n = min(kTile, S - base);
    __syncthreads();  // the previous tile has been read by every thread
    for (int w = i; w < 3 * n; w += blockDim.x) {
      const int j = w / 3;
      spos[w - 3 * j][j] = srcb[static_cast<size_t>(base) * 3 + w];
    }
    for (int j = i; j < n; j += blockDim.x) sm[j] = smb[base + j];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float m = sm[j];
      if (m == 0.f) continue;  // padding lane: contributes exactly 0
      const float dx = static_cast<float>(static_cast<int32_t>(spos[0][j] - tx)) * to_f;
      const float dy = static_cast<float>(static_cast<int32_t>(spos[1][j] - ty)) * to_f;
      const float dz = static_cast<float>(static_cast<int32_t>(spos[2][j] - tz)) * to_f;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float rinv = r2 > 0.f ? rsqrtf(r2) : 0.f;
      const float r = r2 * rinv;
      const float rinv3 = rinv * rinv * rinv;
      const float u = r * hinv;
      const bool insoft = r2 < soft2;
      float fac;
      if (insoft) {
        fac = u < 0.5f
                  ? m * h3i * (10.666666666667f + u * u * (32.f * u - 38.4f))
                  : m * h3i * (21.333333333333f - 48.f * u + 38.4f * u * u -
                               10.666666666667f * u * u * u) -
                        0.066666666667f * m * rinv3;
      } else {
        fac = m * rinv3;
      }
      const float x = r * inv_cellxmax;
      float fw = 0.f, pw = 0.f;
      if (x < 1.f) {
        const float t = fminf(fmaxf(2.f * x - 1.f, -1.f), 1.f);
        fw = clamp01(clenshaw(t, scf, ncf));
        if (WANT_POT) pw = clamp01(clenshaw(t, scp, ncp));
      }
      const float fall = fac * fw;
      ax += dx * fall;
      ay += dy * fall;
      az += dz * fall;
      if (WANT_POT) {
        float fpot;
        if (insoft) {
          const float wpi = -2.8f + u * u * (5.333333333333f + u * u * (6.4f * u - 9.6f));
          const float wpo =
              -3.2f + u * u * (10.666666666667f +
                               u * (-16.f + u * (9.6f - 2.133333333333f * u)));
          fpot = u < 0.5f ? m * hinv * wpi
                          : m * hinv * wpo + 0.066666666667f * m * rinv;
        } else {
          fpot = -m * rinv;
        }
        ap += fpot * pw;
      }
    }
  }
  if (live) {
    float* a = acc + (static_cast<size_t>(b) * blk + i) * 3;
    a[0] = ax * g;
    a[1] = ay * g;
    a[2] = az * g;
    if (WANT_POT) pot[static_cast<size_t>(b) * blk + i] = ap * g;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as an opaque pointer) of device
// `device`.  Pointers are device pointers to contiguous arrays:
// tgt [nb, blk, 3] u32, src [nb, S, 3] u32, smass [nb, S] f32,
// cf [ncf] f32, cp [ncp] f32, acc [nb, blk, 3] f32, pot [nb, blk] f32
// (unused unless want_pot).  Returns the CUDA error code of the launch
// (0 on success); the kernel itself runs asynchronously.
int shenqi_p2p_blocked(const void* tgt, const void* src, const void* smass,
                       const void* cf, int ncf, const void* cp, int ncp,
                       void* acc, void* pot, int nb, int blk, int S,
                       float to_f, float soft, float inv_cellxmax, float g,
                       int want_pot, int device, void* stream) {
  if (nb <= 0) return 0;
  if (blk < 1 || blk > kMaxThreads || S < 0 || ncf < 1 || ncf > kMaxCoef ||
      (want_pot && (ncp < 1 || ncp > kMaxCoef)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = ((blk + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const uint32_t*>(tgt);
  const auto* sp = static_cast<const uint32_t*>(src);
  const auto* m = static_cast<const float*>(smass);
  const auto* c1 = static_cast<const float*>(cf);
  const auto* c2 = static_cast<const float*>(cp);
  auto* a = static_cast<float*>(acc);
  auto* p = static_cast<float*>(pot);
  if (want_pot)
    p2p_kernel<true><<<nb, threads, 0, s>>>(t, sp, m, c1, c2, a, p, blk, S, ncf,
                                           ncp, to_f, soft, inv_cellxmax, g);
  else
    p2p_kernel<false><<<nb, threads, 0, s>>>(t, sp, m, c1, c2, a, p, blk, S, ncf,
                                            ncp, to_f, soft, inv_cellxmax, g);
  return static_cast<int>(cudaGetLastError());
}

const char* shenqi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
