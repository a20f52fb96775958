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
//   3. that factor times the short-range window, zero for x = r /
//      (cell xmax) >= 1: the PM-calibrated Chebyshev fit, evaluated by
//      Clenshaw and clipped to [0, 1], or the analytic erfc form of
//      ShortRangeForceWindowType erfc (shenqi_tpu/gravity/shortrange.py
//      `short_range_window` with no tables, which the JAX package
//      evaluates in its XLA pair pass, not in the TPU kernel):
//      u = r / cell * 0.5 / asmth, erfc(u) + 2u / sqrt(pi) exp(-u^2) for
//      the force and erfc(u) for the potential, unclipped;
//   4. optionally the potential with its own spline and window.
// Outputs acc [nb, blk, 3] and pot [nb, blk], both times G.
//
// What bounds it on an H100: instruction issue.  A pair inside the
// window costs 79 f32 operations without the potential and 125 with it
// at the 13-coefficient window of the 128^3 run (ops/p2p.py
// p2p_flops_per_pair; an FMA counts 2): 60 instructions if each FMA
// issues once, against 128 issued per clock per SM (chip_smoke.py's
// issue floor).  The 3 int->float converts and the rsqrt go to a pipe
// of 16 lanes per SM, busy about half as long as issue.  A block reads
// its S source lanes once (16 bytes each) for blk * S pairs, so at
// blk = 32 the kernel does ~160 operations per byte, far above the
// card's 20; at blk = 1 it does ~5 and the bytes bound it.
//
// The design, for each of those limits:
//  - Warps.  Every block has 512 threads and serves one target block.
//    With bp = blk rounded up to a power of two, a warp holds min(bp,
//    32) targets and 32 / bp source partitions (bp < 32), and the
//    block's 16 warps split the source chunks between 512 / bp (bp >=
//    32) or 16 warp partitions.  At blk 32 each of the 16 warps takes
//    every 16th chunk of the same 32 targets; at blk 1 the 512 threads
//    all stride over the one target's sources; at blk 256 two warps
//    share each set of 32 targets.  nb = 1024 blocks of 16 warps fill
//    the card.
//  - Independent work.  Each warp's chunks are its own, so no barrier
//    stalls the pair loop, and the loop is unrolled 4 sources deep.
//    The window coefficients live in registers (ptxas puts them in
//    uniform registers): the degree is a template parameter for the
//    13-coefficient fit of the default smoothing (kTplCoef), with a
//    run-time-degree instantiation (coefficients in shared memory) for
//    any other, which takes 1.6x as long at the main-path tier
//    (chip_smoke.py's kernel phase times both).  The Clenshaw step is
//    fma(2t, b1, c[k] - b2), one dependent FMA per term.  rsqrt is the
//    one-instruction ftz form.  The erfc window is a third window
//    parameter (kErfc): CUDA's erfcf and expf per pair in place of the
//    Clenshaw sums, one erfcf shared by the force and the potential, so
//    the Chebyshev instantiations compile as before.  Its operation
//    count per pair is ops/p2p.py p2p_erfc_flops_per_pair (erfcf's and
//    expf's instructions counted in their SASS by
//    tools/torch_erfc_sass.py).
//  - Loads overlap compute.  Each warp stages its chunks of 32 source
//    lanes (positions and mass interleaved as one 16-byte entry) into
//    a kStages-deep ring of its own shared buffers with cp.async, so
//    the next chunks load while the current one is evaluated; a lane
//    reads an entry with one 16-byte shared load (a broadcast when the
//    warp's lanes are 32 targets).
//  - Padding.  A chunk whose 32 masses are all zero adds exactly 0; a
//    warp vote skips it.  Inside a live chunk a pair with zero mass or
//    x >= 1 adds exactly 0 as well, and its sums are left as they are.
//    (A warp's 32 targets are neighbours, and 68-86% of the live pairs
//    of the main path's launch shapes lie inside the window, as
//    chip_smoke.py's kernel phase prints, so a warp vote to skip the
//    spline and window per source would seldom skip.)
//  - Deterministic.  No atomics: partial sums meet by a butterfly of
//    warp shuffles and then in shared memory in a fixed order, so the
//    same inputs give the same bits on every launch.
//
// ptxas (nvcc 12.9, sm_90a; chip_smoke.py's build phase prints it):
// degree 12 compiled in, 40 registers without the potential and 64 with
// it (12 B of spill stores, 20 B of loads); run-time degree, 63 and 59
// registers, no spills; erfc window, 48 and 59 registers, no spills;
// 32 KiB of static shared memory (33 KiB with the run-time
// coefficients).  So 3 blocks (48 warps) fit an SM without the
// potential and 2 with it.  The erfc window costs 81 f32 operations a
// pair where the degree-12 Clenshaw costs 46 (ops/p2p.py), so its
// instantiation issues ~1.4x the instructions without the potential;
// with it one erfcf serves both windows where the degree-12 kernel sums
// a second Clenshaw series.  chip_smoke.py's kernel phase times both
// instantiations at the main-path tier; PERF.md keeps the times.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;   // threads per block: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;      // source lanes per warp chunk
constexpr int kStages = 3;      // cp.async ring depth per warp
constexpr int kMaxBlk = 256;
constexpr int kMaxCoef = 64;    // Chebyshev coefficients per window
constexpr int kTplCoef = 13;    // degree-12 window: asmth 1.5
constexpr int kErfc = -1;       // the analytic erfc window
constexpr int kKindCheb = 0;    // window kinds of the C interface
constexpr int kKindErfc = 1;
constexpr float kTwoOverSqrtPi = 1.12837916709551257f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// Chebyshev series by Clenshaw, coefficients in registers.
template <int NC>
struct Series {
  float c[NC];
  __device__ __forceinline__ void load(const float* g, const float*, int) {
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] = __ldg(g + k);
  }
  __device__ __forceinline__ float operator()(float t) const {
    const float t2 = 2.f * t;
    float b1 = 0.f, b2 = 0.f;
#pragma unroll
    for (int k = NC - 1; k > 0; --k) {
      const float b0 = fmaf(t2, b1, c[k] - b2);
      b2 = b1;
      b1 = b0;
    }
    return fmaf(t, b1, c[0] - b2);
  }
};

// Run-time degree: coefficients in shared memory.
template <>
struct Series<0> {
  const float* c;
  int n;
  __device__ __forceinline__ void load(const float*, const float* s,
                                       int count) {
    c = s;
    n = count;
  }
  __device__ __forceinline__ float operator()(float t) const {
    const float t2 = 2.f * t;
    float b1 = 0.f, b2 = 0.f;
    for (int k = n - 1; k > 0; --k) {
      const float b0 = fmaf(t2, b1, c[k] - b2);
      b2 = b1;
      b1 = b0;
    }
    return fmaf(t, b1, c[0] - b2);
  }
};

__device__ __forceinline__ float cheb_t(float x) {
  return fminf(fmaxf(2.f * x - 1.f, -1.f), 1.f);
}

// The window at x = r / (cell xmax) (the caller zeroes x >= 1): the
// Chebyshev fits in t = 2x - 1, clipped to [0, 1], for the force and
// the potential (t is computed once: the compiler shares it).
template <int NC>
struct Window {
  Series<NC> f, p;
  __device__ __forceinline__ void load(const float* cf, const float* cp,
                                       const float* sf, const float* sp,
                                       int ncf, int ncp, bool want_pot,
                                       float) {
    f.load(cf, sf, ncf);
    if (want_pot) p.load(cp, sp, ncp);
  }
  __device__ __forceinline__ float force(float x) const {
    return clamp01(f(cheb_t(x)));
  }
  __device__ __forceinline__ float pot(float x) const {
    return clamp01(p(cheb_t(x)));
  }
};

// The analytic erfc window, u = x * ku with ku = xmax * 0.5 / asmth
// (the force's erfcf(u) serves the potential: the compiler shares it).
template <>
struct Window<kErfc> {
  float ku;
  __device__ __forceinline__ void load(const float*, const float*,
                                       const float*, const float*, int,
                                       int, bool, float k) {
    ku = k;
  }
  __device__ __forceinline__ float force(float x) const {
    const float u = x * ku;
    return erfcf(u) + kTwoOverSqrtPi * u * expf(-u * u);
  }
  __device__ __forceinline__ float pot(float x) const {
    return erfcf(x * ku);
  }
};

// rsqrt.approx.ftz: one MUFU instruction.  r2 is 0 or at least
// (box / 2^32)^2, never subnormal, so flushing changes no result.
__device__ __forceinline__ float rsqrt_ftz(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

struct Scalars {
  float to_f, hinv, h3i, soft2, inv_cellxmax;
};

// One source entry {x, y, z, mass bits} against this lane's target.
template <bool WANT_POT, int NC>
__device__ __forceinline__ void pair(const uint4 e, uint32_t tx, uint32_t ty,
                                     uint32_t tz, const Scalars& k,
                                     const Window<NC>& w, float& ax,
                                     float& ay, float& az, float& ap) {
  const float m = __uint_as_float(e.w);
  const float dx = static_cast<float>(static_cast<int32_t>(e.x - tx)) * k.to_f;
  const float dy = static_cast<float>(static_cast<int32_t>(e.y - ty)) * k.to_f;
  const float dz = static_cast<float>(static_cast<int32_t>(e.z - tz)) * k.to_f;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float rinv = r2 > 0.f ? rsqrt_ftz(r2) : 0.f;
  const float r = r2 * rinv;
  const float x = r * k.inv_cellxmax;
  // zero mass or x >= 1: the pair adds exactly 0 (window 0 or mass 0)
  const bool use = m != 0.f && x < 1.f;
  const float rinv3 = rinv * rinv * rinv;
  const float u = r * k.hinv;
  const bool insoft = r2 < k.soft2;
  float fac;
  if (insoft) {
    fac = u < 0.5f
              ? m * k.h3i * (10.666666666667f + u * u * (32.f * u - 38.4f))
              : m * k.h3i * (21.333333333333f - 48.f * u + 38.4f * u * u -
                             10.666666666667f * u * u * u) -
                    0.066666666667f * m * rinv3;
  } else {
    fac = m * rinv3;
  }
  const float fall = fac * w.force(x);
  if (use) {
    ax += dx * fall;
    ay += dy * fall;
    az += dz * fall;
  }
  if (WANT_POT) {
    float fpot;
    if (insoft) {
      const float wpi =
          -2.8f + u * u * (5.333333333333f + u * u * (6.4f * u - 9.6f));
      const float wpo =
          -3.2f + u * u * (10.666666666667f +
                           u * (-16.f + u * (9.6f - 2.133333333333f * u)));
      fpot = u < 0.5f ? m * k.hinv * wpi
                      : m * k.hinv * wpo + 0.066666666667f * m * rinv;
    } else {
      fpot = -m * rinv;
    }
    const float pall = fpot * w.pot(x);
    if (use) ap += pall;
  }
}

template <bool WANT_POT, int NC>
__global__ void __launch_bounds__(kThreads)
p2p_kernel(const uint32_t* __restrict__ tgt, const uint32_t* __restrict__ src,
           const float* __restrict__ smass, const float* __restrict__ cf,
           const float* __restrict__ cp, float* __restrict__ acc,
           float* __restrict__ pot, int blk, int S, int ncf, int ncp,
           float to_f, float soft, float inv_cellxmax, float ku, float g) {
  __shared__ uint4 ring[kWarps][kStages][kChunk];
  __shared__ float4 red[kThreads];
  __shared__ float scoef[2][NC == 0 ? kMaxCoef : 1];

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // geometry: bp = blk rounded up to a power of two
  int bp = 1;
  while (bp < blk) bp <<= 1;
  const int rows = bp >= 32 ? bp / 32 : 1;   // warps per set of targets
  const int parts = kWarps / rows;           // warp partitions of chunks
  const int sub = bp >= 32 ? 1 : 32 / bp;    // partitions inside a warp
  const int q = warp / rows;                 // this warp's partition
  const int i = bp >= 32 ? (warp % rows) * 32 + lane : lane % bp;
  const int p = bp >= 32 ? 0 : lane / bp;    // this lane's sub-partition
  const int per = kChunk / sub;              // entries per lane per chunk

  Window<NC> w;
  if constexpr (NC == 0) {
    for (int k = threadIdx.x; k < ncf; k += kThreads) scoef[0][k] = cf[k];
    if (WANT_POT)
      for (int k = threadIdx.x; k < ncp; k += kThreads) scoef[1][k] = cp[k];
    __syncthreads();
  }
  w.load(cf, cp, scoef[0], scoef[1], ncf, ncp, WANT_POT, ku);

  uint32_t tx = 0, ty = 0, tz = 0;
  if (i < blk) {
    const uint32_t* t = tgt + (static_cast<size_t>(b) * blk + i) * 3;
    tx = t[0];
    ty = t[1];
    tz = t[2];
  }
  Scalars k;
  k.to_f = to_f;
  k.hinv = 1.f / soft;
  k.h3i = k.hinv * k.hinv * k.hinv;
  k.soft2 = soft * soft;
  k.inv_cellxmax = inv_cellxmax;

  const uint32_t* srcb = src + static_cast<size_t>(b) * S * 3;
  const float* smb = smass + static_cast<size_t>(b) * S;
  const int nck = (S + kChunk - 1) / kChunk;
  const int mine = q < nck ? (nck - q + parts - 1) / parts : 0;
  uint4(*buf)[kChunk] = ring[warp];

  // the warp's n-th chunk (chunk q + n * parts) into ring slot n % kStages;
  // lanes past S are zero-filled (zero mass: padding)
  auto issue = [&](int n) {
    if (n < mine) {
      const int j = (q + n * parts) * kChunk + lane;
      const bool in = j < S;
      const size_t jj = in ? j : 0;
      uint32_t* d = reinterpret_cast<uint32_t*>(&buf[n % kStages][lane]);
      cp_async4(d + 0, srcb + 3 * jj + 0, in);
      cp_async4(d + 1, srcb + 3 * jj + 1, in);
      cp_async4(d + 2, srcb + 3 * jj + 2, in);
      cp_async4(d + 3, smb + jj, in);
    }
    cp_async_commit();
  };

  float ax = 0.f, ay = 0.f, az = 0.f, ap = 0.f;
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int n = 0; n < mine; ++n) {
    issue(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint4* e = buf[n % kStages];
    if (__any_sync(kFull, __uint_as_float(e[lane].w) != 0.f)) {
#pragma unroll 4
      for (int s = 0; s < per; ++s)
        pair<WANT_POT, NC>(e[p + sub * s], tx, ty, tz, k, w, ax, ay, az, ap);
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // sub-partitions of a warp: butterfly over lanes bp, 2 bp, ..., 16 apart
  for (int off = bp; off < 32; off <<= 1) {
    ax += __shfl_xor_sync(kFull, ax, off);
    ay += __shfl_xor_sync(kFull, ay, off);
    az += __shfl_xor_sync(kFull, az, off);
    if (WANT_POT) ap += __shfl_xor_sync(kFull, ap, off);
  }
  if (p == 0) red[q * bp + i] = make_float4(ax, ay, az, ap);
  __syncthreads();
  // warp partitions, in partition order
  const int t = threadIdx.x;
  if (t < blk) {
    float4 s = red[t];
    for (int r = 1; r < parts; ++r) {
      const float4 v = red[r * bp + t];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    float* a = acc + (static_cast<size_t>(b) * blk + t) * 3;
    a[0] = s.x * g;
    a[1] = s.y * g;
    a[2] = s.z * g;
    if (WANT_POT) pot[static_cast<size_t>(b) * blk + t] = s.w * g;
  }
}

// The instantiation that serves this window: kErfc for the erfc kind;
// for the Chebyshev kind kTplCoef with the coefficients in registers, or
// 0 for the run-time degree.
int instantiation(int kind, int ncf, int ncp, int want_pot) {
  if (kind == kKindErfc) return kErfc;
  return ncf == kTplCoef && (!want_pot || ncp == kTplCoef) ? kTplCoef : 0;
}

template <bool WANT_POT>
decltype(&p2p_kernel<WANT_POT, 0>) kernel_for(int inst) {
  return inst == kErfc       ? p2p_kernel<WANT_POT, kErfc>
         : inst == kTplCoef  ? p2p_kernel<WANT_POT, kTplCoef>
                             : p2p_kernel<WANT_POT, 0>;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as an opaque pointer) of device
// `device`.  Pointers are device pointers to contiguous arrays:
// tgt [nb, blk, 3] u32, src [nb, S, 3] u32, smass [nb, S] f32,
// cf [ncf] f32, cp [ncp] f32, acc [nb, blk, 3] f32, pot [nb, blk] f32
// (unused unless want_pot).  `kind` is the window: 0 the Chebyshev fit
// (cf, cp), 1 erfc (cf, cp unused; ku = xmax * 0.5 / asmth).  Returns
// the CUDA error code of the launch (0 on success); the kernel itself
// runs asynchronously.
int shenqi_p2p_blocked(const void* tgt, const void* src, const void* smass,
                       int kind, const void* cf, int ncf, const void* cp,
                       int ncp, float ku, void* acc, void* pot, int nb,
                       int blk, int S, float to_f, float soft,
                       float inv_cellxmax, float g, int want_pot,
                       int device, void* stream) {
  if (nb <= 0) return 0;
  const bool cheb = kind == kKindCheb;
  if (blk < 1 || blk > kMaxBlk || S < 0 ||
      (kind != kKindCheb && kind != kKindErfc) ||
      (cheb && (ncf < 1 || ncf > kMaxCoef ||
                (want_pot && (ncp < 1 || ncp > kMaxCoef)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int inst = instantiation(kind, ncf, ncp, want_pot);
  const auto kernel = want_pot ? kernel_for<true>(inst)
                               : kernel_for<false>(inst);
  kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tgt), static_cast<const uint32_t*>(src),
      static_cast<const float*>(smass), static_cast<const float*>(cf),
      static_cast<const float*>(cp), static_cast<float*>(acc),
      static_cast<float*>(pot), blk, S, ncf, ncp, to_f, soft, inv_cellxmax,
      ku, g);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation a launch with this window runs: -1 for the erfc
// window, else the Chebyshev degree + 1 compiled into the kernel, or 0
// for the run-time-degree kernel.
int shenqi_p2p_instantiation(int kind, int ncf, int ncp, int want_pot) {
  return instantiation(kind, ncf, ncp, want_pot);
}

const char* shenqi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
