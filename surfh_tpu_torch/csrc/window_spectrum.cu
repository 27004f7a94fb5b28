// The spectrum side of the dense window-local conv, one pass a direction
// (f32), over a band's W λ planes of nbins = Ka'·Kb' kept bins:
//
//   forward    zw[w] = Σ_m tpl[m, w] · zm[m]          (the templates' mix)
//              t     = zw · otf[w]                     (complex product)
//              writes t_re, t_im and t_re + t_im, the three operands of the
//              inverse α stage's Gauss-3M GEMMs (core/fft.py::_idft_rows);
//   transpose  t_re = k1 + pd,  t_im = k1 − ps          (the α stage's post-adds)
//              zw   = t · conj(otf[w])
//              zm[m] = Σ_w tpl[m, w] · zw[w]           (the mix's transpose)
//              writes only the [M, nbins] sums that core/fft.py::_dft_maps_t reads.
//
// Cube mode (no templates, kMaps = 0) compiles the mix out: the forward
// reads zw = the W planes' own spectra, the transpose writes zw.
//
// Replaces no TPU kernel: the JAX package leaves this glue to XLA, which
// fuses it.  Eager PyTorch spelled it as 16 elementwise kernels and two
// mix GEMMs a band and normal, moving ~47 spectrum volumes S = W·nbins
// floats; this pass moves 5 a direction (forward: the OTF's two planes
// read, three written; transpose: k1, pd, ps and the OTF read, M-row sums
// written).
//
// The arithmetic is the eager chain's, operation for operation and in its
// order, with round-to-nearest intrinsics that nvcc cannot contract into
// an FMA; only the mix sums differ from cuBLAS's order (an FMA chain over
// m ascending; over w ascending within a block, the blocks' partial sums
// added in block order by a second pass: the same bits on every run).
//
// What bounds it on Hopper: device-memory bytes, 20 a bin and plane for
// ~15 flops (band 1b of the 12-band flagship: 1.050 GB a direction, 0.313
// ms at 3.35 TB/s).  The design streams:
//   * a thread owns one bin and walks a run of λ planes; a warp's loads of
//     one plane are 32 consecutive floats (the OTF may be the real or the
//     imaginary view of a complex table: a bin step of 2, still one
//     sector pair a warp).  The M map values (forward) or the 2M sums
//     (transpose) stay in registers for the whole run;
//   * each thread issues the loads of kUnroll planes before it computes
//     any (10 / 20 floats in flight a thread), stores and loads streamed
//     (evict-first): nothing is read twice;
//   * the planes are split over blockIdx.y where the bins alone leave the
//     card's SMs short of blocks (core/window_spectrum.py::launch_split);
//     the forward's split costs nothing, the transpose's (with templates)
//     writes split partial sums of [2, M, nbins], added by a second,
//     small pass.
//
// Launches on `stream`, allocates nothing, does not synchronise.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // planes whose loads a thread issues before it computes
constexpr int kMaxMaps = 8;  // templates a launch takes (registers: 2 per map)
constexpr int kMaxSplit = 65535;

__device__ __forceinline__ int split_at(int w, int part, int split) {
  return static_cast<int>(static_cast<long long>(part) * w / split);
}

template <int kMaps>
__global__ void __launch_bounds__(kThreads)
window_spectrum_fwd_kernel(const float* __restrict__ z_re, const float* __restrict__ z_im,
                           const float* __restrict__ tpl, long long ld_tpl,
                           const float* __restrict__ o_re, const float* __restrict__ o_im,
                           long long o_plane, int o_step, float* __restrict__ t_re,
                           float* __restrict__ t_im, float* __restrict__ t_sum, int w,
                           long long nbins, int split) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= nbins) return;
  const int w0 = split_at(w, blockIdx.y, split), w1 = split_at(w, blockIdx.y + 1, split);
  constexpr int kM = kMaps > 0 ? kMaps : 1;
  float mr[kM], mi[kM];
  if (kMaps > 0) {
#pragma unroll
    for (int m = 0; m < kMaps; ++m) {
      mr[m] = __ldg(z_re + m * nbins + b);
      mi[m] = __ldg(z_im + m * nbins + b);
    }
  }
  const float* ore = o_re + b * o_step;
  const float* oim = o_im + b * o_step;
  for (int p = w0; p < w1; p += kUnroll) {
    float ar[kUnroll], ai[kUnroll], xr[kUnroll], xi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u;
      if (q < w1) {
        ar[u] = __ldcs(ore + q * o_plane);
        ai[u] = __ldcs(oim + q * o_plane);
        if (kMaps == 0) {
          xr[u] = __ldcs(z_re + q * nbins + b);
          xi[u] = __ldcs(z_im + q * nbins + b);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u;
      if (q >= w1) break;
      float zr, zi;
      if (kMaps > 0) {
        float c = __ldg(tpl + q);
        zr = __fmul_rn(c, mr[0]);
        zi = __fmul_rn(c, mi[0]);
#pragma unroll
        for (int m = 1; m < kMaps; ++m) {
          c = __ldg(tpl + m * ld_tpl + q);
          zr = __fmaf_rn(c, mr[m], zr);
          zi = __fmaf_rn(c, mi[m], zi);
        }
      } else {
        zr = xr[u];
        zi = xi[u];
      }
      // t_re = zw_re*otf_re - zw_im*otf_im;  t_im = zw_re*otf_im + zw_im*otf_re
      const float tr = __fsub_rn(__fmul_rn(zr, ar[u]), __fmul_rn(zi, ai[u]));
      const float ti = __fadd_rn(__fmul_rn(zr, ai[u]), __fmul_rn(zi, ar[u]));
      const long long o = q * nbins + b;
      __stcs(t_re + o, tr);
      __stcs(t_im + o, ti);
      __stcs(t_sum + o, __fadd_rn(tr, ti));
    }
  }
}

template <int kMaps>
__global__ void __launch_bounds__(kThreads)
window_spectrum_t_kernel(const float* __restrict__ k1, const float* __restrict__ pd,
                         const float* __restrict__ ps, const float* __restrict__ tpl,
                         long long ld_tpl, const float* __restrict__ o_re,
                         const float* __restrict__ o_im, long long o_plane, int o_step,
                         float* __restrict__ z_re, float* __restrict__ z_im, long long z_part,
                         int w, long long nbins, int split) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= nbins) return;
  const int w0 = split_at(w, blockIdx.y, split), w1 = split_at(w, blockIdx.y + 1, split);
  constexpr int kM = kMaps > 0 ? kMaps : 1;
  float sr[kM], si[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) sr[m] = si[m] = 0.f;
  const float* ore = o_re + b * o_step;
  const float* oim = o_im + b * o_step;
  for (int p = w0; p < w1; p += kUnroll) {
    float kv[kUnroll], dv[kUnroll], sv[kUnroll], ar[kUnroll], ai[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u;
      if (q < w1) {
        const long long o = q * nbins + b;
        kv[u] = __ldcs(k1 + o);
        dv[u] = __ldcs(pd + o);
        sv[u] = __ldcs(ps + o);
        ar[u] = __ldcs(ore + q * o_plane);
        ai[u] = __ldcs(oim + q * o_plane);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u;
      if (q >= w1) break;
      const float tr = __fadd_rn(kv[u], dv[u]);
      const float ti = __fsub_rn(kv[u], sv[u]);
      // zw_re = t_re*otf_re + t_im*otf_im;  zw_im = -t_re*otf_im + t_im*otf_re
      const float zr = __fadd_rn(__fmul_rn(tr, ar[u]), __fmul_rn(ti, ai[u]));
      const float zi = __fsub_rn(__fmul_rn(ti, ar[u]), __fmul_rn(tr, ai[u]));
      if (kMaps > 0) {
#pragma unroll
        for (int m = 0; m < kMaps; ++m) {
          const float c = __ldg(tpl + m * ld_tpl + q);
          sr[m] = __fmaf_rn(c, zr, sr[m]);
          si[m] = __fmaf_rn(c, zi, si[m]);
        }
      } else {
        __stcs(z_re + q * nbins + b, zr);
        __stcs(z_im + q * nbins + b, zi);
      }
    }
  }
  if (kMaps > 0) {
    float* dr = z_re + blockIdx.y * z_part;
    float* di = z_im + blockIdx.y * z_part;
#pragma unroll
    for (int m = 0; m < kMaps; ++m) {
      dr[m * nbins + b] = sr[m];
      di[m * nbins + b] = si[m];
    }
  }
}

// out[i] = ((parts[0][i] + parts[1][i]) + parts[2][i]) + ..., parts [split, n]
__global__ void __launch_bounds__(kThreads)
window_spectrum_sum_parts_kernel(const float* __restrict__ parts, float* __restrict__ out,
                                 long long n, int split) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    float s = __ldcs(parts + i);
    for (int k = 1; k < split; ++k) s = __fadd_rn(s, __ldcs(parts + k * n + i));
    out[i] = s;
  }
}

bool shape_ok(int n_maps, int w, long long nbins, int split, int o_step) {
  return n_maps >= 0 && n_maps <= kMaxMaps && w > 0 && nbins > 0 && split >= 1 && split <= w &&
         split <= kMaxSplit && o_step >= 1 && (nbins + kThreads - 1) / kThreads <= INT_MAX;
}

dim3 grid_of(long long nbins, int split) {
  return dim3(static_cast<unsigned>((nbins + kThreads - 1) / kThreads), static_cast<unsigned>(split));
}

template <int kMaps>
void launch_fwd(const float* z_re, const float* z_im, const float* tpl, long long ld_tpl,
                const float* o_re, const float* o_im, long long o_plane, int o_step, float* t,
                int w, long long nbins, int split, cudaStream_t st) {
  const long long s = static_cast<long long>(w) * nbins;
  window_spectrum_fwd_kernel<kMaps><<<grid_of(nbins, split), kThreads, 0, st>>>(
      z_re, z_im, tpl, ld_tpl, o_re, o_im, o_plane, o_step, t, t + s, t + 2 * s, w, nbins, split);
}

template <int kMaps>
void launch_t(const float* k1, const float* pd, const float* ps, const float* tpl,
              long long ld_tpl, const float* o_re, const float* o_im, long long o_plane,
              int o_step, float* z_re, float* z_im, long long z_part, int w, long long nbins,
              int split, cudaStream_t st) {
  window_spectrum_t_kernel<kMaps><<<grid_of(nbins, split), kThreads, 0, st>>>(
      k1, pd, ps, tpl, ld_tpl, o_re, o_im, o_plane, o_step, z_re, z_im, z_part, w, nbins, split);
}

#define SURFH_MAPS_CASES(F, ...) \
  switch (n_maps) {              \
    case 0: F<0>(__VA_ARGS__); break; \
    case 1: F<1>(__VA_ARGS__); break; \
    case 2: F<2>(__VA_ARGS__); break; \
    case 3: F<3>(__VA_ARGS__); break; \
    case 4: F<4>(__VA_ARGS__); break; \
    case 5: F<5>(__VA_ARGS__); break; \
    case 6: F<6>(__VA_ARGS__); break; \
    case 7: F<7>(__VA_ARGS__); break; \
    default: F<8>(__VA_ARGS__); break; \
  }

}  // namespace

// Forward.  z_re / z_im: [n_maps, nbins] (n_maps = 0: [w, nbins], the
// planes' own spectra); tpl [n_maps, w] with row stride ld_tpl (unread
// when n_maps = 0); o_re / o_im: plane q, bin b at q * o_plane + b * o_step;
// t: [3, w, nbins] out (t_re, t_im, t_re + t_im).  All f32 device
// pointers, t overlapping no input.  1 <= split <= w: the planes' runs
// (blockIdx.y).  Returns cudaGetLastError() (0 = launched) or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int surfh_window_spectrum_f32(const float* z_re, const float* z_im, const float* tpl,
                                         long long ld_tpl, int n_maps, const float* o_re,
                                         const float* o_im, long long o_plane, int o_step,
                                         float* t, int w, long long nbins, int split,
                                         void* stream) {
  if (!shape_ok(n_maps, w, nbins, split, o_step)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SURFH_MAPS_CASES(launch_fwd, z_re, z_im, tpl, ld_tpl, o_re, o_im, o_plane, o_step, t, w, nbins,
                   split, st)
  return static_cast<int>(cudaGetLastError());
}

// Transpose.  k1 / pd / ps: [w, nbins] contiguous; tpl, o_re, o_im as the
// forward's; out: [2, n_maps, nbins] (n_maps = 0: [2, w, nbins]), re then
// im.  With templates and split > 1, parts ([split, 2, n_maps, nbins],
// scratch) takes each run's partial sums and a second kernel adds them in
// run order into out; otherwise parts is unread (may be null).
extern "C" int surfh_window_spectrum_t_f32(const float* k1, const float* pd, const float* ps,
                                           const float* tpl, long long ld_tpl, int n_maps,
                                           const float* o_re, const float* o_im, long long o_plane,
                                           int o_step, float* out, float* parts, int w,
                                           long long nbins, int split, void* stream) {
  if (!shape_ok(n_maps, w, nbins, split, o_step)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sum = n_maps > 0 && split > 1;
  if (sum && parts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long half = static_cast<long long>(n_maps > 0 ? n_maps : w) * nbins;
  float* dst = sum ? parts : out;
  SURFH_MAPS_CASES(launch_t, k1, pd, ps, tpl, ld_tpl, o_re, o_im, o_plane, o_step, dst, dst + half,
                   2 * half, w, nbins, split, st)
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !sum) return static_cast<int>(err);
  const long long n = 2 * half;
  const long long need = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(need < 4096 ? need : 4096);
  window_spectrum_sum_parts_kernel<<<blocks, kThreads, 0, st>>>(parts, out, n, split);
  return static_cast<int>(cudaGetLastError());
}
