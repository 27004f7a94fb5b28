// The W-plane FFT conv's 2-D real transforms and OTF product, in three
// passes over device memory (f32; core/fft_conv.py binds and documents them):
//
//   rows_r2c  real rows [R, Nb] -> half spectra [R, Kb], two rows a transform
//   cols      in place on [B, Na, Kb]: forward along Na, x scale * OTF (or
//             its conjugate), inverse along Na, each step where `flags` asks
//   rows_c2r  half spectra [R, Kb] -> real rows [R, Nb], two rows a transform
//
// Replaces no TPU kernel: the JAX package leaves the FFT to XLA.  On the card
// cuFFT ran the flagship's 501-point lines by Bluestein on 1024 points, with
// its own pre/pack/post passes, and torch added a scale pass per unitary
// transform, a clone of every C2R input and a pass for the OTF product.
//
// What bounds it on Hopper, at the flagship's 501 x 501 planes: device-memory
// bytes (each pass reads and writes a plane's worth once, 7 MB a plane a
// cube-mode direction with the OTF: 0.54 ms a 256-plane chunk at 3.35 TB/s).
// The transforms' own arithmetic, by the usual 5 N log2 N count (22.5 kflop
// a 501-point line, 1004 lines a plane a direction), is 0.09 ms a chunk at
// 67 TFLOP/s.  The algorithm below does 183 kflop a line (0.70 ms a chunk),
// so as built its FP32 issue rate, not the bytes, sets its time.  What the
// design does about each:
//   * a block holds 4 complex lines (8 real rows, or 4 neighbouring columns)
//     whole in shared memory, so each pass reads its input once and writes
//     its output once; the loads go global -> shared by cp.async, every copy
//     of a thread in flight at once; the OTF product, its conjugate and the
//     scale sit between the column pass's two transforms;
//   * a length-N transform, N = n1 n2, is n1 sums of length n2 over the
//     symmetric sums a[j] = x[j] + x[n2 - j], b[j] = x[j] - x[n2 - j]
//     (A[k] = x[0] + sum a[j] cos, B[k] = sum b[j] sin give X[k] and
//     X[n2 - k] together: half the multiplies of the plain sum), then n2
//     sums of length n1 with the twiddles w^(q k mod N) (Cooley-Tukey,
//     n = q + n1 j, k = n2 k1 + k2).  At 501 = 3 * 167 the table sums are a
//     small GEMM, [84 k] x [83 j] x [12 lines], tiled 4 k x 2 lines a thread
//     (126 of the block's 128 threads): per j a float4 of a, one of b and
//     four (cos, sin) pairs from shared memory, 32 FMAs.  The outputs go back
//     into the lines once every thread has read them, so a block needs one
//     buffer (48 KB with the tables: four blocks an SM);
//   * the length-3 sums take one k2 and all four lines a thread, each
//     twiddle loaded once;
//   * the tables ((cos, sin)(2 pi m / n2) over three periods, so entry
//     j k0 mod n2 + u j needs no second reduction, and (cos, sin)(2 pi m / N))
//     are built in float64 on the host, the angle reduced in integers, cast,
//     and copied into shared memory by each block.
// On the H100 a 256-plane chunk direction takes ~1.9 ms (cuFFT's spelling
// 3.8 ms): the table sums run near the rate the card issues their
// instructions (44 a j for 32 FMAs: ~58 % of the FP32 rate), the loads and
// stores ~0.3 ms.
//
// Lengths where the block's sums do not fit in place (more tiles than
// threads, or n1 > 4) keep a scratch buffer; four lines a block become two
// where 4 do not fit.  Launches on `stream`, allocates nothing, does not
// synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnrollJ = 8;  // table-sum terms a loop step
constexpr int kBatchP1 = 4;  // symmetric-sum pairs a thread loads before it stores them
constexpr int kBatch = 8;   // loads a thread keeps in flight before it stores them
constexpr int kFwd = 1, kMul = 2, kConj = 4, kInv = 8;

struct Plan {
  int n;          // transform length n1 * n2
  int n1, n2;     // n1 sums of length n2, then n2 sums of length n1
  int ha;         // symmetric-sum rows j = 1..ha (n2 / 2)
  int hk;         // outputs k = 0..hk-1 of each table sum (n2 / 2 + 1)
  int kp;         // outputs rounded up to a thread's 4
  int lines;      // complex lines a block (a power of two, >= 2)
  int log_lines;
  int tp;         // shared row stride, complex: lines + 2
  int in_place;   // the table sums' outputs go back into the lines (no scratch buffer)
  const float2* ct;  // [3 n2]: (cos, sin)(2 pi m / n2), m < 3 n2
  const float2* tw;  // [n]: (cos, sin)(2 pi m / n)
};

// The block's shared memory: the lines X and the scratch Y (n x tp complex
// each), then the tables copied from device memory at the kernel's start.
struct Smem {
  float2 *x, *y, *ct, *tw;
  __device__ Smem(float4* base, const Plan& p) {
    x = reinterpret_cast<float2*>(base);
    y = p.in_place ? x : x + p.n * p.tp;
    ct = y + p.n * p.tp;
    tw = ct + 3 * p.n2;
  }
  // the tables' copies start; the caller's cp_async_wait() and barrier end them
  __device__ void load_tables(const Plan& p);
};

// The table sums of one thread's tile: k = k0..k0+3 and two neighbouring
// lines (a float4 of two complex) of a (rows q + n1 j) and b (rows
// q + n1 (n2 - j)), j = 1..ha; cos / sin (2 pi j (k0 + m) / n2) read as
// ct[m0 + m j], m0 = j k0 mod n2.
struct Tile {
  float ar[4][2], ai[4][2], br[4][2], bi[4][2];

  __device__ __forceinline__ void step(const float2* xa, const float2* xb, const float2* ct, int m0,
                                       int j) {
    const float4 a = *reinterpret_cast<const float4*>(xa);
    const float4 b = *reinterpret_cast<const float4*>(xb);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float2 w = ct[m0 + m * j];
      ar[m][0] = fmaf(a.x, w.x, ar[m][0]);
      ai[m][0] = fmaf(a.y, w.x, ai[m][0]);
      ar[m][1] = fmaf(a.z, w.x, ar[m][1]);
      ai[m][1] = fmaf(a.w, w.x, ai[m][1]);
      br[m][0] = fmaf(b.x, w.y, br[m][0]);
      bi[m][0] = fmaf(b.y, w.y, bi[m][0]);
      br[m][1] = fmaf(b.z, w.y, br[m][1]);
      bi[m][1] = fmaf(b.w, w.y, bi[m][1]);
    }
  }

  // the sums over j of lines (q, t) and (q, t + 1)
  __device__ __forceinline__ void sums(const float2* in, const float2* ct, const Plan& p, int q, int t,
                                       int k0) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int l = 0; l < 2; ++l) ar[m][l] = ai[m][l] = br[m][l] = bi[m][l] = 0.f;
    const int n1 = p.n1, n2 = p.n2, xstep = n1 * p.tp;
    const float2* xa = in + (q + n1) * p.tp + t;
    const float2* xb = in + (q + n1 * (n2 - 1)) * p.tp + t;
    int j = 1, m0 = k0;
    for (; j + kUnrollJ - 1 <= p.ha; j += kUnrollJ) {
#pragma unroll
      for (int u = 0; u < kUnrollJ; ++u) {
        step(xa + u * xstep, xb - u * xstep, ct, m0, j + u);
        m0 += k0;
        if (m0 >= n2) m0 -= n2;
      }
      xa += kUnrollJ * xstep;
      xb -= kUnrollJ * xstep;
    }
    for (; j <= p.ha; ++j) {
      step(xa, xb, ct, m0, j);
      m0 += k0;
      if (m0 >= n2) m0 -= n2;
      xa += xstep;
      xb -= xstep;
    }
  }

  // Y[q][k] = A -/+ i B and Y[q][n2 - k] = A +/- i B into `dst` (rows q n2 + k),
  // A = x[q] (row q, lines t and t + 1) + the cos sums
  __device__ __forceinline__ void write_y(float2* dst, float4 x0, const Plan& p, int q, int t, int k0,
                                          float sgn) const {
    const int n2 = p.n2, tp = p.tp;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = k0 + m;
      if (k >= p.hk) break;
      const float a0r = x0.x + ar[m][0], a0i = x0.y + ai[m][0];
      const float a1r = x0.z + ar[m][1], a1i = x0.w + ai[m][1];
      const float b0r = sgn * br[m][0], b0i = sgn * bi[m][0];
      const float b1r = sgn * br[m][1], b1i = sgn * bi[m][1];
      *reinterpret_cast<float4*>(dst + (q * n2 + k) * tp + t) =
          make_float4(a0r + b0i, a0i - b0r, a1r + b1i, a1i - b1r);
      if (k > 0 && n2 - k > k)
        *reinterpret_cast<float4*>(dst + (q * n2 + n2 - k) * tp + t) =
            make_float4(a0r - b0i, a0i + b0r, a1r - b1i, a1i + b1r);
    }
  }
};

// Step 2 of dft_lines: each thread's tile of 4 k x 2 lines; the outputs into
// `other`, or, in place, into `in` once every thread has read it (a tile a
// thread at most).  Returns the buffer that holds Y.
__device__ __forceinline__ float2* table_sums(float2* in, float2* other, const Smem& sm,
                                              const Plan& p, float sgn) {
  const int T = p.lines, lt = p.log_lines, tp = p.tp;
  const int n_lg = (p.n1 * T) >> 1, items = (p.kp >> 2) * n_lg;
  Tile acc;
  if (p.in_place) {
    const int tid = threadIdx.x, l0 = (tid % n_lg) << 1, q = l0 >> lt, t = l0 & (T - 1);
    const int k0 = (tid / n_lg) << 2;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < items) {
      acc.sums(in, sm.ct, p, q, t, k0);
      x0 = *reinterpret_cast<const float4*>(in + q * tp + t);
    }
    __syncthreads();
    if (tid < items) acc.write_y(in, x0, p, q, t, k0, sgn);
    return in;
  }
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int l0 = (it % n_lg) << 1, q = l0 >> lt, t = l0 & (T - 1), k0 = (it / n_lg) << 2;
    acc.sums(in, sm.ct, p, q, t, k0);
    acc.write_y(other, *reinterpret_cast<const float4*>(in + q * tp + t), p, q, t, k0, sgn);
  }
  return other;
}

// Step 3 of dft_lines for a small n1, unrolled: a thread takes one k2 and all
// T lines, loads the n1 x T inputs and each twiddle once, and writes
// out[n2 k1 + k2] = sum_q Y[q][k2] w^(-/+ q k mod n) (q = 0 first).  It reads
// the rows {q n2 + k2} before it writes the same rows {n2 k1 + k2}, so
// `other` may be `in`.
template <int N1, int T>
__device__ __forceinline__ void twiddle_sums(float2* in, const float2* other, const Smem& sm,
                                             const Plan& p, float sgn) {
  const int tp = p.tp, n2 = p.n2, n = p.n;
  for (int k2 = threadIdx.x; k2 < n2; k2 += kThreads) {
    float4 y[N1][T / 2];
#pragma unroll
    for (int q = 0; q < N1; ++q)
#pragma unroll
      for (int h = 0; h < T / 2; ++h)
        y[q][h] = *reinterpret_cast<const float4*>(other + (q * n2 + k2) * tp + 2 * h);
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
      const int k = n2 * k1 + k2;
      float4 acc[T / 2];
#pragma unroll
      for (int h = 0; h < T / 2; ++h) acc[h] = y[0][h];
      int m = k;
#pragma unroll
      for (int q = 1; q < N1; ++q) {
        const float2 w = sm.tw[m];
        const float ws = -sgn * w.y;  // forward: conj(w)
#pragma unroll
        for (int h = 0; h < T / 2; ++h) {
          acc[h].x = fmaf(y[q][h].x, w.x, fmaf(-y[q][h].y, ws, acc[h].x));
          acc[h].y = fmaf(y[q][h].y, w.x, fmaf(y[q][h].x, ws, acc[h].y));
          acc[h].z = fmaf(y[q][h].z, w.x, fmaf(-y[q][h].w, ws, acc[h].z));
          acc[h].w = fmaf(y[q][h].w, w.x, fmaf(y[q][h].z, ws, acc[h].w));
        }
        m += k;
        if (m >= n) m -= n;
      }
#pragma unroll
      for (int h = 0; h < T / 2; ++h) *reinterpret_cast<float4*>(in + k * tp + 2 * h) = acc[h];
    }
  }
}

// The unnormalized DFT (forward e^-, inverse e^+) of each of the block's
// lines, held as buf[m * tp + t] (point m, line t) in `in`; `other` is
// scratch of the same size (unused in place).  Returns the buffer holding
// the result in the same layout: `in` where n1 > 1 or in place, else
// `other`.  `in` is overwritten.  Every thread of the block calls it; it
// ends synchronised.
__device__ float2* dft_lines(float2* in, float2* other, const Smem& sm, const Plan& p,
                            bool inverse) {
  const int tid = threadIdx.x;
  const int T = p.lines, lt = p.log_lines, tp = p.tp;
  const int n1 = p.n1, n2 = p.n2;

  // 1. symmetric sums in place: x[j] <- x[j] + x[n2 - j], x[n2 - j] <- x[j] - x[n2 - j],
  //    each thread a batch of pairs loaded before any is stored
  const int per_q = ((n2 - 1) / 2) << lt;  // pairs x lines of one sub-sequence
  for (int q = 0; q < n1; ++q)
    for (int it0 = tid; it0 < per_q; it0 += kThreads * kBatchP1) {
      float2 u[kBatchP1], v[kBatchP1];
#pragma unroll
      for (int i = 0; i < kBatchP1; ++i) {
        const int it = it0 + i * kThreads, t = it & (T - 1), j = (it >> lt) + 1;
        if (it < per_q) {
          u[i] = in[(q + n1 * j) * tp + t];
          v[i] = in[(q + n1 * (n2 - j)) * tp + t];
        }
      }
#pragma unroll
      for (int i = 0; i < kBatchP1; ++i) {
        const int it = it0 + i * kThreads, t = it & (T - 1), j = (it >> lt) + 1;
        if (it < per_q) {
          in[(q + n1 * j) * tp + t] = make_float2(u[i].x + v[i].x, u[i].y + v[i].y);
          in[(q + n1 * (n2 - j)) * tp + t] = make_float2(u[i].x - v[i].x, u[i].y - v[i].y);
        }
      }
    }
  __syncthreads();

  // 2. the table sums
  const float sgn = inverse ? -1.f : 1.f;
  other = table_sums(in, other, sm, p, sgn);
  __syncthreads();
  if (n1 == 1) return other;

  // 3. out[n2 k1 + k2] = sum_q Y[q][k2] w^(-/+ q k mod n), back into `in`
  switch (T == 4 && n1 <= 4 ? n1 : 0) {
    case 2: twiddle_sums<2, 4>(in, other, sm, p, sgn); break;
    case 3: twiddle_sums<3, 4>(in, other, sm, p, sgn); break;
    case 4: twiddle_sums<4, 4>(in, other, sm, p, sgn); break;
    default:
      for (int it = tid; it < n2 * T; it += kThreads) {
        const int t = it & (T - 1), k2 = it >> lt;
        for (int k1 = 0; k1 < n1; ++k1) {
          const int k = n2 * k1 + k2;
          float accr = 0.f, acci = 0.f;
          int m = 0;
          for (int q = 0; q < n1; ++q) {
            const float2 y = other[(q * n2 + k2) * tp + t];
            const float2 w = sm.tw[m];
            const float ws = -sgn * w.y;  // forward: conj(w)
            accr = fmaf(y.x, w.x, fmaf(-y.y, ws, accr));
            acci = fmaf(y.y, w.x, fmaf(y.x, ws, acci));
            m += k;
            if (m >= p.n) m -= p.n;
          }
          in[k * tp + t] = make_float2(accr, acci);
        }
      }
  }
  __syncthreads();
  return in;
}

// global to shared without a register, every copy of a thread in flight
// at once (cp.async, Ampere and later); cp_async_wait() before the barrier
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy8_async(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ void Smem::load_tables(const Plan& p) {
  for (int i = threadIdx.x; i < 3 * p.n2; i += kThreads) copy8_async(ct + i, p.ct + i);
  for (int i = threadIdx.x; i < p.n; i += kThreads) copy8_async(tw + i, p.tw + i);
}

__device__ __forceinline__ float2* other_of(float2* cur, float2* a, float2* b) {
  return cur == a ? b : a;
}

__global__ void __launch_bounds__(kThreads, 4)
    surfh_fft_rows_r2c_kernel(const float* __restrict__ x, float2* __restrict__ out,
                              long long rows, int nb, Plan p) {
  extern __shared__ float4 smem4[];
  Smem sm(smem4, p);
  sm.load_tables(p);
  float2 *X = sm.x, *Y = sm.y;
  const int T = p.lines, tp = p.tp, kb = nb / 2 + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * (2 * T);
  // row rr of the tile -> the real (even rr) or imaginary (odd rr) part of line rr / 2
  for (int rr = warp; rr < 2 * T; rr += kWarps) {
    const long long r = r0 + rr;
    float* dst = reinterpret_cast<float*>(X) + 2 * (rr >> 1) + (rr & 1);
    if (r < rows) {
      const float* src = x + r * nb;
      for (int n = lane; n < nb; n += 32) copy4_async(dst + 2 * n * tp, src + n);
    } else {
      for (int n = lane; n < nb; n += 32) dst[2 * n * tp] = 0.f;
    }
  }
  cp_async_wait();
  __syncthreads();
  const float2* Z = dft_lines(X, Y, sm, p, false);
  // H_even[k] = (Z[k] + conj Z[-k]) / 2, H_odd[k] = (Z[k] - conj Z[-k]) / 2i
  for (int rr = warp; rr < 2 * T; rr += kWarps) {
    const long long r = r0 + rr;
    if (r >= rows) continue;
    const int t = rr >> 1;
    float2* dst = out + r * kb;
    for (int k0 = lane; k0 < kb; k0 += 32 * kBatch) {
      float2 z[kBatch], zr[kBatch];  // a batch of shared loads before the stores
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int k = min(k0 + 32 * i, kb - 1);
        z[i] = Z[k * tp + t];
        zr[i] = Z[(k == 0 ? 0 : nb - k) * tp + t];
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (k0 + 32 * i < kb)
          __stcs(dst + k0 + 32 * i,
                 (rr & 1) ? make_float2(0.5f * (z[i].y + zr[i].y), 0.5f * (zr[i].x - z[i].x))
                          : make_float2(0.5f * (z[i].x + zr[i].x), 0.5f * (z[i].y - zr[i].y)));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    surfh_fft_rows_c2r_kernel(const float2* __restrict__ h, float* __restrict__ out,
                              long long rows, int nb, Plan p) {
  extern __shared__ float4 smem4[];
  Smem sm(smem4, p);
  sm.load_tables(p);
  float2 *X = sm.x, *Y = sm.y;
  const int T = p.lines, tp = p.tp, kb = nb / 2 + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * (2 * T);
  // line t = H[r0 + 2t] + i H[r0 + 2t + 1], extended by H[nb - m] = conj H[m]
  for (int t = warp; t < T; t += kWarps) {
    const long long r1 = r0 + 2 * t;
    for (int m0 = lane; m0 < kb; m0 += 32 * kBatch) {
      float2 a[kBatch], b[kBatch];  // a batch of loads in flight before their stores
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int m = m0 + 32 * i;
        a[i] = r1 < rows && m < kb ? __ldcs(h + r1 * kb + m) : make_float2(0.f, 0.f);
        b[i] = r1 + 1 < rows && m < kb ? __ldcs(h + (r1 + 1) * kb + m) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int m = m0 + 32 * i;
        if (m >= kb) break;
        if (m == 0 || 2 * m == nb) a[i].y = b[i].y = 0.f;  // a real bin: its imaginary part is not read
        X[m * tp + t] = make_float2(a[i].x - b[i].y, a[i].y + b[i].x);
        if (m > 0 && nb - m > m) X[(nb - m) * tp + t] = make_float2(a[i].x + b[i].y, b[i].x - a[i].y);
      }
    }
  }
  cp_async_wait();
  __syncthreads();
  const float2* Z = dft_lines(X, Y, sm, p, true);
  for (int rr = warp; rr < 2 * T; rr += kWarps) {
    const long long r = r0 + rr;
    if (r >= rows) continue;
    const int t = rr >> 1;
    float* dst = out + r * nb;
    for (int n0 = lane; n0 < nb; n0 += 32 * kBatch) {
      float v[kBatch];  // a batch of shared loads before the stores
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float2 z = Z[min(n0 + 32 * i, nb - 1) * tp + t];
        v[i] = (rr & 1) ? z.y : z.x;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (n0 + 32 * i < nb) __stcs(dst + n0 + 32 * i, v[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    surfh_fft_cols_kernel(float2* s, const float2* __restrict__ otf, long long ncols, int na,
                          int kb, int flags, float scale, Plan p) {
  extern __shared__ float4 smem4[];
  Smem sm(smem4, p);
  sm.load_tables(p);
  float2 *X = sm.x, *Y = sm.y;
  const int T = p.lines, tp = p.tp;
  // thread -> column t of the block's `lines` neighbouring flat columns, rows n0, n0 + nstep, ...
  const int t = threadIdx.x & (T - 1), n0 = threadIdx.x >> p.log_lines;
  const int nstep = kThreads >> p.log_lines;
  const long long c = static_cast<long long>(blockIdx.x) * T + t;
  const bool valid = c < ncols;
  long long base = 0;
  if (valid) {
    const long long plane = c / kb;
    base = plane * na * kb + (c - plane * kb);
  }
  for (int n = n0; n < na; n += nstep) {
    if (valid)
      copy8_async(X + n * tp + t, s + base + static_cast<long long>(n) * kb);
    else
      X[n * tp + t] = make_float2(0.f, 0.f);
  }
  cp_async_wait();
  __syncthreads();
  float2* cur = X;
  if (flags & kFwd) cur = dft_lines(cur, other_of(cur, X, Y), sm, p, false);
  if (flags & kMul) {
    const float osgn = (flags & kConj) ? -scale : scale;
    for (int nb0 = n0; valid && nb0 < na; nb0 += nstep * 2 * kBatch) {
      float2 o[2 * kBatch];  // a batch of loads in flight before the products
#pragma unroll
      for (int i = 0; i < 2 * kBatch; ++i) {
        const int n = nb0 + nstep * i;
        o[i] = n < na ? __ldcs(otf + base + static_cast<long long>(n) * kb) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 2 * kBatch; ++i) {
        const int n = nb0 + nstep * i;
        if (n >= na) break;
        const float orr = o[i].x * scale, oi = o[i].y * osgn;
        const float2 z = cur[n * tp + t];
        cur[n * tp + t] = make_float2(z.x * orr - z.y * oi, z.x * oi + z.y * orr);
      }
    }
    __syncthreads();
  }
  if (flags & kInv) cur = dft_lines(cur, other_of(cur, X, Y), sm, p, true);
  for (int nb0 = n0; valid && nb0 < na; nb0 += nstep * kBatch) {
    float2 v[kBatch];  // a batch of shared loads before the stores
#pragma unroll
    for (int i = 0; i < kBatch; ++i) v[i] = cur[min(nb0 + nstep * i, na - 1) * tp + t];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (nb0 + nstep * i < na) s[base + static_cast<long long>(nb0 + nstep * i) * kb] = v[i];
  }
}

Plan make_plan(int n1, int n2, int lines, const float* ct, const float* tw) {
  Plan p;
  p.n = n1 * n2;
  p.n1 = n1;
  p.n2 = n2;
  p.ha = n2 / 2;
  p.hk = n2 / 2 + 1;
  p.kp = (p.hk + 3) / 4 * 4;
  p.lines = lines;
  p.log_lines = 0;
  while ((1 << p.log_lines) < lines) ++p.log_lines;
  p.tp = lines + 2;
  // in place: four lines (the unrolled step 3), n1 <= 4, a tile of 4 k x 2 lines a thread at most
  p.in_place = lines == 4 && n1 <= 4 && (p.kp / 4) * (n1 * lines / 2) <= kThreads;
  p.ct = reinterpret_cast<const float2*>(ct);
  p.tw = reinterpret_cast<const float2*>(tw);
  return p;
}

bool valid_plan(const Plan& p, int smem) {
  const long long n = p.n, buffers = p.in_place ? 1 : 2;
  return p.n1 >= 1 && p.n2 >= 1 && (p.lines == 2 || p.lines == 4) &&
         smem >= (buffers * n * p.tp + 3 * p.n2 + n) * 8;
}

cudaError_t prepare(const void* kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

int surfh_fft_rows_r2c_f32(const float* x, void* out, long long rows, int nb, int n1, int n2,
                           int lines, int smem, const float* ct, const float* tw,
                           void* stream) {
  const Plan p = make_plan(n1, n2, lines, ct, tw);
  if (n1 * n2 != nb || !valid_plan(p, smem) || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(reinterpret_cast<const void*>(surfh_fft_rows_r2c_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (rows + 2 * lines - 1) / (2 * lines);
  surfh_fft_rows_r2c_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<float2*>(out), rows, nb, p);
  return static_cast<int>(cudaGetLastError());
}

int surfh_fft_rows_c2r_f32(const void* h, float* out, long long rows, int nb, int n1, int n2,
                           int lines, int smem, const float* ct, const float* tw,
                           void* stream) {
  const Plan p = make_plan(n1, n2, lines, ct, tw);
  if (n1 * n2 != nb || !valid_plan(p, smem) || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(reinterpret_cast<const void*>(surfh_fft_rows_c2r_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (rows + 2 * lines - 1) / (2 * lines);
  surfh_fft_rows_c2r_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(h), out, rows, nb, p);
  return static_cast<int>(cudaGetLastError());
}

int surfh_fft_cols_f32(void* s, const void* otf, long long ncols, int na, int kb, int flags,
                       float scale, int n1, int n2, int lines, int smem, const float* ct,
                       const float* tw, void* stream) {
  const Plan p = make_plan(n1, n2, lines, ct, tw);
  if (n1 * n2 != na || !valid_plan(p, smem) || ncols < 1 || kb < 1 ||
      ((flags & kMul) && otf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(reinterpret_cast<const void*>(surfh_fft_cols_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (ncols + lines - 1) / lines;
  surfh_fft_cols_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(s), static_cast<const float2*>(otf), ncols, na, kb, flags, scale, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
