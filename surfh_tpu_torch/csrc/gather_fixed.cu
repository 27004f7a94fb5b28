// Fixed-fan-in row gather (f32), three kernels:
//
//     out[p, :] = sum_{l < L} tw[p * L + l] * src[tsrc[p * L + l], :]
//
// with rows W floats wide and contiguous (src [n_src, W], out [P, W]) and a
// padded tap table tsrc / tw [Pp, L] (Pp >= P, padded taps tsrc = 0, tw = 0).
//
// Replaces the three TPU prototypes of scripts/scatter_pallas_proto.py:
//   K1  k1_kernel (:113, called by k1 at :124): a static loop over all L
//       taps of every row, zero taps included;
//   K2  k2_kernel (:143, called by k2 at :159): a dynamic loop over exactly
//       cnt[p] taps of the padded row (table stride L, unlike the CSR kernel
//       of gather_rows.cu);
//   K3  k3_kernel (:185, called by k3 at :205): K1 over four rows at once,
//       from source offsets pre-scaled on the host (tsrc * ld, int32).
// They compute what the prototypes compute, on rows of W floats.  The TPU's
// choices are dropped: no [n_src * SUB, 128] lane packing of the source, no
// SMEM [TP, L] tap windows per grid step, no fori_loop over the rows of a
// block.  Each thread owns one V-wide slice of one output row (of four rows
// in K3); the row padding to Pp is kept only so that K3's groups of four
// rows read inside the table.
//
// What bounds them on Hopper: bytes, not arithmetic.  The work the inputs
// need is nnz taps (the CSR count, not Pp * L): the output P * W * 4 bytes
// written once, the source n_src * W * 4 read once, the taps nnz * 8 and the
// row pointers (P + 1) * 4 bytes -- 60.2 MB, 18.0 us at 3.35 TB/s for band
// 1c at Q = W -- for 2 flops per tap and float, about 0.5 flop per byte.
// What the design does about it:
//   * the source block (a few MB per pointing) stays resident in the 50 MB
//     L2, so the C-fold reuse of its rows, and the ~4x padded taps of K1 and
//     K3 (Pp * L against nnz), cost L2 traffic, not device-memory traffic;
//   * the output is written once, in coalesced runs: the nvec = W / vw
//     threads of a row write one row, vw = 4, 2 or 1 floats per thread
//     chosen per launch from W and the base pointers' alignment (W = 466 and
//     434 take float2, W = 181 scalar, a multiple of 4 float4) -- no padded
//     leading dimension, so no padded copy of the source or the output;
//   * the threads of a row read the same tap entries (an L1 broadcast);
//     K1 issues all L source loads of a row before its FMAs, K2 four at a
//     time, K3 the four rows' loads of one tap together: loads in flight.
// Simple first kernels, not tuned.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 8;  // static fan-in instances of K1 / K3 (surfh_tpu_torch.core.gather_fixed.MAX_L)
constexpr int kUnroll = 4;  // rows per thread in K3
constexpr int kTapBatch = 4;  // K2's loads in flight

__device__ __forceinline__ void fma_acc(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}
__device__ __forceinline__ void fma_acc(float2& acc, float w, const float2& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
}
__device__ __forceinline__ void fma_acc(float& acc, float w, float x) { acc = fmaf(w, x, acc); }

__device__ __forceinline__ float4 scale(float w, const float4& x) {
  return make_float4(w * x.x, w * x.y, w * x.z, w * x.w);
}
__device__ __forceinline__ float2 scale(float w, const float2& x) { return make_float2(w * x.x, w * x.y); }
__device__ __forceinline__ float scale(float w, float x) { return w * x; }

template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ float4 zero_of<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float2 zero_of<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }

// K1: one thread per (row, V slice); all L taps, loads before FMAs.
template <int L, typename V>
__global__ void __launch_bounds__(kThreads) k1_kernel(
    const float* __restrict__ src, const int* __restrict__ tsrc, const float* __restrict__ tw,
    float* __restrict__ out, int n_rows, int nvec) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = t / nvec;
  if (r >= n_rows) return;
  const int v = static_cast<int>(t - r * nvec);
  const V* __restrict__ s = reinterpret_cast<const V*>(src) + v;
  const int* ti = tsrc + r * L;
  const float* wi = tw + r * L;
  int i[L];
  float w[L];
  V x[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    i[l] = __ldg(ti + l);
    w[l] = __ldg(wi + l);
  }
#pragma unroll
  for (int l = 0; l < L; ++l) x[l] = __ldg(s + static_cast<long long>(i[l]) * nvec);
  V acc = scale(w[0], x[0]);
#pragma unroll
  for (int l = 1; l < L; ++l) fma_acc(acc, w[l], x[l]);
  reinterpret_cast<V*>(out)[r * nvec + v] = acc;
}

// K2: one thread per (row, V slice); exactly cnt[r] taps at table stride L.
template <typename V>
__global__ void __launch_bounds__(kThreads) k2_kernel(
    const float* __restrict__ src, const int* __restrict__ tsrc, const float* __restrict__ tw,
    const int* __restrict__ cnt, float* __restrict__ out, int n_rows, int L, int nvec) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = t / nvec;
  if (r >= n_rows) return;
  const int v = static_cast<int>(t - r * nvec);
  const V* __restrict__ s = reinterpret_cast<const V*>(src) + v;
  const int* ti = tsrc + r * L;
  const float* wi = tw + r * L;
  const int n = __ldg(cnt + r);
  V acc = zero_of<V>();
  int l = 0;
  for (; l + kTapBatch <= n; l += kTapBatch) {
    int i[kTapBatch];
    float w[kTapBatch];
    V x[kTapBatch];
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) {
      i[j] = __ldg(ti + l + j);
      w[j] = __ldg(wi + l + j);
    }
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) x[j] = __ldg(s + static_cast<long long>(i[j]) * nvec);
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) fma_acc(acc, w[j], x[j]);
  }
  for (; l < n; ++l) fma_acc(acc, __ldg(wi + l), __ldg(s + static_cast<long long>(__ldg(ti + l)) * nvec));
  reinterpret_cast<V*>(out)[r * nvec + v] = acc;
}

// K3: one thread per (group of four rows, V slice); for each tap l, the four
// rows' source loads are issued together, then their FMAs.  off = tsrc * ld
// in floats.  The table holds whole groups (Pp % 4 == 0); rows >= n_rows are
// computed from their zero taps and not written.
template <int L, typename V>
__global__ void __launch_bounds__(kThreads) k3_kernel(
    const float* __restrict__ src, const int* __restrict__ off, const float* __restrict__ tw,
    float* __restrict__ out, int n_rows, int nvec) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long g = t / nvec;
  const long long r0 = g * kUnroll;
  if (r0 >= n_rows) return;
  const int v = static_cast<int>(t - g * nvec);
  const int* oi = off + r0 * L;
  const float* wi = tw + r0 * L;
  V acc[kUnroll];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float w[kUnroll];
    V x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = __ldg(wi + u * L + l);
      x[u] = __ldg(reinterpret_cast<const V*>(src + __ldg(oi + u * L + l)) + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (l == 0) {
        acc[u] = scale(w[u], x[u]);
      } else {
        fma_acc(acc[u], w[u], x[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (r0 + u < n_rows) reinterpret_cast<V*>(out)[(r0 + u) * nvec + v] = acc[u];
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<std::uintptr_t>(p) % bytes == 0; }

// Floats per thread: 4 or 2 where W and both base pointers allow, else 1.
int vec_width(int q, const void* src, const void* out) {
  if (q % 4 == 0 && aligned(src, 16) && aligned(out, 16)) return 4;
  if (q % 2 == 0 && aligned(src, 8) && aligned(out, 8)) return 2;
  return 1;
}

bool grid_of(long long threads, unsigned* blocks) {
  const long long b = (threads + kThreads - 1) / kThreads;
  if (b > INT_MAX) return false;
  *blocks = static_cast<unsigned>(b);
  return true;
}

template <int L>
int launch_k1_static(const float* src, const int* tsrc, const float* tw, float* out, int n_rows,
                     int q, cudaStream_t st) {
  const int vw = vec_width(q, src, out);
  const int nvec = q / vw;
  unsigned blocks;
  if (!grid_of(static_cast<long long>(n_rows) * nvec, &blocks)) return cudaErrorInvalidConfiguration;
  if (vw == 4) {
    k1_kernel<L, float4><<<blocks, kThreads, 0, st>>>(src, tsrc, tw, out, n_rows, nvec);
  } else if (vw == 2) {
    k1_kernel<L, float2><<<blocks, kThreads, 0, st>>>(src, tsrc, tw, out, n_rows, nvec);
  } else {
    k1_kernel<L, float><<<blocks, kThreads, 0, st>>>(src, tsrc, tw, out, n_rows, nvec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_k3_static(const float* src, const int* off, const float* tw, float* out, int n_rows,
                     int q, cudaStream_t st) {
  const int vw = vec_width(q, src, out);
  const int nvec = q / vw;
  const long long groups = (static_cast<long long>(n_rows) + kUnroll - 1) / kUnroll;
  unsigned blocks;
  if (!grid_of(groups * nvec, &blocks)) return cudaErrorInvalidConfiguration;
  if (vw == 4) {
    k3_kernel<L, float4><<<blocks, kThreads, 0, st>>>(src, off, tw, out, n_rows, nvec);
  } else if (vw == 2) {
    k3_kernel<L, float2><<<blocks, kThreads, 0, st>>>(src, off, tw, out, n_rows, nvec);
  } else {
    k3_kernel<L, float><<<blocks, kThreads, 0, st>>>(src, off, tw, out, n_rows, nvec);
  }
  return static_cast<int>(cudaGetLastError());
}

// The run-time L picks its static instance: L = 1 .. kMaxL.
template <int L = 1>
int launch_k1(int l, const float* src, const int* tsrc, const float* tw, float* out, int n_rows,
              int q, cudaStream_t st) {
  if constexpr (L > kMaxL) {
    return cudaErrorInvalidValue;
  } else {
    if (l == L) return launch_k1_static<L>(src, tsrc, tw, out, n_rows, q, st);
    return launch_k1<L + 1>(l, src, tsrc, tw, out, n_rows, q, st);
  }
}

template <int L = 1>
int launch_k3(int l, const float* src, const int* off, const float* tw, float* out, int n_rows,
              int q, cudaStream_t st) {
  if constexpr (L > kMaxL) {
    return cudaErrorInvalidValue;
  } else {
    if (l == L) return launch_k3_static<L>(src, off, tw, out, n_rows, q, st);
    return launch_k3<L + 1>(l, src, off, tw, out, n_rows, q, st);
  }
}

}  // namespace

// All pointers are device pointers, f32 / int32, contiguous: src [n_src, q],
// tsrc / off / tw [Pp, L] (Pp >= n_rows; Pp % 4 == 0 for K3), cnt [Pp],
// out [n_rows, q].  Each launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 = launched); an L outside 1 .. kMaxL (8) for
// K1 / K3, or L <= 0 for K2, returns cudaErrorInvalidValue.
extern "C" int surfh_gather_fixed_k1_f32(const float* src, const int* tsrc, const float* tw,
                                         float* out, int n_rows, int L, int q, void* stream) {
  if (n_rows <= 0 || q <= 0) return static_cast<int>(cudaSuccess);
  return launch_k1(L, src, tsrc, tw, out, n_rows, q, static_cast<cudaStream_t>(stream));
}

extern "C" int surfh_gather_fixed_k2_f32(const float* src, const int* tsrc, const float* tw,
                                         const int* cnt, float* out, int n_rows, int L, int q,
                                         void* stream) {
  if (n_rows <= 0 || q <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vw = vec_width(q, src, out);
  const int nvec = q / vw;
  unsigned blocks;
  if (!grid_of(static_cast<long long>(n_rows) * nvec, &blocks)) return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vw == 4) {
    k2_kernel<float4><<<blocks, kThreads, 0, st>>>(src, tsrc, tw, cnt, out, n_rows, L, nvec);
  } else if (vw == 2) {
    k2_kernel<float2><<<blocks, kThreads, 0, st>>>(src, tsrc, tw, cnt, out, n_rows, L, nvec);
  } else {
    k2_kernel<float><<<blocks, kThreads, 0, st>>>(src, tsrc, tw, cnt, out, n_rows, L, nvec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int surfh_gather_fixed_k3_f32(const float* src, const int* off, const float* tw,
                                         float* out, int n_rows, int L, int q, void* stream) {
  if (n_rows <= 0 || q <= 0) return static_cast<int>(cudaSuccess);
  return launch_k3(L, src, off, tw, out, n_rows, q, static_cast<cudaStream_t>(stream));
}
