// Composed window gather / composed transpose as one CSR row gather (f32):
//
//     out[r, :] = sum_{k in [row_ptr[r], row_ptr[r+1])} w[k] * src[idx[k], :]
//
// with every row Q floats wide and contiguous ([n_rows, Q] row-major).
//
// Replaces the TPU kernel surfh_tpu/core/scatter_pallas.py::_make_kernel,
// launched through gather_rows_pallas (scatter_pallas.py:138-189).  The
// TPU-only choices of that kernel are dropped: no SMEM [L, TP] tap-table
// transposition, no SUB x 128-lane payload packing, no SUB-prescaled
// indices, and no padded fixed fan-in L.  Taps come as CSR (row_ptr, idx,
// w) with a variable count per row, like the K2 prototype
// (scripts/scatter_pallas_proto.py:143-157): on small sky grids the
// transpose clamps thousands of taps onto border pixels, which a padded
// [P, L] table would multiply into every row.  The host plan drops
// zero-weight taps and sorts taps stably by destination row, so the
// forward gather's zero padding costs nothing and each row sums its taps
// in plan order (deterministic: no atomics).
//
// What bounds it on Hopper: device-memory (and L2) bytes, not arithmetic.
// Each tap costs one 4-byte index, one 4-byte weight and one Q-float source
// row read, for 2*Q flops: about 0.5 flop per byte.  The design spends its
// effort on the bytes:
//   * one thread per (row, 4-float slice): the nvec = Q/4 threads of a row
//     read one source row as a single coalesced run of 16-byte float4 loads
//     (scalar loads when Q % 4 != 0 or a base pointer is not 16-byte
//     aligned; the flagship's Q = 4*R always takes the float4 path);
//   * the threads of a row read the same index and weight, which the L1
//     broadcasts, so tap tables cost about one transaction per row and tap;
//   * taps are loaded four at a time before their FMAs, so four source-row
//     reads are in flight per thread;
//   * the source (the rank-basis patch or the slit-window values, a few MB
//     per pointing) stays resident in the 50 MB L2 across a launch, so the
//     C-fold reuse of each source row is served from L2, not HBM.
// A simple first design; not measured against the bandwidth roofline yet.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

__device__ __forceinline__ void fma_acc(float4& acc, float wk, const float4& x) {
  acc.x = fmaf(wk, x.x, acc.x);
  acc.y = fmaf(wk, x.y, acc.y);
  acc.z = fmaf(wk, x.z, acc.z);
  acc.w = fmaf(wk, x.w, acc.w);
}

__device__ __forceinline__ void fma_acc(float& acc, float wk, float x) {
  acc = fmaf(wk, x, acc);
}

template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ float4 zero_of<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }

constexpr int kThreads = 256;
constexpr int kTapBatch = 4;

// V = float4 (Q % 4 == 0) or float.  nvec = Q / (sizeof(V) / 4).
template <typename V>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const float* __restrict__ src, const int* __restrict__ row_ptr,
    const int* __restrict__ idx, const float* __restrict__ w,
    float* __restrict__ out, int n_rows, int nvec) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = t / nvec;
  if (r >= n_rows) return;
  const int v = static_cast<int>(t - r * nvec);
  const V* __restrict__ s = reinterpret_cast<const V*>(src) + v;
  const int k1 = __ldg(row_ptr + r + 1);
  int k = __ldg(row_ptr + r);
  V acc = zero_of<V>();
  for (; k + kTapBatch <= k1; k += kTapBatch) {
    int i[kTapBatch];
    float wk[kTapBatch];
    V x[kTapBatch];
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) {
      i[j] = __ldg(idx + k + j);
      wk[j] = __ldg(w + k + j);
    }
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) x[j] = __ldg(s + static_cast<long long>(i[j]) * nvec);
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) fma_acc(acc, wk[j], x[j]);
  }
  for (; k < k1; ++k) {
    fma_acc(acc, __ldg(w + k), __ldg(s + static_cast<long long>(__ldg(idx + k)) * nvec));
  }
  reinterpret_cast<V*>(out)[r * nvec + v] = acc;
}

}  // namespace

// src [n_src, q], row_ptr [n_rows + 1], idx / w [nnz], out [n_rows, q]; all
// device pointers, f32 / int32, contiguous.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int surfh_gather_rows_f32(const float* src, const int* row_ptr, const int* idx,
                                     const float* w, float* out, int n_rows, int q,
                                     void* stream) {
  if (n_rows <= 0 || q <= 0) return static_cast<int>(cudaSuccess);
  const bool vec4 = (q % 4 == 0) && (reinterpret_cast<std::uintptr_t>(src) % 16 == 0) &&
                    (reinterpret_cast<std::uintptr_t>(out) % 16 == 0);
  const int nvec = vec4 ? q / 4 : q;
  const long long total = static_cast<long long>(n_rows) * nvec;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4) {
    gather_rows_kernel<float4><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        src, row_ptr, idx, w, out, n_rows, nvec);
  } else {
    gather_rows_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        src, row_ptr, idx, w, out, n_rows, nvec);
  }
  return static_cast<int>(cudaGetLastError());
}
