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
// row read, for 2*Q flops: about 0.5 flop per byte; the W-plane transposes
// have about one tap per row, so their work is writing the output once.
// Two kernels, by row width.  gather_rows_narrow_kernel, for rows of a few
// slices (the rank path's Q = 4R = 24-40: 6-10 float4), gives one thread one
// 16-byte (or 4-byte) slice of a row; the thread loads the row pointers and
// every index and weight of the row for its slice.  Its block is
// two-dimensional (x = slice, y = row), and the hardware numbers threads
// slice-first: a warp holds whole consecutive rows and writes one dense run,
// and no index is divided.  On wide rows (the W-plane path's Q = W =
// 241-613) that shape is bound by instructions, not bytes, and Q mod 4
// decides its time (on the H100, 19-22 % of the byte bound at odd Q against
// 70 % on float4).  gather_rows_kernel spends instructions once per row
// there and keeps many bytes in flight per lane (its row body is
// gather_lanes.cuh, which K2 of gather_fixed.cu runs on its own taps):
//   * a group of G lanes (a power of two <= 32, picked by the wrapper from
//     Q) owns one output row, 32 / G rows to a warp; the row comes from the
//     block, warp and lane index, no division.  (The kernel takes any
//     G <= 32; other widths measured slower on the H100.);
//   * a lane holds 8, 16 or 24 floats of the row in registers and loads all
//     of them for one tap (two at 8 floats) before their FMAs: 64-96 bytes
//     in flight per lane, four or five blocks of 256 threads per SM.
//     The wrapper picks the least width with which 32 lanes cover the row
//     in one chunk (Q <= 256, 512, 768; wider rows are cut into chunks over
//     blockIdx.x): the transposes have 0-7 taps per row and half their rows
//     empty, so what counts is that a row's fixed chain (row pointers, taps,
//     source, store) is paid once.  Rows of many taps (the forward gathers:
//     a few thousand rows of 17-23 taps) take 4 floats a lane and four taps
//     in flight instead, in chunks of 128 floats: taps and warps in flight
//     matter more there;
//   * the group's lanes load G taps of the row at a time, one index and one
//     weight each (coalesced), and hand them round with __shfl_sync; rows
//     with more than G taps loop over chunks of taps, rows with none write
//     zeros;
//   * lanes sweep the columns in coalesced steps (lane, lane + G, ...), so
//     4-byte loads and stores reach memory as whole 128-byte lines at any Q
//     and any base alignment.  Where Q is a multiple of 4 and both bases are
//     16-byte aligned the same kernel runs on float4 columns;
//   * the source (the rank-basis patch or the slit-window values, a few MB
//     per pointing) stays resident in the 50 MB L2 across a launch, so the
//     C-fold reuse of each source row is served from L2, not HBM.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gather_lanes.cuh"

namespace {

using gather_lanes::kThreads;
using gather_lanes::lane_fma;
using gather_lanes::lane_zero;

// Narrow rows: nvec <= 32 columns of V per row, one thread per (row, column),
// block (nvec, kThreads / nvec).  The threads of a row read the same index
// and weight, which the L1 broadcasts; taps are loaded four at a time before
// their FMAs.
template <typename V>
__global__ void __launch_bounds__(kThreads) gather_rows_narrow_kernel(
    const float* __restrict__ src, const int* __restrict__ row_ptr,
    const int* __restrict__ idx, const float* __restrict__ w,
    float* __restrict__ out, int n_rows, int nvec) {
  constexpr int kTaps = 4;
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= n_rows) return;
  const V* __restrict__ s = reinterpret_cast<const V*>(src) + threadIdx.x;
  const int k1 = __ldg(row_ptr + r + 1);
  int k = __ldg(row_ptr + r);
  V acc = lane_zero<V>();
  for (; k + kTaps <= k1; k += kTaps) {
    int i[kTaps];
    float wk[kTaps];
    V x[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      i[t] = __ldg(idx + k + t);
      wk[t] = __ldg(w + k + t);
    }
#pragma unroll
    for (int t = 0; t < kTaps; ++t) x[t] = __ldg(s + static_cast<long long>(i[t]) * nvec);
#pragma unroll
    for (int t = 0; t < kTaps; ++t) lane_fma(acc, wk[t], x[t]);
  }
  for (; k < k1; ++k)
    lane_fma(acc, __ldg(w + k), __ldg(s + static_cast<long long>(__ldg(idx + k)) * nvec));
  reinterpret_cast<V*>(out)[r * nvec + threadIdx.x] = acc;
}

// Wide rows: the lane-group row gather of gather_lanes.cuh on the CSR taps
// row_ptr[r] .. row_ptr[r + 1] of row r.  V = float4 (Q % 4 == 0, aligned
// bases) or float; nvec = Q / (sizeof(V) / 4) columns of V per row; g <= 32
// lanes per row, 32 / g rows per warp (the warp's other lanes idle); a lane
// holds kCols columns and loads kTaps taps of them before their FMAs.
template <typename V, int kCols, int kTaps>
__global__ void __launch_bounds__(kThreads, gather_lanes::lane_blocks_per_sm<V, kCols>()) gather_rows_kernel(
    const float* __restrict__ src, const int* __restrict__ row_ptr,
    const int* __restrict__ idx, const float* __restrict__ w,
    float* __restrict__ out, int n_rows, int nvec, int g) {
  gather_lanes::LaneGroup q;
  if (!gather_lanes::lane_group(g, n_rows, q)) return;
  const int k0 = __ldg(row_ptr + q.r);
  const int k1 = __ldg(row_ptr + q.r + 1);
  gather_lanes::gather_lane_row<V, kCols, kTaps>(src, idx, w, k0, k1, out, nvec, g, q);
}

template <typename V, int kCols, int kTaps>
int launch(const float* src, const int* row_ptr, const int* idx, const float* w, float* out,
           int n_rows, int nvec, int g, cudaStream_t st) {
  dim3 grid;
  if (!gather_lanes::lane_grid<kCols>(n_rows, nvec, g, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  gather_rows_kernel<V, kCols, kTaps>
      <<<grid, kThreads, 0, st>>>(src, row_ptr, idx, w, out, n_rows, nvec, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_narrow(const float* src, const int* row_ptr, const int* idx, const float* w, float* out,
                  int n_rows, int nvec, cudaStream_t st) {
  const dim3 block(nvec, kThreads / nvec);
  const long long gx = (static_cast<long long>(n_rows) + block.y - 1) / block.y;
  if (gx > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  gather_rows_narrow_kernel<V>
      <<<static_cast<unsigned>(gx), block, 0, st>>>(src, row_ptr, idx, w, out, n_rows, nvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [n_src, q], row_ptr [n_rows + 1], idx / w [nnz], out [n_rows, q]; all
// device pointers, f32 / int32, contiguous.  `vec` is 4 (float4 columns: q a
// multiple of 4, src and out 16-byte aligned) or 1; `group` the lanes per
// row, 1 to 32.  group = q / vec (a lane per column) runs the narrow kernel;
// else `cols * vec` are the floats a lane holds and `taps` the taps it loads
// at a time: 4 x 4, 8 x 2, 16 x 1 or 24 x 1.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int surfh_gather_rows_f32(const float* src, const int* row_ptr, const int* idx,
                                     const float* w, float* out, int n_rows, int q, int vec,
                                     int cols, int taps, int group, void* stream) {
  if (n_rows <= 0 || q <= 0) return static_cast<int>(cudaSuccess);
  if (group < 1 || group > 32 || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (q % 4 != 0 || reinterpret_cast<std::uintptr_t>(src) % 16 != 0 ||
                   reinterpret_cast<std::uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group * vec == q) {
    if (vec == 4) return launch_narrow<float4>(src, row_ptr, idx, w, out, n_rows, group, st);
    return launch_narrow<float>(src, row_ptr, idx, w, out, n_rows, group, st);
  }
#define SURFH_GATHER_CASE(V, C, T)                    \
  if (vec * 4 == sizeof(V) && cols == C && taps == T) \
    return launch<V, C, T>(src, row_ptr, idx, w, out, n_rows, q / vec, group, st);
  SURFH_GATHER_CASE(float4, 1, 4)
  SURFH_GATHER_CASE(float4, 2, 2)
  SURFH_GATHER_CASE(float4, 4, 1)
  SURFH_GATHER_CASE(float4, 6, 1)
  SURFH_GATHER_CASE(float, 4, 4)
  SURFH_GATHER_CASE(float, 8, 2)
  SURFH_GATHER_CASE(float, 16, 1)
  SURFH_GATHER_CASE(float, 24, 1)
#undef SURFH_GATHER_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
