// The lane-group row gather (f32), shared by the CSR kernel of
// gather_rows.cu and the padded-table kernel K2 of gather_fixed.cu:
//
//     out[r, :] = sum_{k in [k0, k1)} w[k] * src[idx[k], :]
//
// for one output row r, given where the row's taps lie and what their
// indices hold.  The kernels differ only in that: CSR taps at row_ptr[r] ..
// row_ptr[r + 1] of the tap arrays, K2's at 0 .. cnt[r] and K1's at 0 .. L of
// row r of the [Pp, L] table, all three as source rows (the V offset is
// idx * nvec); K3's at 0 .. L of its table of offsets pre-scaled to floats
// (idx = row * W, so the V offset is idx / (floats of V), exact: W is a
// multiple of them).
//
// A power-of-two group of g <= 32 lanes owns the row, 32 / g rows to a warp.
// The group's lanes load g taps at a time, one index and one weight each
// (coalesced), and hand them round with __shfl_sync; a lane holds kCols
// columns of V (float4 or float) of the row in registers, loads kTaps taps
// of them before their FMAs, and the lanes sweep the columns in coalesced
// steps (lane, lane + g, ...).  A row's fixed chain (tap range, taps, source,
// store) is paid once per row and no index is divided.  Taps are summed in
// the order they lie in; nothing of `src` is read for a tap outside [k0, k1);
// a row without taps writes zeros.

#pragma once

#include <cuda_runtime.h>

namespace gather_lanes {

constexpr int kThreads = 256;  // threads of a block of either kernel

__device__ __forceinline__ void lane_fma(float4& acc, float wk, const float4& x) {
  acc.x = fmaf(wk, x.x, acc.x);
  acc.y = fmaf(wk, x.y, acc.y);
  acc.z = fmaf(wk, x.z, acc.z);
  acc.w = fmaf(wk, x.w, acc.w);
}

__device__ __forceinline__ void lane_fma(float2& acc, float wk, const float2& x) {
  acc.x = fmaf(wk, x.x, acc.x);
  acc.y = fmaf(wk, x.y, acc.y);
}

__device__ __forceinline__ void lane_fma(float& acc, float wk, float x) {
  acc = fmaf(wk, x, acc);
}

template <typename V>
__device__ __forceinline__ V lane_zero();
template <>
__device__ __forceinline__ float4 lane_zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float2 lane_zero<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ float lane_zero<float>() { return 0.f; }

// Blocks per SM of the lane-group kernels: four (64 registers); five at 8
// floats a lane (51 registers, 8 bytes spilled): on rows of up to 256 floats
// the blocks in flight count for more.
template <typename V, int kCols>
constexpr int lane_blocks_per_sm() { return kCols * sizeof(V) == 32 ? 5 : 4; }

// What a tap index holds: a source row, or (K3) the row's offset in floats.
enum class TapIndex { kRow, kFloats };

template <typename V, TapIndex kIndex>
__device__ __forceinline__ long long tap_offset(int i, int nvec) {
  if constexpr (kIndex == TapIndex::kRow) {
    return static_cast<long long>(i) * nvec;
  } else {
    return static_cast<long long>(static_cast<unsigned>(i) / (sizeof(V) / 4));
  }
}

// This thread's place: its group's row r (from the block, warp and lane
// index: grid x = chunks of kCols * g columns, so the blocks that write one
// row run together; y and z = groups of (kThreads / 32) * (32 / g) rows), the
// group's first lane in the warp, the thread's lane in the group, and the
// mask of the group's lanes (the shuffles involve no other).  False for the
// warp's idle lanes (32 % g) and for rows >= n_rows: a whole group leaves
// together.
struct LaneGroup {
  long long r;
  int first, lane;
  unsigned mask;
};

__device__ __forceinline__ bool lane_group(int g, int n_rows, LaneGroup& q) {
  const int rows_per_warp = 32 / g;
  const int sub = (threadIdx.x & 31) / g;  // this lane's group within its warp
  if (sub >= rows_per_warp) return false;
  q.first = sub * g;
  q.lane = (threadIdx.x & 31) - q.first;
  const long long warp = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * (kThreads / 32) +
                         (threadIdx.x >> 5);
  q.r = warp * rows_per_warp + sub;
  if (q.r >= n_rows) return false;
  q.mask = (g == 32 ? 0xffffffffu : (1u << g) - 1u) << q.first;
  return true;
}

// Row q.r of `out` from the taps idx / w [k0, k1).  V = float4 (Q % 4 == 0,
// 16-byte aligned bases), float2 (K1 / K3: Q % 2 == 0, 8-byte aligned) or
// float; nvec = Q / (sizeof(V) / 4) columns of V per row.
// kHold (K1 / K3, one tap at a time): the lane keeps the last source row's
// columns and loads them again only for a tap of another source row.  A
// padded row's trailing taps all name row 0, so it loads src[0] once, not
// once per padded tap; every tap's FMA still runs on the same values, so the
// sum is the same for any table.
template <typename V, int kCols, int kTaps, TapIndex kIndex = TapIndex::kRow, bool kHold = false>
__device__ __forceinline__ void gather_lane_row(
    const float* __restrict__ src, const int* __restrict__ idx, const float* __restrict__ w,
    int k0, int k1, float* __restrict__ out, int nvec, int g, const LaneGroup& q) {
  const int first = q.first;
  const int lane = q.lane;
  const unsigned mask = q.mask;
  const int c0 = blockIdx.x * (kCols * g) + lane;  // this lane's first column
  const V* __restrict__ s = reinterpret_cast<const V*>(src) + c0;

  V acc[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) acc[u] = lane_zero<V>();
  static_assert(!kHold || kTaps == 1, "kHold loads one tap at a time");
  [[maybe_unused]] V held[kHold ? kCols : 1];  // kHold: the columns of source offset `held_off`
  [[maybe_unused]] long long held_off = -1;

  for (int kc = k0; kc < k1; kc += g) {  // g taps at a time, in table order
    int my_i = 0;
    float my_w = 0.f;
    if (kc + lane < k1) {
      my_i = __ldg(idx + kc + lane);
      my_w = __ldg(w + kc + lane);
    }
    const int n = min(g, k1 - kc);
    if constexpr (kHold) {
      for (int j = 0; j < n; ++j) {
        const long long off = tap_offset<V, kIndex>(__shfl_sync(mask, my_i, first + j), nvec);
        const float wj = __shfl_sync(mask, my_w, first + j);
        if (off != held_off) {  // the group's lanes agree: one branch for the group
#pragma unroll
          for (int u = 0; u < kCols; ++u)
            held[u] = c0 + u * g < nvec ? __ldg(s + off + u * g) : lane_zero<V>();
          held_off = off;
        }
#pragma unroll
        for (int u = 0; u < kCols; ++u) lane_fma(acc[u], wj, held[u]);
      }
      continue;
    }
    int j = 0;
    for (; j + kTaps <= n; j += kTaps) {
      long long off[kTaps];
      float wj[kTaps];
      V x[kTaps][kCols];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        off[t] = tap_offset<V, kIndex>(__shfl_sync(mask, my_i, first + j + t), nvec);
        wj[t] = __shfl_sync(mask, my_w, first + j + t);
      }
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          x[t][u] = c0 + u * g < nvec ? __ldg(s + off[t] + u * g) : lane_zero<V>();
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
#pragma unroll
        for (int u = 0; u < kCols; ++u) lane_fma(acc[u], wj[t], x[t][u]);
    }
    for (; j < n; ++j) {
      const long long off = tap_offset<V, kIndex>(__shfl_sync(mask, my_i, first + j), nvec);
      const float wj = __shfl_sync(mask, my_w, first + j);
      V x[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        x[u] = c0 + u * g < nvec ? __ldg(s + off + u * g) : lane_zero<V>();
#pragma unroll
      for (int u = 0; u < kCols; ++u) lane_fma(acc[u], wj, x[u]);
    }
  }

  V* __restrict__ o = reinterpret_cast<V*>(out) + q.r * nvec + c0;
#pragma unroll
  for (int u = 0; u < kCols; ++u)
    if (c0 + u * g < nvec) o[u * g] = acc[u];
}

// The grid of a lane-group launch over n_rows rows of nvec columns; false
// where it does not fit.
template <int kCols>
inline bool lane_grid(int n_rows, int nvec, int g, dim3* grid) {
  const long long rows_per_block = (kThreads / 32) * (32 / g);
  const long long row_groups = (n_rows + rows_per_block - 1) / rows_per_block;
  const long long per_chunk = static_cast<long long>(kCols) * g;
  const long long gx = (nvec + per_chunk - 1) / per_chunk;
  const long long gy = row_groups < 32768 ? row_groups : 32768;
  const long long gz = (row_groups + gy - 1) / gy;
  if (gx > 2147483647LL || gz > 65535) return false;
  *grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(gz));
  return true;
}

}  // namespace gather_lanes
