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
// block, no static L, and no four-row unroll in K3 (the TPU scalar unit's
// instruction-level parallelism; here the taps in flight give it).  The row
// padding to Pp is kept only because the host plan is the prototype's.
//
// What bounds them on Hopper: bytes, not arithmetic.  The work the inputs
// need is nnz taps (the CSR count, not Pp * L): the output P * W * 4 bytes
// written once, the source n_src * W * 4 read once, the taps nnz * 8 and the
// row pointers (P + 1) * 4 bytes -- 60.2 MB, 18.0 us at 3.35 TB/s for band
// 1c at Q = W -- for 2 flops per tap and float, about 0.5 flop per byte.
// The padded table K1 and K3 read is Pp * L * 8 bytes more (3.05 MB on band
// 1c, about 0.9 us).  What the design does about it:
//   * the source block (a few MB per pointing) stays resident in the 50 MB
//     L2, so the C-fold reuse of its rows, and the padded taps of K1 and K3
//     (Pp * L against nnz, every one a read of src[0]), cost L2 / L1
//     traffic, not device-memory traffic;
//   * the output is written once, in coalesced runs, with no padded leading
//     dimension, so no padded copy of the source or the output;
//   * the composed transposes have about one tap per row and half their rows
//     empty, so a thread per (row, slice) is bound by instructions per byte
//     (an index division, the taps, a load and a store for 4 bytes at odd
//     W), not by bytes.  All three kernels run the lane-group row gather of
//     gather_lanes.cuh instead, the CSR kernel's: a power-of-two group of
//     lanes owns a row, lane j loads tap j of the row (at table stride L)
//     once and the group hands the taps round by shuffle, a lane holds 8 /
//     16 / 24 floats of the row (4 floats x 4 taps on rows of many taps), and
//     the row's fixed chain is paid once per row.  The three differ only in
//     the taps they sum and how an index reads: K1 taps 0 .. L, K2 taps 0 ..
//     cnt[r], both source rows; K3 taps 0 .. L as offsets in floats.  K2's
//     shape comes from gather_rows.gather_launch_shape (W, the bases'
//     alignment, the plan's nnz / P); K1's and K3's from
//     gather_fixed.fixed_launch_shape: one chunk of the row at 8 / 16 (24
//     as float4) floats a lane on 16 lanes where they hold it, else 32,
//     float2 columns where W is even but not a multiple of 4.  Rows of at most 32 columns
//     keep a thread per (row, slice), in a two-dimensional block (x = slice,
//     y = row) that divides no index.
//   * K1 and K3 sum all L = 7 taps of a row of which about one is real, and
//     at odd W a lane's 16 columns take 16 load instructions a tap: loads,
//     not bytes, set their time.  They take one tap at a time
//     and keep the last source row's columns in registers (kHold of
//     gather_lanes.cuh), so a row's run of padded taps, all at row 0, loads
//     src[0] once.  Every tap's FMA still runs in table order, so a padded
//     tap multiplies src[0] by zero: a non-finite src[0] turns K1's and K3's
//     rows NaN, as the TPU prototypes' do.  K2 reads nothing of src for a
//     tap at or past cnt[r].

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gather_lanes.cuh"

namespace {

using gather_lanes::TapIndex;

constexpr int kThreads = 256;
constexpr int kTapBatch = 4;  // the narrow kernels' loads in flight
static_assert(kThreads == gather_lanes::kThreads, "K2's wide kernel runs gather_lanes.cuh's blocks");

__device__ __forceinline__ void fma_acc(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}
__device__ __forceinline__ void fma_acc(float& acc, float w, float x) { acc = fmaf(w, x, acc); }

template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ float4 zero_of<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }

// K2, rows of at most 32 columns of V: one thread per (row, V slice), block
// (nvec, kThreads / nvec); exactly cnt[r] taps at table stride L.
template <typename V>
__global__ void __launch_bounds__(kThreads) k2_narrow_kernel(
    const float* __restrict__ src, const int* __restrict__ tsrc, const float* __restrict__ tw,
    const int* __restrict__ cnt, float* __restrict__ out, int n_rows, int L, int nvec) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= n_rows) return;
  const V* __restrict__ s = reinterpret_cast<const V*>(src) + threadIdx.x;
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
  reinterpret_cast<V*>(out)[r * nvec + threadIdx.x] = acc;
}

// K2, wide rows: the lane-group row gather on taps 0 .. cnt[r] of row r of
// the [Pp, L] table.  g <= 32 lanes per row; a lane holds kCols columns of V
// and loads kTaps taps of them before their FMAs.
template <typename V, int kCols, int kTaps>
__global__ void __launch_bounds__(kThreads, gather_lanes::lane_blocks_per_sm<V, kCols>()) k2_kernel(
    const float* __restrict__ src, const int* __restrict__ tsrc, const float* __restrict__ tw,
    const int* __restrict__ cnt, float* __restrict__ out, int n_rows, int L, int nvec, int g) {
  gather_lanes::LaneGroup q;
  if (!gather_lanes::lane_group(g, n_rows, q)) return;
  gather_lanes::gather_lane_row<V, kCols, kTaps>(src, tsrc + q.r * L, tw + q.r * L, 0,
                                                 __ldg(cnt + q.r), out, nvec, g, q);
}

// K1 and K3, rows of at most 32 columns of V: one thread per (row, V slice),
// block (nvec, kThreads / nvec); all L taps of row r, loads before FMAs (K2's
// narrow kernel above, on all L taps; that one is left as it is, so that its
// SASS stays what it was).
template <typename V, TapIndex kIndex>
__device__ __forceinline__ void fixed_narrow_row(
    const float* __restrict__ src, const int* __restrict__ tsrc, const float* __restrict__ tw,
    float* __restrict__ out, int n_rows, int L, int nvec) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= n_rows) return;
  const V* __restrict__ s = reinterpret_cast<const V*>(src) + threadIdx.x;
  const int* ti = tsrc + r * L;
  const float* wi = tw + r * L;
  V acc = zero_of<V>();
  int l = 0;
  for (; l + kTapBatch <= L; l += kTapBatch) {
    long long off[kTapBatch];
    float w[kTapBatch];
    V x[kTapBatch];
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) {
      off[j] = gather_lanes::tap_offset<V, kIndex>(__ldg(ti + l + j), nvec);
      w[j] = __ldg(wi + l + j);
    }
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) x[j] = __ldg(s + off[j]);
#pragma unroll
    for (int j = 0; j < kTapBatch; ++j) fma_acc(acc, w[j], x[j]);
  }
  for (; l < L; ++l)
    fma_acc(acc, __ldg(wi + l), __ldg(s + gather_lanes::tap_offset<V, kIndex>(__ldg(ti + l), nvec)));
  reinterpret_cast<V*>(out)[r * nvec + threadIdx.x] = acc;
}

template <typename V>
__global__ void __launch_bounds__(kThreads) k1_narrow_kernel(
    const float* __restrict__ src, const int* __restrict__ tsrc, const float* __restrict__ tw,
    float* __restrict__ out, int n_rows, int L, int nvec) {
  fixed_narrow_row<V, TapIndex::kRow>(src, tsrc, tw, out, n_rows, L, nvec);
}

template <typename V>
__global__ void __launch_bounds__(kThreads) k3_narrow_kernel(
    const float* __restrict__ src, const int* __restrict__ off, const float* __restrict__ tw,
    float* __restrict__ out, int n_rows, int L, int nvec) {
  fixed_narrow_row<V, TapIndex::kFloats>(src, off, tw, out, n_rows, L, nvec);
}

// Blocks per SM of K1 / K3's lane instances: gather_lanes.cuh's, but three
// (85 registers) at 24 floats a lane, which holds the row's 24 sums and the
// held source row's 24 floats: at four blocks (64 registers) it spills.
template <typename V, int kCols>
constexpr int fixed_blocks_per_sm() {
  return kCols * sizeof(V) == 96 ? 3 : gather_lanes::lane_blocks_per_sm<V, kCols>();
}

// K1, wide rows: the lane-group row gather on all L taps of row r of the
// [Pp, L] table, source rows.  V = float4, float2 or float.
template <typename V, int kCols, int kTaps>
__global__ void __launch_bounds__(kThreads, fixed_blocks_per_sm<V, kCols>()) k1_kernel(
    const float* __restrict__ src, const int* __restrict__ tsrc, const float* __restrict__ tw,
    float* __restrict__ out, int n_rows, int L, int nvec, int g) {
  gather_lanes::LaneGroup q;
  if (!gather_lanes::lane_group(g, n_rows, q)) return;
  gather_lanes::gather_lane_row<V, kCols, kTaps, TapIndex::kRow, true>(
      src, tsrc + q.r * L, tw + q.r * L, 0, L, out, nvec, g, q);
}

// K3, wide rows: K1's sum, the taps read as offsets in floats (tsrc * W).
template <typename V, int kCols, int kTaps>
__global__ void __launch_bounds__(kThreads, fixed_blocks_per_sm<V, kCols>()) k3_kernel(
    const float* __restrict__ src, const int* __restrict__ off, const float* __restrict__ tw,
    float* __restrict__ out, int n_rows, int L, int nvec, int g) {
  gather_lanes::LaneGroup q;
  if (!gather_lanes::lane_group(g, n_rows, q)) return;
  gather_lanes::gather_lane_row<V, kCols, kTaps, TapIndex::kFloats, true>(
      src, off + q.r * L, tw + q.r * L, 0, L, out, nvec, g, q);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<std::uintptr_t>(p) % bytes == 0; }

template <typename V>
int launch_k2_narrow(const float* src, const int* tsrc, const float* tw, const int* cnt, float* out,
                     int n_rows, int L, int nvec, cudaStream_t st) {
  const dim3 block(nvec, kThreads / nvec);
  const long long gx = (static_cast<long long>(n_rows) + block.y - 1) / block.y;
  if (gx > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  k2_narrow_kernel<V><<<static_cast<unsigned>(gx), block, 0, st>>>(src, tsrc, tw, cnt, out, n_rows, L, nvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, int kCols, int kTaps>
int launch_k2(const float* src, const int* tsrc, const float* tw, const int* cnt, float* out,
              int n_rows, int L, int nvec, int g, cudaStream_t st) {
  dim3 grid;
  if (!gather_lanes::lane_grid<kCols>(n_rows, nvec, g, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  k2_kernel<V, kCols, kTaps><<<grid, kThreads, 0, st>>>(src, tsrc, tw, cnt, out, n_rows, L, nvec, g);
  return static_cast<int>(cudaGetLastError());
}

// K1 (kIndex = kRow) or K3 (kFloats) in the shape (vec, cols, taps, group)
// that gather_fixed.fixed_launch_shape picks.
template <TapIndex kIndex>
int launch_fixed(const float* src, const int* tsrc, const float* tw, float* out, int n_rows, int L,
                 int q, int vec, int cols, int taps, int group, cudaStream_t st) {
  if (n_rows <= 0 || q <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0 || group < 1 || group > 32 || (vec != 1 && vec != 2 && vec != 4) || q % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(src, 4 * vec) || !aligned(out, 4 * vec)) return static_cast<int>(cudaErrorMisalignedAddress);
  const int nvec = q / vec;
  if (group * vec == q && vec != 2) {
    const dim3 block(group, kThreads / group);
    const long long gx = (static_cast<long long>(n_rows) + block.y - 1) / block.y;
    if (gx > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (vec == 4) {
      (kIndex == TapIndex::kRow ? k1_narrow_kernel<float4> : k3_narrow_kernel<float4>)
          <<<static_cast<unsigned>(gx), block, 0, st>>>(src, tsrc, tw, out, n_rows, L, nvec);
    } else {
      (kIndex == TapIndex::kRow ? k1_narrow_kernel<float> : k3_narrow_kernel<float>)
          <<<static_cast<unsigned>(gx), block, 0, st>>>(src, tsrc, tw, out, n_rows, L, nvec);
    }
    return static_cast<int>(cudaGetLastError());
  }
#define SURFH_FIXED_CASE(V, C, T)                                                        \
  if (vec * 4 == sizeof(V) && cols == C && taps == T) {                                  \
    dim3 grid;                                                                           \
    if (!gather_lanes::lane_grid<C>(n_rows, nvec, group, &grid))                         \
      return static_cast<int>(cudaErrorInvalidConfiguration);                            \
    (kIndex == TapIndex::kRow ? k1_kernel<V, C, T> : k3_kernel<V, C, T>)                 \
        <<<grid, kThreads, 0, st>>>(src, tsrc, tw, out, n_rows, L, nvec, group);         \
    return static_cast<int>(cudaGetLastError());                                         \
  }
  SURFH_FIXED_CASE(float4, 2, 1)
  SURFH_FIXED_CASE(float4, 4, 1)
  SURFH_FIXED_CASE(float4, 6, 1)
  SURFH_FIXED_CASE(float2, 4, 1)
  SURFH_FIXED_CASE(float2, 8, 1)
  SURFH_FIXED_CASE(float, 8, 1)
  SURFH_FIXED_CASE(float, 16, 1)
#undef SURFH_FIXED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// All pointers are device pointers, f32 / int32, contiguous: src [n_src, q],
// tsrc / off / tw [Pp, L] (Pp >= n_rows), cnt [Pp], out [n_rows, q]; K3's
// off = tsrc * q.  Each launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 = launched); L <= 0 or a shape it does not
// have returns cudaErrorInvalidValue.  All three take their launch shape as
// the CSR kernel of gather_rows.cu does: `vec` 4 (float4 columns: q a
// multiple of 4, src and out 16-byte aligned) or 1, `group` the lanes per
// row; group = q / vec (a lane per column, at most 32) runs the narrow
// kernel, else `cols * vec` are the floats a lane holds and `taps` the taps
// it loads at a time: 4 x 4, 8 x 2, 16 x 1 or 24 x 1 for K2; K1 / K3 load one
// tap at a time, 8 or 16 floats a lane (24 as float4), and also take `vec` 2
// (float2 columns: q even, bases 8-byte aligned) on wide rows.
extern "C" int surfh_gather_fixed_k1_f32(const float* src, const int* tsrc, const float* tw,
                                         float* out, int n_rows, int L, int q, int vec, int cols,
                                         int taps, int group, void* stream) {
  return launch_fixed<TapIndex::kRow>(src, tsrc, tw, out, n_rows, L, q, vec, cols, taps, group,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int surfh_gather_fixed_k2_f32(const float* src, const int* tsrc, const float* tw,
                                         const int* cnt, float* out, int n_rows, int L, int q,
                                         int vec, int cols, int taps, int group, void* stream) {
  if (n_rows <= 0 || q <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0 || group < 1 || group > 32 || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (q % 4 != 0 || !aligned(src, 16) || !aligned(out, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group * vec == q) {
    if (vec == 4) return launch_k2_narrow<float4>(src, tsrc, tw, cnt, out, n_rows, L, group, st);
    return launch_k2_narrow<float>(src, tsrc, tw, cnt, out, n_rows, L, group, st);
  }
#define SURFH_K2_CASE(V, C, T)                        \
  if (vec * 4 == sizeof(V) && cols == C && taps == T) \
    return launch_k2<V, C, T>(src, tsrc, tw, cnt, out, n_rows, L, q / vec, group, st);
  SURFH_K2_CASE(float4, 1, 4)
  SURFH_K2_CASE(float4, 2, 2)
  SURFH_K2_CASE(float4, 4, 1)
  SURFH_K2_CASE(float4, 6, 1)
  SURFH_K2_CASE(float, 4, 4)
  SURFH_K2_CASE(float, 8, 2)
  SURFH_K2_CASE(float, 16, 1)
  SURFH_K2_CASE(float, 24, 1)
#undef SURFH_K2_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int surfh_gather_fixed_k3_f32(const float* src, const int* off, const float* tw,
                                         float* out, int n_rows, int L, int q, int vec, int cols,
                                         int taps, int group, void* stream) {
  return launch_fixed<TapIndex::kFloats>(src, off, tw, out, n_rows, L, q, vec, cols, taps, group,
                                         static_cast<cudaStream_t>(stream));
}
