// The normal of the quadratic criterion with the separated prior, in one
// pass (f32):
//
//     out[b,i,j] = mu_s * h[b,i,j]
//                + mu_r * ((((4 x[b,i,j] - x[b,i-1,j]) - x[b,i+1,j]) - x[b,i,j-1]) - x[b,i,j+1])
//
// over contiguous [B, H, W] tensors, the indices circular within each
// [H, W] plane: Q x = mu_s HᵗH x + mu_r DᵀD x with h = HᵗH x already
// computed (solvers/criterion.py::QuadCriterion_MRS.normal_op).
//
// Replaces no TPU kernel: the JAX package leaves this combine to XLA,
// which fuses it.  Eager PyTorch spells it as twelve kernels (four rolls,
// four subtractions, 4 x, two scalings, the add) that move about 29
// volumes of the cube; this pass moves three (x and h read, out written).
// The arithmetic is the eager chain's, operation for operation and in its
// order, with round-to-nearest intrinsics that nvcc cannot contract into
// an FMA: the result equals the eager one bit for bit.
//
// What bounds it on Hopper: device-memory bytes, 12 a voxel for 8 flops
// (on the H100, 3.81 ms on the [3879, 501, 501] cube: 91.5 % of the bound).
// The design keeps x's reads to one from DRAM and h / out wide:
//   * a block takes a strip of rows [i0, i1) of one plane (at most `rows`,
//     the wrapper's launch_rows: at most 8189 floats, 16 rows of the
//     cube's 501), balanced over the plane's strips.  The strip is one contiguous run of the
//     flat tensor, so h and out go as float4 on the flat index wherever
//     both bases are 16-byte aligned (scalar at the run's ragged ends and
//     otherwise), with streaming (evict-first) hints: neither is read again;
//   * x's strip plus one halo row above and below (the rows i0 - 1 and i1,
//     wrapped within the plane) is staged in shared memory by cp.async, a
//     float a copy, coalesced: a thread starts all its copies before it
//     waits for one (plain loads, each stored before the next, keep one
//     load in flight a thread: 71 % of the bound on the H100).  The halo
//     rows are the neighbouring strips' own rows, which their blocks (the
//     next block indices) load at about the same time, so they come from L2;
//   * the shared window is skewed by one float every 32 (s[p + p / 32]):
//     a thread owns four consecutive voxels, so unskewed its loads would
//     meet four-way bank conflicts;
//   * each thread loads its h first (eight float4 in registers), then the
//     block fills the window, so both streams are in flight together.
//
// Launches on `stream`, allocates nothing, does not synchronise.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 8;                                // float4 groups a thread owns
constexpr int kStripFloats = kThreads * kGroups * 4 - 3;  // a strip's floats with its ragged ends
constexpr int kSmemFloats = 48 * 1024 / 4;                // the window, skewed, in 48 KB

__host__ __device__ inline int skewed(int p) { return p + (p >> 5); }

__host__ inline int window_floats(int rows, int w) { return skewed((rows + 2) * w); }

// one float, global to shared, without a register: cp.async (Ampere and later)
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ float lap_at(const float* __restrict__ s, int t, int j, int w) {
  // the strip's voxel t (column j) sits at window position w + t; the row
  // above at t, below at 2w + t; the column wrap stays in the row
  const float c = s[skewed(w + t)];
  const float up = s[skewed(t)];
  const float dn = s[skewed(2 * w + t)];
  const float lf = s[skewed(j == 0 ? 2 * w + t - 1 : w + t - 1)];
  const float rt = s[skewed(j == w - 1 ? t + 1 : w + t + 1)];
  float v = __fmul_rn(4.0f, c);
  v = __fsub_rn(v, up);
  v = __fsub_rn(v, dn);
  v = __fsub_rn(v, lf);
  return __fsub_rn(v, rt);
}

__device__ __forceinline__ float combine(float ms, float hv, float mr, float lap) {
  return __fadd_rn(__fmul_rn(ms, hv), __fmul_rn(mr, lap));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
normal_prior_kernel(const float* __restrict__ x, const float* __restrict__ h,
                    const float* __restrict__ mu_s, const float* __restrict__ mu_r,
                    float* __restrict__ out, int hgt, int w, int strips) {
  extern __shared__ float s[];
  const long long plane = static_cast<long long>(hgt) * w;
  const long long b = blockIdx.x / strips;
  const int strip = blockIdx.x - static_cast<int>(b) * strips;
  const int i0 = static_cast<int>(static_cast<long long>(strip) * hgt / strips);
  const int i1 = static_cast<int>(static_cast<long long>(strip + 1) * hgt / strips);
  const int n = (i1 - i0) * w;                   // the strip's floats
  const long long fs = b * plane + static_cast<long long>(i0) * w;  // its flat start
  const long long g0 = fs >> 2;                  // its first flat group of four

  // 1. h: this thread's groups, in registers
  float4 hv[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int t = static_cast<int>((g0 + threadIdx.x + k * kThreads) * 4 - fs);
    if (t >= n) {
      hv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (kVec && t >= 0 && t + 4 <= n) {
      hv[k] = __ldcs(reinterpret_cast<const float4*>(h + fs + t));
    } else {
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) e[q] = (t + q >= 0 && t + q < n) ? __ldcs(h + fs + t + q) : 0.f;
      hv[k] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }

  // 2. x's window: halo row above, the strip, halo row below, as
  // asynchronous copies, all started before the first is awaited
  const float* xp = x + b * plane;
  const float* up = xp + static_cast<long long>((i0 + hgt - 1) % hgt) * w;
  const float* dn = xp + static_cast<long long>(i1 % hgt) * w;
  for (int j = threadIdx.x; j < w; j += kThreads) {
    copy_async(s + skewed(j), up + j);
    copy_async(s + skewed(w + n + j), dn + j);
  }
  const float* xs = x + fs;
  for (int t = threadIdx.x; t < n; t += kThreads) copy_async(s + skewed(w + t), xs + t);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 3. combine and store
  const float ms = __ldg(mu_s), mr = __ldg(mu_r);
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int t = static_cast<int>((g0 + threadIdx.x + k * kThreads) * 4 - fs);
    if (t >= n) continue;
    const float hk[4] = {hv[k].x, hv[k].y, hv[k].z, hv[k].w};
    if (t >= 0 && t + 4 <= n) {
      float o[4];
      int j = t % w;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[q] = combine(ms, hk[q], mr, lap_at(s, t + q, j, w));
        j = (j + 1 == w) ? 0 : j + 1;
      }
      if (kVec) {
        __stcs(reinterpret_cast<float4*>(out + fs + t), make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) __stcs(out + fs + t + q, o[q]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int tq = t + q;
        if (tq >= 0 && tq < n) __stcs(out + fs + tq, combine(ms, hk[q], mr, lap_at(s, tq, tq % w, w)));
      }
    }
  }
}

}  // namespace

// x, h, out [B, H, W] f32 contiguous, mu_s / mu_r one f32 each; all device
// pointers, out not overlapping x or h.  `rows` is the most rows of a plane
// one block takes, as core/normal_prior.py::launch_rows sizes it (1 <= rows
// <= H, rows * W <= 8189, its window of rows + 2 rows within 48 KB skewed);
// other values are refused.
// h and out go as float4 where both are 16-byte aligned.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 =
// launched).
extern "C" int surfh_normal_prior_f32(const float* x, const float* h, const float* mu_s,
                                      const float* mu_r, float* out, long long nb, int hgt, int w,
                                      int rows, void* stream) {
  if (nb <= 0 || hgt <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (rows < 1 || rows > hgt || static_cast<long long>(rows) * w > kStripFloats ||
      window_floats(rows, w) > kSmemFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (hgt + rows - 1) / rows;
  const long long blocks = nb * strips;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = reinterpret_cast<std::uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const size_t smem = static_cast<size_t>(window_floats(rows, w)) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    normal_prior_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
        x, h, mu_s, mu_r, out, hgt, w, strips);
  else
    normal_prior_kernel<false><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
        x, h, mu_s, mu_r, out, hgt, w, strips);
  return static_cast<int>(cudaGetLastError());
}
