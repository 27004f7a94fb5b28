// Banded spectral blur + beta-sum (the Sig.R operator) in the port's row
// layout, f32, both directions:
//
//   forward   out[m, k]       = sum_{b < B, j < LB} win[m, b*W + s_t + j] * blk[t, b*LB + j, k - t*TK]
//             (t = k / TK, s_t = starts[t]; win [M, B*W], out [M, K])
//   transpose out[m, b*W + l] = sum_{c < KB, s_t + c < K} y[m, s_t + c] * blk_t[t, c, b*TL + l - t*TL]
//             (t = l / TL, s_t = starts_t[t]; y [M, K], out [M, B*W])
//
// with M = S*A slit-window rows.  Replaces the TPU kernels of
// surfh_tpu/core/wblur_pallas.py: `_banded_kernel` (forward, launched by
// `wblur_sum_beta_banded` through `_banded_call`) and `_banded_kernel_2d`
// (transpose, launched by `wblur_sum_beta_t_banded`).  The host plans and
// their truncation masks are the reference's (core/wblur_banded.py); only
// the tiling of the work is this card's.  The TPU-only choices are dropped:
// no beta padding to the 8-row sublane (B is any width), no S*A padding to
// 128 lanes (M is any count), no slab DMA into VMEM and no padding of the
// input past its end: a slab that runs past the window (the transpose's
// KB rounded up to 128 beyond K) reads zeros, and a partial last tile
// writes only its valid columns.
//
// One GEMM per band tile, gathered on the fly: the A operand is the tile's
// slab of the input rows (B runs of LB columns at stride W forward, one run
// of KB columns transposed), the B operand the tile's re-laid table block,
// and the result columns go to the tile's place in the output (one run of
// TK columns forward, B runs of TL columns at stride W transposed).  Every
// output element belongs to exactly one tile, so there are no atomics and
// the sums repeat bit for bit.
//
// What bounds it on Hopper: FP32 FFMA throughput (no tensor cores: the accuracy
// contract is full f32, no TF32), with a 64 x 64 x 16 shared-memory tile
// giving 16 FMAs per float loaded from L2 / HBM; the tables and the window
// rows of one launch (a few tens of MB) stay in the 50 MB L2 across tiles.
// A plain first design: no cp.async pipeline, no wgmma, not yet measured
// against the FP32 roofline.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;   // rows of M per block
constexpr int kBN = 64;   // output columns of one tile per block
constexpr int kBK = 16;   // contraction step
constexpr int kThreads = 256;
constexpr int kTM = kBM / 16;  // rows per thread (strided by 16)
constexpr int kTN = kBN / 16;  // columns per thread (strided by 16)

struct BandedArgs {
  const float* a;       // input rows [M, lda]
  const float* blocks;  // re-laid table [n_tiles, kc, n]
  const int* starts;    // [n_tiles] slab offset of each tile
  float* out;           // output rows [M, ldc]
  int m, lda, ldc;
  int n_tiles, kc, n, n_col_blocks;
  int seg_in, stride_in, lim_in;     // slab: runs of seg_in at stride_in, valid below lim_in
  int seg_out, stride_out, lim_out;  // result: runs of seg_out at stride_out, valid below lim_out
};

// kTranspose = false: the slab is B runs, the result one run.
// kTranspose = true:  the slab is one run, the result B runs.
template <bool kTranspose>
__global__ void __launch_bounds__(kThreads) wblur_banded_kernel(const BandedArgs p) {
  __shared__ float as[kBK][kBM + 1];  // A tile, contraction-major (+1: no bank conflicts on store)
  __shared__ float bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int tile = blockIdx.y / p.n_col_blocks;
  const int n0 = (blockIdx.y % p.n_col_blocks) * kBN;
  const int s = __ldg(p.starts + tile);
  const float* __restrict__ blk = p.blocks + static_cast<long long>(tile) * p.kc * p.n;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < p.kc; c0 += kBK) {
    // A tile: kBM x kBK, consecutive threads on consecutive slab columns
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kBK;
      const int cc = e % kBK;
      const int c = c0 + cc;
      const int m = m0 + row;
      float v = 0.f;
      if (m < p.m && c < p.kc) {
        int col;
        bool ok;
        if (kTranspose) {
          col = s + c;
          ok = col < p.lim_in;
        } else {
          const int seg = c / p.seg_in;
          const int within = c - seg * p.seg_in;
          col = seg * p.stride_in + s + within;
          ok = s + within < p.lim_in;
        }
        if (ok) v = __ldg(p.a + static_cast<long long>(m) * p.lda + col);
      }
      as[cc][row] = v;
    }
    // B tile: kBK x kBN of the tile's block, consecutive threads on consecutive columns
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kBN;
      const int col = e % kBN;
      const int c = c0 + row;
      const int n = n0 + col;
      bs[row][col] = (c < p.kc && n < p.n)
                         ? __ldg(blk + static_cast<long long>(c) * p.n + n)
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= p.n) continue;
    int col;
    bool ok;
    if (kTranspose) {
      const int seg = n / p.seg_out;
      const int within = n - seg * p.seg_out;
      const int pos = tile * p.seg_out + within;
      col = seg * p.stride_out + pos;
      ok = pos < p.lim_out;
    } else {
      col = tile * p.seg_out + n;
      ok = col < p.lim_out;
    }
    if (!ok) continue;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < p.m) p.out[static_cast<long long>(m) * p.ldc + col] = acc[i][j];
    }
  }
}

template <bool kTranspose>
int launch(BandedArgs p, void* stream) {
  if (p.m <= 0 || p.n_tiles <= 0 || p.n <= 0) return static_cast<int>(cudaSuccess);
  p.n_col_blocks = (p.n + kBN - 1) / kBN;
  const long long gy = static_cast<long long>(p.n_tiles) * p.n_col_blocks;
  const long long gx = (p.m + kBM - 1) / kBM;
  if (gy > 65535 || gx > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  wblur_banded_kernel<kTranspose>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward.  win [m, b*w], blocks [n_tiles, b*lb, tk], starts [n_tiles],
// out [m, k]; device pointers, f32 / int32, contiguous.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (0 = launched).
extern "C" int surfh_wblur_banded_f32(const float* win, const float* blocks, const int* starts,
                                      float* out, int m, int w, int b, int k, int n_tiles,
                                      int lb, int tk, void* stream) {
  BandedArgs p{};
  p.a = win;
  p.blocks = blocks;
  p.starts = starts;
  p.out = out;
  p.m = m;
  p.lda = b * w;
  p.ldc = k;
  p.n_tiles = n_tiles;
  p.kc = b * lb;
  p.n = tk;
  p.seg_in = lb;
  p.stride_in = w;
  p.lim_in = w;
  p.seg_out = tk;
  p.stride_out = 0;
  p.lim_out = k;
  return launch<false>(p, stream);
}

// Transpose.  y [m, k], blocks_t [n_tiles, kb, b*tl], starts_t [n_tiles],
// out [m, b*w]; same conventions.
extern "C" int surfh_wblur_banded_t_f32(const float* y, const float* blocks_t,
                                        const int* starts_t, float* out, int m, int w, int b,
                                        int k, int n_tiles, int tl, int kb, void* stream) {
  BandedArgs p{};
  p.a = y;
  p.blocks = blocks_t;
  p.starts = starts_t;
  p.out = out;
  p.m = m;
  p.lda = k;
  p.ldc = b * w;
  p.n_tiles = n_tiles;
  p.kc = kb;
  p.n = b * tl;
  p.seg_in = kb;
  p.stride_in = 0;
  p.lim_in = k;
  p.seg_out = tl;
  p.stride_out = w;
  p.lim_out = w;
  return launch<true>(p, stream);
}
