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
// input past its end.
//
// What bounds both on Hopper: FP32 FFMA throughput.  No tensor cores: the
// accuracy contract is full f32, no TF32.  The tables and the window rows of
// one launch (a few tens of MB) stay in the 50 MB L2 across tiles, so device
// memory is not the limit; the work per launch is 0.9-1.6 GFLOP against
// 67 TFLOP/s, tens of microseconds, so the card has to be full for all of
// them.
//
// The forward (wblur_banded_fwd_kernel) is one GEMM per lambda'-tile,
// gathered on the fly: the A operand is B runs of LB window columns at
// stride W, the B operand the tile's re-laid [B*LB, TK] block.
//   * Enough blocks on every band: M = 336-408 rows and 5-11 tiles give only
//     30-77 blocks of 64 x 128, so the contraction is split over the B runs
//     (blockIdx.z takes the runs [z*B/split, (z+1)*B/split)).  The wrapper
//     picks the split from (M, tiles, B, LB) and the card's SM count.  Each
//     part writes its partial sums to its own [M, K] slab of a scratch buffer
//     and a second kernel adds the slabs in the order 0, 1, ..., split-1:
//     no atomics anywhere, so the sums repeat bit for bit.  split = 1 writes
//     the output directly.
//   * More arithmetic per shared-memory load: 128 threads, each an 8 x 8
//     register tile read as four 16-byte shared-memory loads per contraction
//     term (A is stored contraction-major so a thread's rows are contiguous):
//     4 LDS.128 for 64 FFMA.  The 8 rows / columns are two groups of 4, half
//     a tile apart, and a warp covers 32 x 64 of the tile, so its 16-byte
//     loads fall on distinct banks of one 128-byte span.
//   * Loads that overlap the arithmetic: a ring of kStages stages of 8
//     contraction terms, filled with cp.async one to three steps ahead, one
//     __syncthreads() per step.  The table rows are 16-byte aligned (TK is a
//     multiple of 4): 16-byte copies.  The window slab is not (starts[t] is
//     any integer, W and B*W may be odd): 4-byte copies, transposed on the
//     way into shared memory.  25 KB of shared memory and 145 registers
//     (none spilled; capped at 128 the compiler spills and shuffles the
//     accumulators): three blocks per SM.
//   * Ragged edges: rows m >= M, terms past the end of a run (LB is a
//     multiple of 8 unless it was clamped to W) and columns >= TK are filled
//     with zeros by cp.async's source size (0: nothing is read); the last
//     tile stores only k < K.
//
// The transpose (wblur_banded_t_kernel) is one GEMM per lambda-tile too,
// [M, KB] x [KB, n = B*TL]: the A operand is the slab of KB columns of y from
// starts_t[t], the B operand the tile's block, and the n result columns go to
// B runs of TL columns at stride W.  Same register tile and ring as the
// forward (8 x 8 outputs a thread on 16-byte shared-memory loads, A stored
// contraction-major, kStages stages of 8 terms filled by cp.async, one
// __syncthreads() per step), shaped to these operands:
//   * A block covers the whole width n <= 128 of one lambda-tile, so a slab
//     element is loaded once per row block, and the width is a template
//     parameter: CG column groups of 8 columns, 12 / 14 / 16 for n <= 96 /
//     112 / 128 (8 * CG or, on 32-row tiles, 4 * CG threads), so that B = 12
//     (n = 96) and B = 27 (n = 108) do not pay for 128 columns.
//   * The slab is the unaligned operand (starts_t[t] is any integer, K may be
//     odd): 4-byte copies, transposed on the way into shared memory.  The
//     block's rows are 16-byte aligned when n % 4 == 0: 16-byte copies.  One
//     general instance (4-byte copies of B, 128 columns, column blocks over
//     blockIdx.y) takes every other table: n % 4 != 0, a misaligned base,
//     n > 128.
//   * Threads are laid out in aligned groups of eight (the unit in which a
//     16-byte shared-memory load is served): the first BM threads are (row
//     group, column group 0..7), the rest (row group, column group
//     8..CG-1).  A group of eight then reads at most eight distinct 16-byte
//     chunks of B that lie in distinct banks, and at most three of A.
//   * Ragged edges: rows m >= M, slab columns with s + c outside [0, K) (KB
//     rounded up to 128 can run past K) and columns >= n are filled with
//     zeros by cp.async's source size; a partial last tile stores only its
//     columns below W.
//   * The stores are 4-byte (W is odd on most bands, so no run of the output
//     is 16-byte aligned) and go through the ring's shared memory, half the
//     tile's rows at a time, so that eight lanes write eight consecutive
//     columns of one row: whole runs of TL = 4 or 8 columns in one
//     instruction, where a thread's own 4 columns would be four partial
//     writes of one 32-byte sector (on the H100 that cost band 4a, TL = 4,
//     0.077 ms against 0.049 staged).
//   * No split: the grid is (row blocks) x (lambda-tiles), 189-858 blocks on
//     the flagship's bands.  The wrapper picks the row tile (64 or 32) and CG
//     from the shapes.  Every output element belongs to exactly one block and
//     is summed in one order: launches repeat bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// forward

constexpr int kFBM = 64;        // rows of M per block
constexpr int kFBN = 128;       // columns of one lambda'-tile per block
constexpr int kFBK = 8;         // contraction terms per pipeline step
constexpr int kFThreads = 128;  // 8 row groups x 16 column groups, 8 x 8 outputs each
constexpr int kFStages = 4;
constexpr int kFAS = kFBM + 4;  // A stage stride: 4-byte transposed stores and 16-byte loads conflict-free

struct FwdArgs {
  const float* win;     // [m, b*w]
  const float* blocks;  // [n_tiles, b*lb, tk]
  const int* starts;    // [n_tiles]
  float* dst;           // split == 1: out [m, k]; else the partial sums [split, m, k]
  int m, w, b, k, lb, tk;
  int n_col_blocks, split, steps_per_run;
  int vec_store;  // rows of dst are 16-byte aligned
};

// cp.async of 4 / 16 bytes to the shared-memory address `dst`; an invalid
// copy reads nothing (source size 0: its address is not used) and fills zeros.
__device__ __forceinline__ void cp_async_4(unsigned dst, const float* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(unsigned dst, const float* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__global__ void __launch_bounds__(kFThreads, 3) wblur_banded_fwd_kernel(const FwdArgs p) {
  __shared__ __align__(16) float as[kFStages][kFBK][kFAS];  // A, contraction-major
  __shared__ __align__(16) float bs[kFStages][kFBK][kFBN];

  const int tid = threadIdx.x;
  // a warp is 4 row groups x 8 column groups (a 32 x 64 corner of the tile),
  // the four warps 2 x 2: a warp's 16-byte loads of A and of B each touch
  // one 64- or 128-byte span of shared memory
  const int tx = ((tid >> 5) & 1) * 8 + (tid & 7);     // column group, 0..15
  const int ty = (tid >> 6) * 4 + ((tid >> 3) & 3);    // row group, 0..7
  const int m0 = blockIdx.x * kFBM;
  const int tile = blockIdx.y / p.n_col_blocks;
  const int n0 = (blockIdx.y % p.n_col_blocks) * kFBN;
  const int part = blockIdx.z;
  const int run0 = static_cast<int>(static_cast<long long>(part) * p.b / p.split);
  const int run1 = static_cast<int>(static_cast<long long>(part + 1) * p.b / p.split);
  const int s = __ldg(p.starts + tile);
  const long long lda = static_cast<long long>(p.b) * p.w;
  const float* __restrict__ blk = p.blocks + static_cast<long long>(tile) * p.b * p.lb * p.tk;

  // this thread's copies of one step: A terms (a_kk, a_row + 16 r), r < 4,
  // consecutive threads on consecutive window columns; B 16-byte chunks
  // (b_kk + 4 r, b_col), r < 2, consecutive threads along a table row.
  // Pointers and shared-memory addresses walk with the steps issued: no
  // division, no address built from scratch in the loop.
  const int a_kk = tid & 7;
  const int a_row = tid >> 3;
  const int b_kk = tid >> 5;
  const int b_col = (tid & 31) * 4;
  const bool b_col_ok = n0 + b_col < p.tk;
  bool a_row_ok[kFBM / 16];
#pragma unroll
  for (int r = 0; r < kFBM / 16; ++r) a_row_ok[r] = m0 + a_row + 16 * r < p.m;
  const long long a_rows16 = 16 * lda;
  const long long b_rows4 = 4LL * p.tk;
  const float* a_ptr = p.win + (m0 + a_row) * lda + static_cast<long long>(run0) * p.w + s + a_kk;
  const float* b_ptr = blk + (static_cast<long long>(run0) * p.lb + b_kk) * p.tk + n0 + b_col;
  constexpr unsigned kAStage = kFBK * kFAS * sizeof(float);
  constexpr unsigned kBStage = kFBK * kFBN * sizeof(float);
  const unsigned a_dst0 = static_cast<unsigned>(__cvta_generic_to_shared(&as[0][a_kk][a_row]));
  const unsigned b_dst0 = static_cast<unsigned>(__cvta_generic_to_shared(&bs[0][b_kk][b_col]));
  int j0 = 0;          // first term, within its run, of the next step to issue
  int fill_stage = 0;  // the stage it goes to

  const int total = (run1 - run0) * p.steps_per_run;

  auto issue = [&]() {
    const bool a_ok = j0 + a_kk < p.lb && s + j0 + a_kk < p.w;
    const unsigned a_dst = a_dst0 + fill_stage * kAStage;
    const unsigned b_dst = b_dst0 + fill_stage * kBStage;
#pragma unroll
    for (int r = 0; r < kFBM / 16; ++r)
      cp_async_4(a_dst + r * 16 * sizeof(float), a_ptr + r * a_rows16, a_ok && a_row_ok[r]);
#pragma unroll
    for (int r = 0; r < kFBK / 4; ++r)
      cp_async_16(b_dst + r * 4 * kFBN * sizeof(float), b_ptr + r * b_rows4,
                  b_col_ok && j0 + b_kk + 4 * r < p.lb);
    fill_stage = fill_stage + 1 == kFStages ? 0 : fill_stage + 1;
    j0 += kFBK;
    a_ptr += kFBK;
    b_ptr += kFBK * static_cast<long long>(p.tk);
    if (j0 >= p.lb) {  // on to the next run: W further in the window row, LB rows further in the block
      a_ptr += p.w - j0;
      b_ptr += (p.lb - j0) * static_cast<long long>(p.tk);
      j0 = 0;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < total) issue();
    cp_async_commit();  // one group per step, empty past the end: the wait below counts groups
  }

  const float* a_rd = &as[0][0][ty * 4];
  const float* b_rd = &bs[0][0][tx * 4];
  int stage = 0;
  for (int step = 0; step < total; ++step) {
    cp_async_wait<kFStages - 2>();  // this step's stage has landed (for this thread's copies)
    __syncthreads();                // ... for everyone's, and everyone has left the stage refilled next
    if (step + kFStages - 1 < total) issue();
    cp_async_commit();

    const float* a_st = a_rd + stage * (kFBK * kFAS);
    const float* b_st = b_rd + stage * (kFBK * kFBN);
    stage = stage + 1 == kFStages ? 0 : stage + 1;
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(a_st + kk * kFAS);
      const float4 a_hi = *reinterpret_cast<const float4*>(a_st + kk * kFAS + kFBM / 2);
      const float4 b_lo = *reinterpret_cast<const float4*>(b_st + kk * kFBN);
      const float4 b_hi = *reinterpret_cast<const float4*>(b_st + kk * kFBN + kFBN / 2);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* __restrict__ dst = p.dst + static_cast<long long>(part) * p.m * p.k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : kFBM / 2 + ty * 4 + i - 4);
    if (m >= p.m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (kFBN / 2) + tx * 4;  // column within the tile
      const int col = tile * p.tk + n;             // column of the output
      if (n >= p.tk || col >= p.k) continue;
      float* o = dst + static_cast<long long>(m) * p.k + col;
      if (p.vec_store) {  // k % 4 == 0: the four columns are all below k
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < p.k) o[c] = acc[i][4 * h + c];
      }
    }
  }
}

// out[i] = parts[0][i] + parts[1][i] + ... + parts[split-1][i], in that order.
__global__ void __launch_bounds__(256) wblur_banded_sum_parts_kernel(
    const float* __restrict__ parts, float* __restrict__ out, long long n, int split) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = __ldg(parts + i);
  for (int s = 1; s < split; ++s) acc += __ldg(parts + s * n + i);
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// transpose

constexpr int kTBK = 8;     // contraction terms per pipeline step
constexpr int kTStages = 4;

struct BandedTArgs {
  const float* y;       // input rows [m, k]
  const float* blocks;  // re-laid table [n_tiles, kb, b*tl]
  const int* starts;    // [n_tiles] slab offset of each tile
  float* out;           // output rows [m, b*w]
  int m, k, ldc;
  int kb, n, n_col_blocks;  // n = b*tl columns per tile
  int tl, w;                // result: runs of tl columns at stride w, valid below w
};

// Blocks per SM so that a thread may hold up to 168 registers (the 8 x 8
// accumulators need ~145): 12 warps per SM.
constexpr int transpose_blocks_per_sm(int threads) { return 12 / ((threads + 31) / 32); }

// BM rows x (8 * CG) columns of one lambda-tile per block; BM / 8 row groups
// x CG column groups of threads, 8 x 8 outputs each (rows ty*4 + 0..3 and
// BM/2 + ty*4 + 0..3, columns tx*4 + 0..3 and 4*CG + tx*4 + 0..3).  kVecB:
// rows of the block are 16-byte aligned (n % 4 == 0, aligned base).
template <int BM, int CG, bool kVecB>
__global__ void __launch_bounds__(BM / 8 * CG, transpose_blocks_per_sm(BM / 8 * CG))
    wblur_banded_t_kernel(const BandedTArgs p) {
  static_assert(CG > 8 && CG <= 16 && BM % 8 == 0, "column groups 9..16, row groups of 8 rows");
  constexpr int kThreads = BM / 8 * CG;
  constexpr int BN = 8 * CG;
  constexpr int kAS = BM + 4;  // A stage stride: 4-byte transposed stores and 16-byte loads conflict-free
  constexpr int kTS = BN + 8;  // stride of the staged output rows: four rows of 8 columns on distinct banks
  constexpr int kRing = kTStages * kTBK * (kAS + BN);
  static_assert(BM / 2 * kTS <= kRing, "half the output tile is staged in the ring's memory");
  // the ring: A [kTStages][kTBK][kAS], contraction-major, then B [kTStages][kTBK][BN]
  __shared__ __align__(16) float smem[kRing];
  float* const as = smem;
  float* const bs = smem + kTStages * kTBK * kAS;

  const int tid = threadIdx.x;
  constexpr int kFirst = BM;  // threads of column groups 0..7: 8 per row group
  const int ty = tid < kFirst ? tid >> 3 : (tid - kFirst) / (CG - 8);
  const int tx = tid < kFirst ? tid & 7 : 8 + (tid - kFirst) % (CG - 8);
  const int m0 = blockIdx.x * BM;
  const int tile = blockIdx.y / p.n_col_blocks;
  const int n0 = (blockIdx.y % p.n_col_blocks) * BN;
  const int s = __ldg(p.starts + tile);
  const float* __restrict__ blk = p.blocks + static_cast<long long>(tile) * p.kb * p.n;

  // this thread's copies of one step.  A: terms (a_kk, a_row + kARows * r),
  // consecutive threads on consecutive slab columns.  B: 16-byte (4-byte)
  // chunks (b_kk + kBRows * r, b_col), consecutive threads along a table row.
  constexpr int kARows = kThreads / 8;
  constexpr int kAPasses = (BM + kARows - 1) / kARows;
  constexpr int kBW = kVecB ? 4 : 1;
  constexpr int kBChunks = BN / kBW;
  static_assert(kThreads % 8 == 0 && kThreads % kBChunks == 0, "whole rows of copies per pass");
  constexpr int kBRows = kThreads / kBChunks;
  constexpr int kBPasses = kTBK / kBRows;
  static_assert(kBRows * kBPasses == kTBK, "the passes cover a step");
  const int a_kk = tid & 7;
  const int a_row = tid >> 3;
  const int b_kk = tid / kBChunks;
  const int b_col = (tid % kBChunks) * kBW;
  const bool b_col_ok = n0 + b_col < p.n;
  bool a_row_ok[kAPasses];
#pragma unroll
  for (int r = 0; r < kAPasses; ++r) a_row_ok[r] = m0 + a_row + kARows * r < p.m;
  const long long a_pass = static_cast<long long>(kARows) * p.k;
  const long long b_pass = static_cast<long long>(kBRows) * p.n;
  const float* a_ptr = p.y + static_cast<long long>(m0 + a_row) * p.k + s + a_kk;
  const float* b_ptr = blk + static_cast<long long>(b_kk) * p.n + n0 + b_col;
  constexpr unsigned kAStage = kTBK * kAS * sizeof(float);
  constexpr unsigned kBStage = kTBK * BN * sizeof(float);
  const unsigned a_dst0 = static_cast<unsigned>(__cvta_generic_to_shared(as + a_kk * kAS + a_row));
  const unsigned b_dst0 = static_cast<unsigned>(__cvta_generic_to_shared(bs + b_kk * BN + b_col));
  int c0 = 0;          // first term of the next step to copy
  int fill_stage = 0;  // the stage it goes to

  const int total = (p.kb + kTBK - 1) / kTBK;

  auto copy_step = [&]() {
    const int c = c0 + a_kk;
    const bool a_ok = c < p.kb && static_cast<unsigned>(s + c) < static_cast<unsigned>(p.k);
    const unsigned a_dst = a_dst0 + fill_stage * kAStage;
    const unsigned b_dst = b_dst0 + fill_stage * kBStage;
#pragma unroll
    for (int r = 0; r < kAPasses; ++r)
      if ((r + 1) * kARows <= BM || a_row + kARows * r < BM)  // the last pass may pass the tile's rows
        cp_async_4(a_dst + r * kARows * sizeof(float), a_ptr + r * a_pass, a_ok && a_row_ok[r]);
#pragma unroll
    for (int r = 0; r < kBPasses; ++r) {
      const bool ok = b_col_ok && c0 + b_kk + kBRows * r < p.kb;
      if constexpr (kVecB) {
        cp_async_16(b_dst + r * kBRows * BN * sizeof(float), b_ptr + r * b_pass, ok);
      } else {
        cp_async_4(b_dst + r * kBRows * BN * sizeof(float), b_ptr + r * b_pass, ok);
      }
    }
    fill_stage = fill_stage + 1 == kTStages ? 0 : fill_stage + 1;
    c0 += kTBK;
    a_ptr += kTBK;
    b_ptr += kTBK * static_cast<long long>(p.n);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kTStages - 1; ++st) {
    if (st < total) copy_step();
    cp_async_commit();  // one group per step, empty past the end: the wait below counts groups
  }

  const float* a_rd = as + ty * 4;
  const float* b_rd = bs + tx * 4;
  int stage = 0;
  for (int step = 0; step < total; ++step) {
    cp_async_wait<kTStages - 2>();  // this step's stage has landed (for this thread's copies)
    __syncthreads();                // ... for everyone's, and everyone has left the stage refilled next
    if (step + kTStages - 1 < total) copy_step();
    cp_async_commit();

    const float* a_st = a_rd + stage * (kTBK * kAS);
    const float* b_st = b_rd + stage * (kTBK * BN);
    stage = stage + 1 == kTStages ? 0 : stage + 1;
#pragma unroll
    for (int kk = 0; kk < kTBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(a_st + kk * kAS);
      const float4 a_hi = *reinterpret_cast<const float4*>(a_st + kk * kAS + BM / 2);
      const float4 b_lo = *reinterpret_cast<const float4*>(b_st + kk * BN);
      const float4 b_hi = *reinterpret_cast<const float4*>(b_st + kk * BN + BN / 2);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // The stores go through shared memory, half the tile's rows at a time: a
  // thread's own 4 consecutive columns would reach memory as four 4-byte
  // writes to one 32-byte sector, one per instruction.  Staged, a group of
  // eight lanes writes eight consecutive columns of one row (whole runs of
  // TL <= 8 columns, half a run of 16) in one instruction.
  // Column j of the tile's n -> run j / tl, position tile*tl + j % tl of the
  // run; -1: not a column of the output (past n, or past w in the last tile).
  constexpr int kOct = kThreads / 8;
  const int oct = tid >> 3;
  const int l8 = tid & 7;
  int col[CG];
#pragma unroll
  for (int q = 0; q < CG; ++q) {
    const int n = n0 + l8 + 8 * q;
    col[q] = -1;
    if (n < p.n) {
      const int seg = n / p.tl;
      const int pos = tile * p.tl + n - seg * p.tl;
      if (pos < p.w) col[q] = seg * p.w + pos;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __syncthreads();  // everyone has left the ring (h = 0), the first half's rows (h = 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* t = smem + (ty * 4 + i) * kTS + tx * 4;
      *reinterpret_cast<float4*>(t) =
          make_float4(acc[4 * h + i][0], acc[4 * h + i][1], acc[4 * h + i][2], acc[4 * h + i][3]);
      *reinterpret_cast<float4*>(t + BN / 2) =
          make_float4(acc[4 * h + i][4], acc[4 * h + i][5], acc[4 * h + i][6], acc[4 * h + i][7]);
    }
    __syncthreads();
    for (int row = oct; row < BM / 2; row += kOct) {
      const int m = m0 + h * (BM / 2) + row;
      if (m >= p.m) break;
      float* __restrict__ o = p.out + static_cast<long long>(m) * p.ldc;
      const float* t = smem + row * kTS + l8;
#pragma unroll
      for (int q = 0; q < CG; ++q)
        if (col[q] >= 0) o[col[q]] = t[8 * q];
    }
  }
}

template <int BM, int CG, bool kVecB>
int launch_transpose(const BandedTArgs& p, int n_tiles, cudaStream_t st) {
  const long long gy = static_cast<long long>(n_tiles) * p.n_col_blocks;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>((p.m + BM - 1) / BM), static_cast<unsigned>(gy));
  wblur_banded_t_kernel<BM, CG, kVecB><<<grid, BM / 8 * CG, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward.  win [m, b*w], blocks [n_tiles, b*lb, tk], starts [n_tiles],
// out [m, k]; device pointers, f32 / int32, contiguous; tk a multiple of 4
// and blocks 16-byte aligned.  The contraction is cut into `split` parts
// (1 <= split <= b) over the b runs; for split > 1, `parts` is a scratch
// buffer of split*m*k floats and a second kernel adds its slabs into `out`.
// Launches on `stream`, does not synchronise, returns the first launch
// error (0 = launched).
extern "C" int surfh_wblur_banded_f32(const float* win, const float* blocks, const int* starts,
                                      float* out, float* parts, int m, int w, int b, int k,
                                      int n_tiles, int lb, int tk, int split, void* stream) {
  if (m <= 0 || n_tiles <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (b <= 0 || lb <= 0 || split < 1 || split > b || tk <= 0 || tk % 4 != 0 ||
      reinterpret_cast<std::uintptr_t>(blocks) % 16 != 0 || (split > 1 && parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs p{};
  p.win = win;
  p.blocks = blocks;
  p.starts = starts;
  p.dst = split > 1 ? parts : out;
  p.m = m;
  p.w = w;
  p.b = b;
  p.k = k;
  p.lb = lb;
  p.tk = tk;
  p.n_col_blocks = (tk + kFBN - 1) / kFBN;
  p.split = split;
  p.steps_per_run = (lb + kFBK - 1) / kFBK;
  p.vec_store = (k % 4 == 0) && (reinterpret_cast<std::uintptr_t>(p.dst) % 16 == 0);
  const long long gy = static_cast<long long>(n_tiles) * p.n_col_blocks;
  if (gy > 65535 || split > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>((m + kFBM - 1) / kFBM), static_cast<unsigned>(gy),
            static_cast<unsigned>(split));
  wblur_banded_fwd_kernel<<<grid, kFThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(m) * k;
  wblur_banded_sum_parts_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      parts, out, n, split);
  return static_cast<int>(cudaGetLastError());
}

// Transpose.  y [m, k], blocks_t [n_tiles, kb, b*tl], starts_t [n_tiles],
// out [m, b*w]; same conventions.  `bm` x (8 * `cg`) is the block's tile: bm
// 64 or 32 and cg 12, 14 or 16 with `vec` = 1 (16-byte copies of the table:
// b*tl a multiple of 4 and at most 8 * cg, blocks_t 16-byte aligned), or the
// general instance bm = 64, cg = 16, vec = 0 for any table.
extern "C" int surfh_wblur_banded_t_f32(const float* y, const float* blocks_t,
                                        const int* starts_t, float* out, int m, int w, int b,
                                        int k, int n_tiles, int tl, int kb, int bm, int cg,
                                        int vec, void* stream) {
  if (m <= 0 || n_tiles <= 0 || b <= 0 || tl <= 0) return static_cast<int>(cudaSuccess);
  BandedTArgs p{};
  p.y = y;
  p.blocks = blocks_t;
  p.starts = starts_t;
  p.out = out;
  p.m = m;
  p.k = k;
  p.ldc = b * w;
  p.kb = kb;
  p.n = b * tl;
  p.n_col_blocks = (p.n + 8 * cg - 1) / (8 * cg);
  p.tl = tl;
  p.w = w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 0) {
    if (bm != 64 || cg != 16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_transpose<64, 16, false>(p, n_tiles, st);
  }
  if (p.n % 4 != 0 || p.n > 8 * cg) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<std::uintptr_t>(blocks_t) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
#define SURFH_TRANSPOSE_CASE(BM, CG) \
  if (bm == BM && cg == CG) return launch_transpose<BM, CG, true>(p, n_tiles, st);
  SURFH_TRANSPOSE_CASE(64, 12)
  SURFH_TRANSPOSE_CASE(64, 14)
  SURFH_TRANSPOSE_CASE(64, 16)
  SURFH_TRANSPOSE_CASE(32, 12)
  SURFH_TRANSPOSE_CASE(32, 14)
  SURFH_TRANSPOSE_CASE(32, 16)
#undef SURFH_TRANSPOSE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
