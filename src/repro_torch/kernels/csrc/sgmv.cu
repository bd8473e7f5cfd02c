// Hand-written Hopper (sm_90a) SGMV kernels of the PyTorch port.
//
// B1 sgmv_fused_blocks_kernel replaces the Pallas TPU kernel
//    src/repro/kernels/sgmv.py:sgmv_fused_blocks (pallas_call at :167,
//    bodies _fused_kernel :125 and _fused_kernel_1ob :142): the padded
//    bank, the paper's max-rank baseline.
// B2 sgmv_multibank_blocks_kernel replaces
//    src/repro/kernels/sgmv.py:sgmv_multibank_blocks (pallas_call at :319,
//    body _make_multibank_kernel :192): the rank-bucketed bank, each
//    block at its own bucket's rank.
// B3a sgmv_shrink_kernel replaces sgmv.py:sgmv_shrink (pallas_call at :72,
//    body _shrink_kernel :49) and B3b sgmv_expand_kernel replaces
//    sgmv.py:sgmv_expand (pallas_call at :102, body _expand_kernel :56):
//    the unfused pair, h = x_blk @ A[aid] written to device memory as
//    (T_pad, r) in x's type, then y = h_blk @ B[aid].
// B4a sgmv_multibank_shrink_kernel replaces sgmv.py:sgmv_multibank_shrink
//    (pallas_call at :414, body _make_multibank_shrink_kernel :363) and
//    B4b sgmv_multibank_expand_kernel replaces sgmv_multibank_expand
//    (pallas_call at :487, body _make_multibank_expand_kernel :428): the
//    split pair of B2 for a tensor-parallel engine. B4a writes h (T_pad,
//    max_r) in x's type, each block at its bucket's rank r_b and columns
//    r_b..max_r zero (they enter the all-reduce across ranks, which sums
//    the partial h of each rank's d slice); B4b expands h[:, :r_b] on the
//    rank's own d_out columns.
//
// Contract (B1, B2; B3a and B3b are its two halves). x_pad (T_pad, d)
// is segment-blocked by ops.prepare_segments*: block i holds block_t rows
// of one adapter. For each block i < T_pad / block_t and each row t of it
//     h[t, :]   = round_to_T( sum_{q=0..C-1} P_q[t, :] )   (in order q)
//     P_q[t, :] = sum_{k in slice q} x[t, k] * A[k, :]    (fp32, k in
//                                                          order)
//     out[t, c] = round_to_T( E(h[t, :], B[:, c]) )
// where (A, B) is the block's adapter (B1: row block_adapter[i] of the
// one bank; B2: row block_row[i] of bank block_bucket[i], at that bank's
// rank r), slice q of d is [q * ceil(d / C), (q + 1) * ceil(d / C)) cut at
// d, and C, the shrink split, is the wrapper's ``shrink_split(d, dtype)``:
// a function of d and the type only, never of the rank, the bucket,
// block_t or the kernel, so every kernel sums an h entry in the same
// order. The expand's sum E starts from +0 in fp32 and
//  - bf16: adds the 16-wide k chunks 0, 16, 32, .. of r in order, each
//    one tensor-core product (mma.m16n8k16, fp32 accumulate) of h's and
//    B's chunk, both zero past r: ceil(r / 16) products;
//  - fp32: is the FMA chain acc = fmaf(h[t, j], B[j, c], acc), j = 0 ..
//    r-1 in order (CUDA cores: TF32 would keep about three digits).
// Rounding h to the input type between the two products is part of the
// contract (sgmv.py:125-139). Rows >= nblocks * block_t are never written
// (T_pad need not be a multiple of block_t; ops never reads them).
//
// What bounds it on the H100. At decode a block reads its adapter's A and
// B, 2 * d * r * itemsize bytes (2 MB at d = 4096, r = 128, bf16), and
// does block_t * r * (d + d_out) FMAs; a decode call has ~8 token blocks
// and ~5 adapters, so the call's bytes (~10 MB, 3 us) bound it, and a
// block's work has to be spread over many SMs to reach that rate.
//
// Design, shrink. Each token block is a thread-block cluster of C blocks
// (cudaLaunchKernelEx with a cluster dimension; C = 16 needs the
// non-portable cluster size). Block j of the cluster:
//  1. sums its d-slice of x_blk @ A into a block_t x r fp32 partial P_j
//     in its own shared memory: A's slice streams through a ring of
//     kStages shared chunks with 16-byte cp.async loads, x's slice is
//     widened to fp32 once; each thread keeps the fp32 sums of one column
//     and up to 8 rows in registers (CUDA cores, the same code for fp32
//     and bf16);
//  2. after cluster.sync(), reduces its 1/C share of the h entries over
//     the C partials through distributed shared memory (map_shared_rank),
//     in rank order 0..C-1, and rounds each sum to T — a reduce-scatter;
//  3. B1/B2: after a second cluster.sync(), gathers every share into its
//     own h tile (T, zeros past block_t and past r up to the k chunk),
//     syncs the cluster once more (no block leaves while another reads
//     its shared memory), and expands its own output columns [j ceil(d_out
//     / C), ...). B3a/B4a write their share of h straight to device memory
//     (B4a with the zero columns r..max_r) and sync the cluster before
//     leaving.
// A decode call so fills ~8 C SMs instead of 8, and a block reads 2 MB /
// C of weights.
//
// Design, expand (ExpandTile, one per type, run by all four kernels). A
// thread block computes a block_t x kCols output tile from shared tiles:
// h (16 rows, padded by 16 bytes a row in bf16 so that ldmatrix's eight
// row addresses fall on distinct banks) and B's rows, 16 at a time (one k
// step), zero past r and past d_out. bf16: each warp owns kCols / warps
// columns; per k step one ldmatrix.x4 of h (the A fragment), one
// ldmatrix.x4.trans of B per 16 columns (B is (r, d_out) row-major, as V
// in flash.cu) and one mma per 8 columns; the fp32 accumulators round to
// bf16 (nearest even) on the way out. fp32: a thread owns one column and
// kMaxBlockT / (threads / kCols) rows, its FMA chain in j order.
//  - B3b, B4b: a grid of (token blocks, ceil(d_out / 64)) blocks of 4
//    warps, so a decode call at d_out 4096 launches 64 blocks a token
//    block (block_o, the TPU's column tile, no longer shapes the grid);
//    each block loads its h tile and its whole B slice (<= 128 x 64) with
//    16-byte cp.async at once. B4b reads only h[:, :r_b].
//  - B1, B2: each cluster block expands its column share 256 columns at
//    a time (8 warps x 32), B's rows streaming through the shrink's ring
//    in 16-row steps, kBStages deep; the first steps are issued right
//    after the shrink's last A chunk, so they load during the cluster's
//    reduce-scatter and gather.
// Rows of B or h that are not 16-byte aligned (ranks 1, 2 and 4; ragged
// d_out) are copied element by element; the shared contents are the same.
// An h entry's sum and an output's sum are the same code in every kernel,
// so B3a then B3b equals B1 bit for bit, the per-bucket host loop over
// B3a/B3b equals B2, B4a then B4b equals B2 (at one rank; across ranks
// the all-reduce reorders the d-sum), bgmv (block_t 1) equals sgmv_fused
// (block_t 16) (an mma's rows are independent), and a bucketed bank gives
// the bits of the equivalent zero-padded bank: a padded bank's extra
// chunks are exact zeros, which leave the accumulator as it is. Tensor
// cores for the shrink, and skipping spare blocks (one per adapter) and
// the empty rows of a partly filled block (15 of 16 at bucketed decode)
// are left to a later version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;              // a cluster kernel's block
constexpr int kMaxBlockT = 16;
constexpr int kMaxRank = 128;
constexpr int kMaxSplit = 16;              // the largest cluster
constexpr int kChunk = 32;                 // rows of A a ring stage holds
constexpr int kStages = 4;                 // ring depth of the A stream
constexpr int kMaxBuckets = 8;             // ranks 1..128 in powers of two
// rows of a partial one shrink thread owns: block_t / (kThreads / r)
constexpr int kRowsPerThread = kMaxBlockT * kMaxRank / kThreads;
constexpr int kHElems = kMaxBlockT * kMaxRank;
// the expand
constexpr int kKStep = 16;                 // rows of B a step takes (mma k)
constexpr int kTileCols = 64;              // B3b/B4b: columns a block
constexpr int kTileThreads = 128;          // B3b/B4b: 4 warps
constexpr int kFusedCols = 256;            // B1/B2: columns a pass
constexpr int kBStages = 3;                // B1/B2: ring depth of B
// shared row padding, elements: 16 bytes in bf16 (ldmatrix's rows on
// distinct banks); fp32 rows are read by consecutive or broadcast lanes
template <typename T>
constexpr int kPad = sizeof(T) == 2 ? 8 : 0;
template <typename T>
constexpr int kHPitch = kMaxRank + kPad<T>;            // the h tile
template <typename T>
constexpr int kTilePitch = kTileCols + kPad<T>;        // B3b/B4b's B
template <typename T>
constexpr int kStagePitch = kFusedCols + kPad<T>;      // B1/B2's B steps

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);            // round to nearest even, as torch
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) / 4 * 4;
}

// Shared memory of a cluster shrink, in this order: the partial P_j (and
// later the gathered h tile, in T), (kHElems, fp32); this block's reduce
// share, round4(ceil(kHElems / C)) fp32; x's slice, (kMaxBlockT,
// round4(ceil(d / C))) fp32; the ring, kStages x (kChunk, kMaxRank) of T,
// which holds A's chunks and then B1/B2's B steps.
size_t shrink_smem_bytes(int split, int d, size_t item) {
  return sizeof(float) * (kHElems + round4(cdiv(kHElems, split)) +
                          kMaxBlockT * round4(cdiv(d, split))) +
         item * kStages * kChunk * kMaxRank;
}

template <typename T>
constexpr bool fits_ring() {
  return kBStages * kKStep * kStagePitch<T> <= kStages * kChunk * kMaxRank &&
         kMaxBlockT * kHPitch<T> * sizeof(T) <= kHElems * sizeof(float);
}
static_assert(fits_ring<float>() && fits_ring<bf16>(),
              "B1/B2's B steps fit the ring and the h tile the partial");

// n elements, contiguous, global -> shared: 16-byte cp.async where both
// ends are 16-byte aligned (every call of the main path), element copies
// otherwise; the shared contents are the same either way.
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, int n) {
  const int bytes = n * static_cast<int>(sizeof(T));
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst) | bytes) & 15) == 0) {
    const char* s = reinterpret_cast<const char*>(src);
    char* t = reinterpret_cast<char*>(dst);
    for (int e = threadIdx.x; e < bytes / 16; e += kThreads)
      cp_async_16(t + 16 * e, s + 16 * e);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) dst[e] = src[e];
  }
}

// A rows x cols block of T at src (row pitch lds elements) into shared dst
// (row pitch ldd, a multiple of 16 bytes), zero up to rows_pad x cols_pad
// (cols_pad a multiple of 16 bytes): 16-byte cp.async when src, its pitch
// and cols are 16-byte aligned, element copies otherwise (ranks 1, 2, 4;
// ragged d_out). The caller commits, waits and syncs.
template <typename T, int kNThreads>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          long long lds, int rows, int cols,
                                          int rows_pad, int cols_pad) {
  constexpr int kVec = 16 / sizeof(T);
  if (((reinterpret_cast<uintptr_t>(src) | lds * sizeof(T) |
        cols * sizeof(T)) & 15) == 0) {
    const int per_row = cols_pad / kVec;
    for (int e = threadIdx.x; e < rows_pad * per_row; e += kNThreads) {
      const int row = e / per_row, c = (e % per_row) * kVec;
      T* t = dst + row * ldd + c;
      if (row < rows && c < cols)
        cp_async_16(t, src + row * lds + c);
      else
        *reinterpret_cast<uint4*>(t) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * cols_pad; e += kNThreads) {
      const int row = e / cols_pad, c = e % cols_pad;
      dst[row * ldd + c] =
          row < rows && c < cols ? src[row * lds + c] : from_f<T>(0.f);
    }
  }
}

// Layout of a cluster shrink's dynamic shared memory (shrink_smem_bytes).
template <typename T>
struct ShrinkSmem {
  float* part;                             // (kMaxBlockT, kMaxRank)
  float* red;                              // this block's reduce share
  float* xs;                               // (kMaxBlockT, ldx)
  T* ring;                                 // kStages x (kChunk, kMaxRank)
  int ldx;
  __device__ ShrinkSmem(unsigned char* raw, int split, int d) {
    part = reinterpret_cast<float*>(raw);
    red = part + kHElems;
    xs = red + round4(cdiv(kHElems, split));
    ldx = round4(cdiv(d, split));
    ring = reinterpret_cast<T*>(xs + kMaxBlockT * ldx);
  }
};

// Step 1 of every shrink: this block's partial
//   part[t][c] = sum_{k in [k_lo, k_hi)} x_blk[t, k] * a[k, c]
// (fp32 FMAs, k in order) for t < block_t, c < r. x_blk rows have stride
// d; a is (d, r) row-major. Ends with the partial written (no barrier).
template <typename T>
__device__ void slice_partial(const T* __restrict__ x_blk,
                              const T* __restrict__ a, ShrinkSmem<T>& sm,
                              int block_t, int d, int r, int k_lo,
                              int k_hi) {
  const int tid = threadIdx.x;
  const int n = k_hi - k_lo;
  const int nchunks = cdiv(n, kChunk);
  const T* a_slice = a + (size_t)k_lo * r;
  // the ring's first kStages - 1 chunks, one commit group each
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks)
      stage_copy<T>(sm.ring + c * kChunk * kMaxRank,
                    a_slice + (size_t)c * kChunk * r,
                    min(kChunk, n - c * kChunk) * r);
    cp_async_commit();
  }
  // x's slice, widened once, zero past the slice
  for (int e = tid; e < block_t * sm.ldx; e += kThreads) {
    const int t = e / sm.ldx, kk = e % sm.ldx;
    sm.xs[e] = kk < n ? to_f(x_blk[(size_t)t * d + k_lo + kk]) : 0.f;
  }

  const int rows_per_pass = kThreads / r;          // >= 2
  const bool active = tid < rows_per_pass * r;
  const int c = tid % r;
  const int t0 = tid / r;
  float acc[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) acc[m] = 0.f;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int next = ch + kStages - 1;
    if (next < nchunks)
      stage_copy<T>(sm.ring + (next % kStages) * kChunk * kMaxRank,
                    a_slice + (size_t)next * kChunk * r,
                    min(kChunk, n - next * kChunk) * r);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                  // chunk ch landed
    __syncthreads();
    const T* as = sm.ring + (ch % kStages) * kChunk * kMaxRank;
    const int kc = min(kChunk, n - ch * kChunk);
    const float* xc = sm.xs + ch * kChunk;
    if (active) {
      int kk = 0;
      for (; kk + 4 <= kc; kk += 4) {
        const float a0 = to_f(as[(kk + 0) * r + c]);
        const float a1 = to_f(as[(kk + 1) * r + c]);
        const float a2 = to_f(as[(kk + 2) * r + c]);
        const float a3 = to_f(as[(kk + 3) * r + c]);
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int t = t0 + m * rows_per_pass;
          if (t < block_t) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xc + t * sm.ldx + kk);
            acc[m] = fmaf(xv.x, a0, acc[m]);
            acc[m] = fmaf(xv.y, a1, acc[m]);
            acc[m] = fmaf(xv.z, a2, acc[m]);
            acc[m] = fmaf(xv.w, a3, acc[m]);
          }
        }
      }
      for (; kk < kc; ++kk) {
        const float av = to_f(as[kk * r + c]);
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int t = t0 + m * rows_per_pass;
          if (t < block_t) acc[m] = fmaf(xc[t * sm.ldx + kk], av, acc[m]);
        }
      }
    }
    __syncthreads();                               // the stage is free
  }
  cp_async_wait<0>();
  if (active) {
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int t = t0 + m * rows_per_pass;
      if (t < block_t) sm.part[t * kMaxRank + c] = acc[m];
    }
  }
}

// h[t][c] before rounding: the cluster's C partials summed in rank order.
__device__ __forceinline__ float cluster_sum(float* part, int split, int t,
                                             int c) {
  cg::cluster_group cl = cg::this_cluster();
  float* p = part + t * kMaxRank + c;
  float s = *cl.map_shared_rank(p, 0);
  for (int q = 1; q < split; ++q) s = __fadd_rn(s, *cl.map_shared_rank(p, q));
  return s;
}

// Step 1 for the token block at x_blk with adapter a: this block's
// partial over its d-slice. The caller syncs the cluster (every partial
// ready) before the partials are read.
template <typename T>
__device__ void cluster_partial(const T* __restrict__ x_blk,
                                const T* __restrict__ a, ShrinkSmem<T>& sm,
                                int block_t, int d, int r) {
  cg::cluster_group cl = cg::this_cluster();
  const int ds = cdiv(d, cl.num_blocks());
  const int k_lo = min(d, static_cast<int>(cl.block_rank()) * ds);
  slice_partial<T>(x_blk, a, sm, block_t, d, r, k_lo, min(d, k_lo + ds));
}

// The expand's arithmetic (see "Design, expand"): a block_t x kCols output
// tile of one token block over kNThreads threads, fed one k step (16 rows
// of B, from rank row k0) at a time, in order. hs: the h tile (kMaxBlockT,
// ldh) in T, zero past block_t and past r up to the k step; bs: the step's
// rows of the B tile (16, ldb), zero past r and past the last column.
// This primary template is fp32 on CUDA cores: a thread owns column
// tid % kCols and rows tid / kCols + m * kStride.
template <typename T, int kCols, int kNThreads>
struct ExpandTile {
  static constexpr int kStride = kNThreads / kCols;
  static constexpr int kRows = kMaxBlockT / kStride;
  static_assert(kNThreads % kCols == 0 && kMaxBlockT % kStride == 0, "");
  float acc[kRows];

  __device__ ExpandTile() {
#pragma unroll
    for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  }

  __device__ void step(const T* hs, int ldh, const T* bs, int ldb, int k0,
                       int r) {
    const int c = threadIdx.x % kCols, t0 = threadIdx.x / kCols;
    const int kc = min(kKStep, r - k0);
#pragma unroll 4
    for (int jj = 0; jj < kc; ++jj) {
      const float bv = to_f(bs[jj * ldb + c]);
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        acc[m] = fmaf(to_f(hs[(t0 + m * kStride) * ldh + k0 + jj]), bv,
                      acc[m]);
    }
  }

  // columns [c0, c1) of out_blk (block_t, d_out); this tile starts at c0
  __device__ void store(T* __restrict__ out_blk, int d_out, int block_t,
                        int c0, int c1) const {
    const int col = c0 + threadIdx.x % kCols, t0 = threadIdx.x / kCols;
    if (col >= c1) return;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int t = t0 + m * kStride;
      if (t < block_t) out_blk[(size_t)t * d_out + col] = from_f<T>(acc[m]);
    }
  }
};

// bf16 on tensor cores: warp w owns columns [w kWarpCols, (w + 1)
// kWarpCols) of the tile, kNT mma tiles of 16 x 8 with fp32 accumulators.
template <int kCols, int kNThreads>
struct ExpandTile<bf16, kCols, kNThreads> {
  static constexpr int kWarpCols = kCols / (kNThreads / 32);
  static constexpr int kNT = kWarpCols / 8;
  static_assert(kWarpCols % 16 == 0, "ldmatrix.trans takes 16 columns");
  float acc[kNT][4];

  __device__ ExpandTile() {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  __device__ void step(const bf16* hs, int ldh, const bf16* bs, int ldb,
                       int k0, int /*r*/) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    // lanes 0-7 / 8-15 / 16-23 / 24-31 address the rows of the 8 x 8
    // matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
    unsigned a[4];
    ldmatrix_x4(a, hs + row * ldh + k0 + half * 8);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {   // columns 16 np .. of the warp
      unsigned b[4];
      ldmatrix_x4_trans(b, bs + row * ldb + warp * kWarpCols + np * 16 +
                               half * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }

  __device__ void store(bf16* __restrict__ out_blk, int d_out, int block_t,
                        int c0, int c1) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t4 = lane % 4;   // fragment row, column pair
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = c0 + warp * kWarpCols + n * 8 + 2 * t4;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int t = g + 8 * hi;
        if (t >= block_t) continue;
        bf16* o = out_blk + (size_t)t * d_out + col;
        const float v0 = acc[n][2 * hi], v1 = acc[n][2 * hi + 1];
        if (col + 1 < c1 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0,
                                                                        v1);
        } else {
          if (col < c1) o[0] = __float2bfloat16(v0);
          if (col + 1 < c1) o[1] = __float2bfloat16(v1);
        }
      }
    }
  }
};

__host__ __device__ __forceinline__ int k_padded(int r) {
  return cdiv(r, kKStep) * kKStep;
}

// B1/B2's k step s (B's rows 16 s ..) of columns [c0, c1) into ring slot
// s % kBStages, zero past r and past c1.
template <typename T>
__device__ __forceinline__ void stage_b(T* ring, const T* __restrict__ b,
                                        int r, int d_out, int c0, int c1,
                                        int s) {
  load_tile<T, kThreads>(ring + (s % kBStages) * kKStep * kStagePitch<T>,
                         kStagePitch<T>, b + (size_t)s * kKStep * d_out + c0,
                         d_out, min(kKStep, r - s * kKStep), c1 - c0, kKStep,
                         kFusedCols);
}

// The first kBStages - 1 k steps of columns [c0, c1), a commit group each.
template <typename T>
__device__ __forceinline__ void start_b(T* ring, const T* __restrict__ b,
                                        int r, int d_out, int c0, int c1) {
#pragma unroll
  for (int s = 0; s < kBStages - 1; ++s) {
    if (s < cdiv(r, kKStep)) stage_b<T>(ring, b, r, d_out, c0, c1, s);
    cp_async_commit();
  }
}

// One token block as a cluster (B1, B2): x_blk (block_t, d), a (d, r),
// b (r, d_out) -> out_blk (block_t, d_out), this block's column share.
template <typename T>
__device__ void cluster_fused(const T* __restrict__ x_blk,
                              const T* __restrict__ a,
                              const T* __restrict__ b,
                              T* __restrict__ out_blk, int block_t, int d,
                              int r, int d_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int split = cl.num_blocks(), j = cl.block_rank();
  ShrinkSmem<T> sm(smem_raw, split, d);
  const int dso = cdiv(d_out, split);
  const int col0 = min(d_out, j * dso), col1 = min(d_out, col0 + dso);
  const int kp = k_padded(r), nsteps = kp / kKStep;
  cluster_partial<T>(x_blk, a, sm, block_t, d, r);
  // the ring is free: B's first steps load during the syncs below
  if (col0 < col1) start_b<T>(sm.ring, b, r, d_out, col0,
                              min(col1, col0 + kFusedCols));
  cl.sync();                     // every partial ready
  // step 2: this block's share [e0, e1) of the h entries e = t * r + c
  const int per = cdiv(block_t * r, split);
  const int e0 = j * per, e1 = min(block_t * r, e0 + per);
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads)
    sm.red[e - e0] = to_f(from_f<T>(cluster_sum(sm.part, split, e / r,
                                                e % r)));
  cl.sync();                     // every share ready; partials are dead
  // step 3: gather every share into this block's h tile, over the partial
  T* hs = reinterpret_cast<T*>(sm.part);
  for (int e = threadIdx.x; e < kMaxBlockT * kp; e += kThreads) {
    const int t = e / kp, c = e % kp;
    const int eh = t * r + c;
    hs[t * kHPitch<T> + c] = from_f<T>(
        t < block_t && c < r ? *cl.map_shared_rank(sm.red + eh % per,
                                                    eh / per)
                             : 0.f);
  }
  cl.sync();                     // h ready; no share is read any more
  for (int c0 = col0; c0 < col1; c0 += kFusedCols) {
    const int c1 = min(col1, c0 + kFusedCols);
    if (c0 != col0) start_b<T>(sm.ring, b, r, d_out, c0, c1);
    ExpandTile<T, kFusedCols, kThreads> ex;
    for (int s = 0; s < nsteps; ++s) {
      if (s + kBStages - 1 < nsteps)
        stage_b<T>(sm.ring, b, r, d_out, c0, c1, s + kBStages - 1);
      cp_async_commit();
      cp_async_wait<kBStages - 1>();       // step s landed
      __syncthreads();
      ex.step(hs, kHPitch<T>,
              sm.ring + (s % kBStages) * kKStep * kStagePitch<T>,
              kStagePitch<T>, s * kKStep, r);
      __syncthreads();                     // the slot is free
    }
    ex.store(out_blk, d_out, block_t, c0, c1);
  }
  cp_async_wait<0>();
}

// One token block's h as a cluster (B3a, B4a): h_blk (block_t, ld) gets
// the shrink in columns < r and zeros in r..ld, each block writing its
// share of the block_t x ld entries.
template <typename T>
__device__ void cluster_shrink_to(const T* __restrict__ x_blk,
                                  const T* __restrict__ a,
                                  T* __restrict__ h_blk, int block_t, int d,
                                  int r, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int split = cl.num_blocks(), j = cl.block_rank();
  ShrinkSmem<T> sm(smem_raw, split, d);
  cluster_partial<T>(x_blk, a, sm, block_t, d, r);
  cl.sync();                     // every partial ready
  const int per = cdiv(block_t * ld, split);
  const int e1 = min(block_t * ld, (j + 1) * per);
  for (int e = j * per + threadIdx.x; e < e1; e += kThreads) {
    const int t = e / ld, c = e % ld;
    h_blk[e] = from_f<T>(c < r ? cluster_sum(sm.part, split, t, c) : 0.f);
  }
  cl.sync();                     // no block leaves while its partial is read
}

// B3b/B4b: one token block's h_blk (block_t rows of pitch ld; columns < r
// read) times b (r, d_out) on the kTileCols columns of tile blockIdx.y.
template <typename T>
__device__ void expand_tile_block(const T* __restrict__ h_blk, int ld,
                                  const T* __restrict__ b,
                                  T* __restrict__ out_blk, int block_t,
                                  int r, int d_out) {
  __shared__ __align__(16) unsigned char raw[
      sizeof(T) * (kMaxBlockT * kHPitch<T> + kMaxRank * kTilePitch<T>)];
  T* hs = reinterpret_cast<T*>(raw);                // (kMaxBlockT, kHPitch)
  T* bs = hs + kMaxBlockT * kHPitch<T>;             // (kp, kTilePitch)
  const int kp = k_padded(r);
  const int c0 = blockIdx.y * kTileCols;
  const int c1 = min(d_out, c0 + kTileCols);
  load_tile<T, kTileThreads>(hs, kHPitch<T>, h_blk, ld, block_t, r,
                             kMaxBlockT, kp);
  load_tile<T, kTileThreads>(bs, kTilePitch<T>, b + c0, d_out, r, c1 - c0,
                             kp, kTileCols);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  ExpandTile<T, kTileCols, kTileThreads> ex;
  for (int k0 = 0; k0 < kp; k0 += kKStep)
    ex.step(hs, kHPitch<T>, bs + k0 * kTilePitch<T>, kTilePitch<T>, k0, r);
  ex.store(out_blk, d_out, block_t, c0, c1);
}

// Blocks of B1 an SM must hold, as its shared memory allows: three in
// bf16, which fits 80 registers without a spill (21 clusters of 16 at d =
// 4096 instead of 14 at the compiler's own 128 registers: 17% faster at
// prefill, the same at decode, on the H100); two in fp32 (at most 128
// registers, what the compiler picks unasked; unbounded it took 140, one
// block an SM). B2 keeps the compiler's choice: it spills at 80 registers
// and ran 10% slower at decode.
template <typename T>
constexpr int kFusedMinBlocks = sizeof(T) == 2 ? 3 : 2;

// Indices come from ops' segment layout, which keeps every adapter id,
// bucket and row in range of the bank it indexes. blockIdx.x / C is the
// token block: a cluster's blocks are consecutive in x.
template <typename T>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks<T>)
sgmv_fused_blocks_kernel(const T* __restrict__ x, const T* __restrict__ A,
                         const T* __restrict__ B,
                         const int* __restrict__ block_adapter,
                         T* __restrict__ out, int block_t, int d, int r,
                         int d_out) {
  const int i = blockIdx.x / cg::this_cluster().num_blocks();
  const int aid = block_adapter[i];
  cluster_fused<T>(x + (size_t)i * block_t * d, A + (size_t)aid * d * r,
                   B + (size_t)aid * r * d_out,
                   out + (size_t)i * block_t * d_out, block_t, d, r, d_out);
}

struct BankSet {                           // passed by value
  const void* A[kMaxBuckets];
  const void* B[kMaxBuckets];
  int rank[kMaxBuckets];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_multibank_blocks_kernel(const T* __restrict__ x, BankSet banks,
                             const int* __restrict__ block_bucket,
                             const int* __restrict__ block_row,
                             T* __restrict__ out, int block_t, int d,
                             int d_out) {
  const int i = blockIdx.x / cg::this_cluster().num_blocks();
  const int bkt = block_bucket[i];
  const int row = block_row[i];
  const int r = banks.rank[bkt];
  const T* a = static_cast<const T*>(banks.A[bkt]) + (size_t)row * d * r;
  const T* b = static_cast<const T*>(banks.B[bkt]) + (size_t)row * r * d_out;
  cluster_fused<T>(x + (size_t)i * block_t * d, a, b,
                   out + (size_t)i * block_t * d_out, block_t, d, r, d_out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_shrink_kernel(const T* __restrict__ x, const T* __restrict__ A,
                   const int* __restrict__ block_adapter, T* __restrict__ h,
                   int block_t, int d, int r) {
  const int i = blockIdx.x / cg::this_cluster().num_blocks();
  const int aid = block_adapter[i];
  cluster_shrink_to<T>(x + (size_t)i * block_t * d, A + (size_t)aid * d * r,
                       h + (size_t)i * block_t * r, block_t, d, r, r);
}

// B3b. Grid (token blocks, ceil(d_out / kTileCols)).
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
sgmv_expand_kernel(const T* __restrict__ h, const T* __restrict__ B,
                   const int* __restrict__ block_adapter, T* __restrict__ out,
                   int block_t, int r, int d_out) {
  const int i = blockIdx.x;
  const int aid = block_adapter[i];
  expand_tile_block<T>(h + (size_t)i * block_t * r, r,
                       B + (size_t)aid * r * d_out,
                       out + (size_t)i * block_t * d_out, block_t, r, d_out);
}

// B4a. Each token block at its bucket's rank r; h (T_pad, max_r) gets the
// block's shrink in columns < r and explicit zeros above, because every
// column enters the all-reduce across ranks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_multibank_shrink_kernel(const T* __restrict__ x, BankSet banks,
                             const int* __restrict__ block_bucket,
                             const int* __restrict__ block_row,
                             T* __restrict__ h, int block_t, int d,
                             int max_r) {
  const int i = blockIdx.x / cg::this_cluster().num_blocks();
  const int bkt = block_bucket[i];
  const int r = banks.rank[bkt];
  const T* a = static_cast<const T*>(banks.A[bkt]) +
               (size_t)block_row[i] * d * r;
  cluster_shrink_to<T>(x + (size_t)i * block_t * d, a,
                       h + (size_t)i * block_t * max_r, block_t, d, r, max_r);
}

// B4b. Grid (token blocks, ceil(d_out / kTileCols)): h[:, :r] of the
// block's bucket times its B on the rank's d_out columns.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
sgmv_multibank_expand_kernel(const T* __restrict__ h, BankSet banks,
                             const int* __restrict__ block_bucket,
                             const int* __restrict__ block_row,
                             T* __restrict__ out, int block_t, int max_r,
                             int d_out) {
  const int i = blockIdx.x;
  const int bkt = block_bucket[i];
  const int r = banks.rank[bkt];
  expand_tile_block<T>(h + (size_t)i * block_t * max_r, max_r,
                       static_cast<const T*>(banks.B[bkt]) +
                           (size_t)block_row[i] * r * d_out,
                       out + (size_t)i * block_t * d_out, block_t, r, d_out);
}

bool shape_ok(int block_t, int r) {
  return block_t >= 1 && block_t <= kMaxBlockT && r >= 1 && r <= kMaxRank;
}

// A launch of kern over nblocks token blocks, each a cluster of `split`
// blocks with the shrink's shared memory at width d: sets the kernel's
// attributes and fills cfg (whose attrs point at attr).
template <typename Kern>
cudaError_t cluster_config(Kern kern, int nblocks, int split, int d,
                           size_t item, cudaStream_t s,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  if (split < 1 || split > kMaxSplit || d < 1) return cudaErrorInvalidValue;
  const size_t smem = shrink_smem_bytes(split, d, item);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  *cfg = {};
  cfg->gridDim = dim3(nblocks * split);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// A cluster shape the card cannot schedule makes the launch return an
// error; nothing runs then.
template <typename... Params, typename... Args>
int launch_clusters(void (*kern)(Params...), int nblocks, int split, int d,
                    size_t item, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config(kern, nblocks, split, d, item, s, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cluster_occupancy(int split, int d, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(sgmv_fused_blocks_kernel<T>, 1, split,
                                   d, sizeof(T), nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters,
                                         sgmv_fused_blocks_kernel<T>, &cfg);
  return static_cast<int>(err);
}

// The grid of B3b and B4b: (token blocks, column tiles); false when the
// card cannot launch it.
bool tile_grid(int nblocks, int d_out, dim3* grid) {
  const int tiles = cdiv(d_out, kTileCols);
  if (d_out < 1 || tiles > 65535) return false;
  *grid = dim3(nblocks, tiles);
  return true;
}

// B2 / B4a / B4b take bank pointer arrays and the buckets' ranks, host
// arrays of n_buckets entries; every rank must lie in 1..max_r, max_r <=
// 128.
int bank_set(const void* const* A_ptrs, const void* const* B_ptrs,
             const int* ranks, int n_buckets, int block_t, int max_r,
             BankSet* banks) {
  if (n_buckets < 1 || n_buckets > kMaxBuckets ||
      !shape_ok(block_t, max_r))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int b = 0; b < n_buckets; ++b) {
    if (!shape_ok(block_t, ranks[b]) || ranks[b] > max_r)
      return static_cast<int>(cudaErrorInvalidValue);
    if (A_ptrs) banks->A[b] = A_ptrs[b];
    if (B_ptrs) banks->B[b] = B_ptrs[b];
    banks->rank[b] = ranks[b];
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; split: the shrink's cluster size C
// (1..16). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int sgmv_fused_blocks_launch(int dtype, int split, const void* x,
                                        const void* A, const void* B,
                                        const void* block_adapter, void* out,
                                        int nblocks, int block_t, int d,
                                        int r, int d_out, void* stream) {
  if (!shape_ok(block_t, r) || nblocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ba = static_cast<const int*>(block_adapter);
  if (dtype == 0)
    return launch_clusters(
        sgmv_fused_blocks_kernel<float>, nblocks, split, d, sizeof(float), s,
        static_cast<const float*>(x), static_cast<const float*>(A),
        static_cast<const float*>(B), ba, static_cast<float*>(out), block_t,
        d, r, d_out);
  if (dtype == 1)
    return launch_clusters(
        sgmv_fused_blocks_kernel<bf16>, nblocks, split, d, sizeof(bf16), s,
        static_cast<const bf16*>(x), static_cast<const bf16*>(A),
        static_cast<const bf16*>(B), ba, static_cast<bf16*>(out), block_t, d,
        r, d_out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A_ptrs / B_ptrs / ranks are host arrays of n_buckets entries.
extern "C" int sgmv_multibank_blocks_launch(
    int dtype, int split, const void* x, const void* const* A_ptrs,
    const void* const* B_ptrs, const int* ranks, int n_buckets,
    const void* block_bucket, const void* block_row, void* out, int nblocks,
    int block_t, int d, int d_out, void* stream) {
  if (nblocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(A_ptrs, B_ptrs, ranks, n_buckets, block_t,
                               kMaxRank, &banks))
    return err;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bb = static_cast<const int*>(block_bucket);
  const int* br = static_cast<const int*>(block_row);
  if (dtype == 0)
    return launch_clusters(sgmv_multibank_blocks_kernel<float>, nblocks,
                           split, d, sizeof(float), s,
                           static_cast<const float*>(x), banks, bb, br,
                           static_cast<float*>(out), block_t, d, d_out);
  if (dtype == 1)
    return launch_clusters(sgmv_multibank_blocks_kernel<bf16>, nblocks,
                           split, d, sizeof(bf16), s,
                           static_cast<const bf16*>(x), banks, bb, br,
                           static_cast<bf16*>(out), block_t, d, d_out);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sgmv_shrink_launch(int dtype, int split, const void* x,
                                  const void* A, const void* block_adapter,
                                  void* h, int nblocks, int block_t, int d,
                                  int r, void* stream) {
  if (!shape_ok(block_t, r) || nblocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ba = static_cast<const int*>(block_adapter);
  if (dtype == 0)
    return launch_clusters(sgmv_shrink_kernel<float>, nblocks, split, d,
                           sizeof(float), s, static_cast<const float*>(x),
                           static_cast<const float*>(A), ba,
                           static_cast<float*>(h), block_t, d, r);
  if (dtype == 1)
    return launch_clusters(sgmv_shrink_kernel<bf16>, nblocks, split, d,
                           sizeof(bf16), s, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(A), ba,
                           static_cast<bf16*>(h), block_t, d, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sgmv_expand_launch(int dtype, const void* h, const void* B,
                                  const void* block_adapter, void* out,
                                  int nblocks, int block_t, int r, int d_out,
                                  void* stream) {
  dim3 grid;
  if (!shape_ok(block_t, r) || nblocks < 0 || !tile_grid(nblocks, d_out,
                                                         &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ba = static_cast<const int*>(block_adapter);
  if (dtype == 0) {
    sgmv_expand_kernel<float><<<grid, kTileThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(B), ba,
        static_cast<float*>(out), block_t, r, d_out);
  } else if (dtype == 1) {
    sgmv_expand_kernel<bf16><<<grid, kTileThreads, 0, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(B), ba,
        static_cast<bf16*>(out), block_t, r, d_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sgmv_multibank_shrink_launch(
    int dtype, int split, const void* x, const void* const* A_ptrs,
    const int* ranks, int n_buckets, const void* block_bucket,
    const void* block_row, void* h, int nblocks, int block_t, int d,
    int max_r, void* stream) {
  if (nblocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(A_ptrs, nullptr, ranks, n_buckets, block_t,
                               max_r, &banks))
    return err;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bb = static_cast<const int*>(block_bucket);
  const int* br = static_cast<const int*>(block_row);
  if (dtype == 0)
    return launch_clusters(sgmv_multibank_shrink_kernel<float>, nblocks,
                           split, d, sizeof(float), s,
                           static_cast<const float*>(x), banks, bb, br,
                           static_cast<float*>(h), block_t, d, max_r);
  if (dtype == 1)
    return launch_clusters(sgmv_multibank_shrink_kernel<bf16>, nblocks,
                           split, d, sizeof(bf16), s,
                           static_cast<const bf16*>(x), banks, bb, br,
                           static_cast<bf16*>(h), block_t, d, max_r);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sgmv_multibank_expand_launch(
    int dtype, const void* h, const void* const* B_ptrs, const int* ranks,
    int n_buckets, const void* block_bucket, const void* block_row,
    void* out, int nblocks, int block_t, int max_r, int d_out,
    void* stream) {
  dim3 grid;
  if (nblocks < 0 || !tile_grid(nblocks, d_out, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(nullptr, B_ptrs, ranks, n_buckets, block_t,
                               max_r, &banks))
    return err;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bb = static_cast<const int*>(block_bucket);
  const int* br = static_cast<const int*>(block_row);
  if (dtype == 0) {
    sgmv_multibank_expand_kernel<float><<<grid, kTileThreads, 0, s>>>(
        static_cast<const float*>(h), banks, bb, br, static_cast<float*>(out),
        block_t, max_r, d_out);
  } else if (dtype == 1) {
    sgmv_multibank_expand_kernel<bf16><<<grid, kTileThreads, 0, s>>>(
        static_cast<const bf16*>(h), banks, bb, br, static_cast<bf16*>(out),
        block_t, max_r, d_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `split` blocks of B1's kernel (bf16 when dtype is
// 1, else fp32) the card can hold at once at width d, into *clusters; 0
// means it cannot schedule one. Returns a CUDA error code.
extern "C" int sgmv_cluster_occupancy(int dtype, int split, int d,
                                      int* clusters) {
  return dtype == 1 ? cluster_occupancy<bf16>(split, d, clusters)
                    : cluster_occupancy<float>(split, d, clusters);
}
