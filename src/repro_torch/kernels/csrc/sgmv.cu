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
// of one adapter, its live rows first (block_live[i] of them; the rest are
// zero). For each block i < T_pad / block_t and each row t < block_live[i]
//     h[t, :]   = round_to_T( sum_{q=0..C-1} P_q[t, :] )   (in order q)
//     P_q[t, :] = sum_{k in slice q} x[t, k] * A[k, :]    (fp32, k in
//                                                          order)
//     out[t, c] = round_to_T( E(h[t, :], B[:, c]) )
// and out[t, :] = 0 for block_live[i] <= t < block_t, where (A, B) is the
// block's adapter (B1: row block_adapter[i] of the one bank; B2: row
// block_row[i] of bank block_bucket[i], at that bank's rank r), slice q of
// d is [q * ceil(d / C), (q + 1) * ceil(d / C)) cut at d, and C, the
// shrink split, is the wrapper's ``shrink_split(d, dtype)``: a function of
// d and the type only, never of the rank, the bucket, block_t, the live
// count or the kernel, so every kernel sums an h entry in the same order.
// The expand's sum E starts from +0 in fp32 and
//  - bf16: adds the 16-wide k chunks 0, 16, 32, .. of r in order, each
//    one tensor-core product (mma.m16n8k16, fp32 accumulate) of h's and
//    B's chunk, both zero past r: ceil(r / 16) products;
//  - fp32: is the FMA chain acc = fmaf(h[t, j], B[j, c], acc), j = 0 ..
//    r-1 in order (CUDA cores: TF32 would keep about three digits).
// Rounding h to the input type between the two products is part of the
// contract (sgmv.py:125-139). Rows >= nblocks * block_t are never written
// (T_pad need not be a multiple of block_t; ops never reads them). B3a
// and B4a write h's rows past the live count as zeros.
//
// What bounds it on the H100. At decode a block reads its adapter's A and
// B, 2 * d * r * itemsize bytes (2 MB at d = 4096, r = 128, bf16), and
// does live * r * (d + d_out) FMAs; a decode call has ~8 token blocks and
// ~5 adapters, so the call's bytes (~10 MB, 3 us) bound it, and a block's
// work has to be spread over many SMs to reach that rate. At bucketed
// decode every block holds one live row (each batch row is its own
// "adapter"), so a block is a chain of latencies: A's loads, the cluster's
// syncs, B's loads.
//
// Design, shrink. Each token block is a thread-block cluster of C blocks
// (cudaLaunchKernelEx with a cluster dimension; C = 16 needs the
// non-portable cluster size). Every block of a cluster reads the block's
// live count first: a spare block (count 0) writes its share of zeros and
// leaves before touching A, B or a cluster barrier. Block j of the cluster:
//  1. sums its d-slice of x_blk @ A into an fp32 partial P_j of the live
//     rows in its own shared memory: A's slice and x's live rows stream
//     through a ring of shared slots, kChunk rows of A and kChunk columns
//     of x a slot (the geometry's: 32 for B1 and B3a, 64 for B2 and B4a),
//     with 16-byte cp.async loads; each chunk of x is widened to fp32
//     once; each thread keeps the fp32 sums of one column
//     and of the live rows among its row slots in registers (CUDA cores,
//     the same code for fp32 and bf16). The number of row slots a chunk
//     runs is chosen per block from the live count, so a block of one
//     live row runs one;
//  2. after cluster.sync(), reduces its 1/C share of the live h entries
//     over the C partials through distributed shared memory
//     (map_shared_rank), in rank order 0..C-1, and rounds each sum to T —
//     a reduce-scatter;
//  3. B1/B2: after a second cluster.sync(), gathers every share into its
//     own h tile (T, zeros past the live rows and past r up to the k
//     chunk), syncs the cluster once more (no block leaves while another
//     reads its shared memory), and expands its own output columns
//     [j w, (j + 1) w), w = ceil(d_out / C) rounded up to 8 columns (so
//     that every share's rows of B start 16-byte aligned and load with
//     cp.async: at d_out 576, C = 16, w is 40, not 36, and the last blocks
//     take fewer columns or none), 16-row tiles of live rows only. B3a/B4a
//     write their share of h straight to device memory (B4a with the zero
//     columns r..max_r) and sync the cluster before leaving.
// A decode call so fills ~8 C SMs instead of 8, and a block reads 2 MB /
// C of weights. On the H100 a decode block's time goes to per-chunk steps
// (three barriers each), not to A's loads: staging x in the ring (rather
// than widening it a chunk at a time from registers) and 64-row slots
// (half the steps) each shortened B2's and B4a's decode calls, while an
// 8-slot ring that put the whole A slice in flight at once made them
// slower.
//
// B2's large blocks. The rank-bucketed plan (tune.block_plan) gives block_t
// 32 or 64 to long prefill groups. B2 then runs a second geometry: the
// partial, the h tile and each thread's row slots hold 64 rows, so one
// pass over A's slice and one over B's column share serve all the rows of
// the block (4 tiles of 16 in the expand, each B fragment feeding every
// live tile), and 128-column expand passes keep the accumulators in
// registers. The arithmetic of each entry is the same as at block_t 16.
// On the 2 x 1000-token prefill group it ran 0.13 ms at block_t 64
// against 0.15 at 16 on the H100 (33 clusters of 16 blocks against 127).
//
// Design, expand (ExpandTile, one per type, run by all four kernels). A
// thread block computes kSub tiles of 16 rows x kCols output columns from
// shared tiles: h (16 kSub rows, padded by 16 bytes a row in bf16 so that
// ldmatrix's eight row addresses fall on distinct banks) and B's rows, 16
// at a time (one k step), zero past r and past d_out. bf16: each warp owns
// kCols / warps columns; per k step one ldmatrix.x4 of h per live tile (the
// A fragment), one ldmatrix.x4.trans of B per 16 columns (B is (r, d_out)
// row-major, as V in flash.cu) and one mma per 8 columns and live tile;
// the fp32 accumulators round to bf16 (nearest even) on the way out. fp32:
// a thread owns one column and 16 / (threads / kCols) rows of each tile,
// its FMA chain in j order.
//  - B3b, B4b: a grid of (token blocks, ceil(d_out / 64)) blocks of 4
//    warps, so a decode call at d_out 4096 launches 64 blocks a token
//    block (block_o, the TPU's column tile, no longer shapes the grid);
//    each block loads its h tile and its whole B slice (<= 128 x 64) with
//    16-byte cp.async at once. B4b reads only h[:, :r_b].
//  - B1, B2: each cluster block expands its column share kCols columns at
//    a time (8 warps), B's rows streaming through the shrink's ring in
//    16-row steps, kBStages deep (as many as the ring holds, up to 8); the
//    first steps are issued right after the shrink's last A chunk, so they
//    load during the cluster's reduce-scatter and gather.
// Rows of B or h that are not 16-byte aligned (ranks 1, 2 and 4; ragged
// d_out) are copied element by element; the shared contents are the same.
// An h entry's sum and an output's sum are the same code in every kernel,
// so B3a then B3b equals B1 bit for bit, the per-bucket host loop over
// B3a/B3b equals B2 (at any block_t), B4a then B4b equals B2 (at one rank;
// across ranks the all-reduce reorders the d-sum), bgmv (block_t 1) equals
// sgmv_fused (block_t 16) (an mma's rows are independent), and a bucketed
// bank gives the bits of the equivalent zero-padded bank: a padded bank's
// extra chunks are exact zeros, which leave the accumulator as it is.
// Tensor cores for the shrink are left to a later version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"
#include "resources.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;              // a cluster kernel's block
constexpr int kTileT = 16;                 // rows of a token tile (mma m)
constexpr int kMaxBlockT = 16;             // every kernel but B2
constexpr int kMaxRank = 128;
constexpr int kMaxSplit = 16;              // the largest cluster
constexpr int kMaxBuckets = 8;             // ranks 1..128 in powers of two
// the expand
constexpr int kKStep = 16;                 // rows of B a step takes (mma k)
constexpr int kTileCols = 64;              // B3b/B4b: columns a block
constexpr int kTileThreads = 128;          // B3b/B4b: 4 warps
// shared row padding, elements: 16 bytes in bf16 (ldmatrix's rows on
// distinct banks); fp32 rows are read by consecutive or broadcast lanes
template <typename T>
constexpr int kPad = sizeof(T) == 2 ? 8 : 0;
template <typename T>
constexpr int kHPitch = kMaxRank + kPad<T>;            // an h tile
template <typename T>
constexpr int kTilePitch = kTileCols + kPad<T>;        // B3b/B4b's B

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

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

// The geometry of a cluster kernel: kRows rows of a token block held at
// once (16; 64 for B2's large blocks), kAStages slots in the shrink's ring
// (which later holds B1/B2's B steps), kCols output columns an expand
// pass, kChunk rows of A (columns of x) a slot.
template <typename T, int kRows_, int kAStages_, int kCols_, int kChunk_>
struct Geo {
  using type = T;
  static constexpr int kChunk = kChunk_;
  static constexpr int kXPitch = kChunk + 4;   // a widened x chunk's rows
  static constexpr int kRows = kRows_;
  static constexpr int kSub = kRows / kTileT;           // 16-row tiles
  static constexpr int kAStages = kAStages_;
  static constexpr int kCols = kCols_;
  // row slots of a shrink thread: kRows / (kThreads / r) at r = 128
  static constexpr int kRowsPerThread = kRows * kMaxRank / kThreads;
  static constexpr int kHElems = kRows * kMaxRank;
  // a ring slot: A's chunk (kChunk, kMaxRank) and x's (kRows, kChunk)
  static constexpr int kSlotElems = kChunk * kMaxRank + kRows * kChunk;
  static constexpr int kRingElems = kAStages * kSlotElems;
  static constexpr int kStagePitch = kCols + kPad<T>;   // a B step's rows
  static constexpr int kBStages =
      cmin(8, kRingElems / (kKStep * kStagePitch));
  static_assert(kRows % kTileT == 0 && kSub >= 1, "");
  static_assert(kBStages >= 2, "B's ring holds two steps");
  static_assert(kSlotElems * sizeof(T) % 16 == 0, "16-byte slots");
  static_assert(kRows * kHPitch<T> * sizeof(T) <= kHElems * sizeof(float),
                "the h tile fits over the partial");

  // Shared memory, in this order: the partial (kRows, kMaxRank) fp32, which
  // later holds the h tile in T; this block's reduce share, fp32; x's
  // widened chunk (kRows, kXPitch) fp32; the ring of T.
  static size_t smem_bytes(int split) {
    return sizeof(float) * (kHElems + round4(cdiv(kHElems, split)) +
                            kRows * kXPitch) +
           sizeof(T) * kRingElems;
  }
};

// B1 and B3a: 16 rows, 4 slots of 32 rows (B1 holds three blocks an SM in
// bf16).
template <typename T>
using GeoFused = Geo<T, 16, 4, 256, 32>;
// B2 at block_t <= 16 and B4a: 16 rows, slots of 64 rows (half the chunk
// steps of a slice), two blocks an SM.
template <typename T>
using GeoBank = Geo<T, 16, sizeof(T) == 2 ? 3 : 2, 256, 64>;
// B2 at block_t 32 and 64: 64 rows, 128-column passes, two slots (of 64
// rows in bf16).
template <typename T>
using GeoWide = Geo<T, 64, 2, 128, sizeof(T) == 2 ? 64 : 32>;

// A block's live rows (the segment layout fills a block from its first
// row), cut to block_t.
__device__ __forceinline__ int live_rows(const int* __restrict__ block_live,
                                         int i, int block_t) {
  return min(max(block_live[i], 0), block_t);
}

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

// Layout of a cluster shrink's dynamic shared memory (Geo::smem_bytes).
template <class G>
struct ShrinkSmem {
  using T = typename G::type;
  float* part;                             // (kRows, kMaxRank)
  float* red;                              // this block's reduce share
  float* xs;                               // (kRows, G::kXPitch)
  T* ring;                                 // kAStages slots
  __device__ ShrinkSmem(unsigned char* raw, int split) {
    part = reinterpret_cast<float*>(raw);
    red = part + G::kHElems;
    xs = red + round4(cdiv(G::kHElems, split));
    ring = reinterpret_cast<T*>(xs + G::kRows * G::kXPitch);
  }
  // slot c's A chunk (kChunk, r) and x chunk (kRows, kChunk)
  __device__ T* a_slot(int c) const { return ring + c * G::kSlotElems; }
  __device__ T* x_slot(int c) const {
    return a_slot(c) + G::kChunk * kMaxRank;
  }
};

// Chunk ch of this block's slice (A's rows and x's columns [k_lo + ch
// kChunk, ...)) into ring slot ch % kAStages: A's chunk and the live rows
// of x's, 16-byte cp.async where aligned, element copies otherwise. x's
// entries past the slice are not written (nothing reads them).
template <class G>
__device__ __forceinline__ void stage_chunk(
    const ShrinkSmem<G>& sm, const typename G::type* __restrict__ x_blk,
    const typename G::type* __restrict__ a_slice, int d, int k_lo, int n,
    int r, int live, int ch) {
  using T = typename G::type;
  constexpr int kChunk = G::kChunk;
  constexpr int kVec = 16 / sizeof(T), kPerRow = kChunk / kVec;
  const int slot = ch % G::kAStages;
  const int k0 = ch * kChunk, kc = min(kChunk, n - k0);
  stage_copy<T>(sm.a_slot(slot), a_slice + (size_t)k0 * r, kc * r);
  T* dst = sm.x_slot(slot);
  const T* src = x_blk + k_lo + k0;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | (size_t)d * sizeof(T)) & 15) == 0;
  for (int e = threadIdx.x; e < live * kPerRow; e += kThreads) {
    const int t = e / kPerRow, c = (e % kPerRow) * kVec;
    if (vec && c + kVec <= kc) {
      cp_async_16(dst + t * kChunk + c, src + (size_t)t * d + c);
    } else {
      for (int q = c; q < min(c + kVec, kc); ++q)
        dst[t * kChunk + q] = src[(size_t)t * d + q];
    }
  }
}

// One ring chunk of the partial's FMAs: acc[m] += x[t, k] * a[k, c] for
// the kc rows k of the chunk in order and the rows t = t0 + m * rpp < live,
// m < kM (kM row slots run; the rest of acc is untouched).
template <int kM, int kXPitch, typename T, int kN>
__device__ __forceinline__ void chunk_fmas(float (&acc)[kN],
                                           const T* __restrict__ as,
                                           const float* __restrict__ xc,
                                           int r, int c, int t0, int rpp,
                                           int live, int kc) {
  static_assert(kM <= kN, "");
  int kk = 0;
  for (; kk + 4 <= kc; kk += 4) {
    const float a0 = to_f(as[(kk + 0) * r + c]);
    const float a1 = to_f(as[(kk + 1) * r + c]);
    const float a2 = to_f(as[(kk + 2) * r + c]);
    const float a3 = to_f(as[(kk + 3) * r + c]);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int t = t0 + m * rpp;
      if (t < live) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xc + t * kXPitch + kk);
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
    for (int m = 0; m < kM; ++m) {
      const int t = t0 + m * rpp;
      if (t < live) acc[m] = fmaf(xc[t * kXPitch + kk], av, acc[m]);
    }
  }
}

// Step 1 of every shrink: this block's partial
//   part[t][c] = sum_{k in [k_lo, k_hi)} x_blk[t, k] * a[k, c]
// (fp32 FMAs, k in order) for t < live, c < r. x_blk rows have stride d; a
// is (d, r) row-major. Ends with the partial written (no barrier).
template <class G>
__device__ void slice_partial(const typename G::type* __restrict__ x_blk,
                              const typename G::type* __restrict__ a,
                              ShrinkSmem<G>& sm, int live, int d, int r,
                              int k_lo, int k_hi) {
  using T = typename G::type;
  constexpr int kS = G::kAStages, kChunk = G::kChunk, kXP = G::kXPitch;
  const int tid = threadIdx.x;
  const int n = k_hi - k_lo;
  const int nchunks = cdiv(n, kChunk);
  const T* a_slice = a + (size_t)k_lo * r;
  // the ring's first kS - 1 chunks, one commit group each
#pragma unroll
  for (int c = 0; c < kS - 1; ++c) {
    if (c < nchunks)
      stage_chunk<G>(sm, x_blk, a_slice, d, k_lo, n, r, live, c);
    cp_async_commit();
  }

  const int rpp = kThreads / r;                    // rows a pass, >= 2
  const bool active = tid < rpp * r;
  const int c = tid % r;
  const int t0 = tid / r;
  const int slots = cdiv(live, rpp);               // the same in the block
  float acc[G::kRowsPerThread];
#pragma unroll
  for (int m = 0; m < G::kRowsPerThread; ++m) acc[m] = 0.f;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int next = ch + kS - 1;
    if (next < nchunks)
      stage_chunk<G>(sm, x_blk, a_slice, d, k_lo, n, r, live, next);
    cp_async_commit();
    cp_async_wait<kS - 1>();                       // chunk ch landed
    __syncthreads();
    const int kc = min(kChunk, n - ch * kChunk);
    // x's live rows of the chunk, widened to fp32 once
    const T* xsrc = sm.x_slot(ch % kS);
    for (int e = tid; e < live * kChunk; e += kThreads) {
      const int t = e / kChunk, kk = e % kChunk;
      if (kk < kc) sm.xs[t * kXP + kk] = to_f(xsrc[t * kChunk + kk]);
    }
    __syncthreads();
    const T* as = sm.a_slot(ch % kS);
    const float* xc = sm.xs;
    if (active) {
      // as few row slots as the live rows need (uniform in the block)
      if (slots <= 1) {
        chunk_fmas<1, kXP>(acc, as, xc, r, c, t0, rpp, live, kc);
      } else if (slots <= 2) {
        chunk_fmas<2, kXP>(acc, as, xc, r, c, t0, rpp, live, kc);
      } else if (slots <= 4) {
        chunk_fmas<4, kXP>(acc, as, xc, r, c, t0, rpp, live, kc);
      } else if (slots <= 8) {
        chunk_fmas<cmin(8, G::kRowsPerThread), kXP>(acc, as, xc, r, c, t0,
                                                    rpp, live, kc);
      } else if (slots <= 16) {
        chunk_fmas<cmin(16, G::kRowsPerThread), kXP>(acc, as, xc, r, c, t0,
                                                     rpp, live, kc);
      } else {
        chunk_fmas<G::kRowsPerThread, kXP>(acc, as, xc, r, c, t0, rpp, live,
                                           kc);
      }
    }
    __syncthreads();                               // the slot is free
  }
  cp_async_wait<0>();
  if (active) {
#pragma unroll
    for (int m = 0; m < G::kRowsPerThread; ++m) {
      const int t = t0 + m * rpp;
      if (t < live) sm.part[t * kMaxRank + c] = acc[m];
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
template <class G>
__device__ void cluster_partial(const typename G::type* __restrict__ x_blk,
                                const typename G::type* __restrict__ a,
                                ShrinkSmem<G>& sm, int live, int d, int r) {
  cg::cluster_group cl = cg::this_cluster();
  const int ds = cdiv(d, cl.num_blocks());
  const int k_lo = min(d, static_cast<int>(cl.block_rank()) * ds);
  slice_partial<G>(x_blk, a, sm, live, d, r, k_lo, min(d, k_lo + ds));
}

// Zeros in rows [t0, t1) and columns [c0, c1) of out_blk (row pitch ld).
template <typename T, int kNThreads>
__device__ __forceinline__ void zero_rows(T* __restrict__ out_blk, int ld,
                                          int t0, int t1, int c0, int c1) {
  const int w = c1 - c0;
  if (w <= 0 || t1 <= t0) return;
  for (int e = threadIdx.x; e < (t1 - t0) * w; e += kNThreads)
    out_blk[(size_t)(t0 + e / w) * ld + c0 + e % w] = from_f<T>(0.f);
}

// The expand's arithmetic (see "Design, expand"): kSub tiles of 16 rows x
// kCols output columns of one token block over kNThreads threads, fed one
// k step (16 rows of B, from rank row k0) at a time, in order; the first
// nsub tiles are live. hs: the h tile (16 kSub, ldh) in T, zero past the
// live rows and past r up to the k step; bs: the step's rows of the B
// tile (16, ldb), zero past r and past the last column. This primary
// template is fp32 on CUDA cores: a thread owns column tid % kCols and
// rows tid / kCols + m * kStride of each tile.
template <typename T, int kCols, int kNThreads, int kSub>
struct ExpandTile {
  static constexpr int kStride = kNThreads / kCols;
  static constexpr int kRows = kTileT / kStride;
  static_assert(kNThreads % kCols == 0 && kTileT % kStride == 0, "");
  float acc[kSub][kRows];

  __device__ ExpandTile() {
#pragma unroll
    for (int s = 0; s < kSub; ++s)
#pragma unroll
      for (int m = 0; m < kRows; ++m) acc[s][m] = 0.f;
  }

  __device__ void step(const T* hs, int ldh, const T* bs, int ldb, int k0,
                       int r, int nsub) {
    const int c = threadIdx.x % kCols, t0 = threadIdx.x / kCols;
    const int kc = min(kKStep, r - k0);
#pragma unroll 4
    for (int jj = 0; jj < kc; ++jj) {
      const float bv = to_f(bs[jj * ldb + c]);
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        if (s >= nsub) break;
#pragma unroll
        for (int m = 0; m < kRows; ++m)
          acc[s][m] = fmaf(
              to_f(hs[(s * kTileT + t0 + m * kStride) * ldh + k0 + jj]), bv,
              acc[s][m]);
      }
    }
  }

  // columns [c0, c1) of the live tiles' rows < block_t of out_blk
  // (block_t, d_out); this tile starts at c0
  __device__ void store(T* __restrict__ out_blk, int d_out, int block_t,
                        int nsub, int c0, int c1) const {
    const int col = c0 + threadIdx.x % kCols, t0 = threadIdx.x / kCols;
    if (col >= c1) return;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      if (s >= nsub) break;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int t = s * kTileT + t0 + m * kStride;
        if (t < block_t)
          out_blk[(size_t)t * d_out + col] = from_f<T>(acc[s][m]);
      }
    }
  }
};

// bf16 on tensor cores: warp w owns columns [w kWarpCols, (w + 1)
// kWarpCols) of every tile, kNT mma tiles of 16 x 8 a tile with fp32
// accumulators; each B fragment feeds every live tile.
template <int kCols, int kNThreads, int kSub>
struct ExpandTile<bf16, kCols, kNThreads, kSub> {
  static constexpr int kWarpCols = kCols / (kNThreads / 32);
  static constexpr int kNT = kWarpCols / 8;
  static_assert(kWarpCols % 16 == 0, "ldmatrix.trans takes 16 columns");
  float acc[kSub][kNT][4];

  __device__ ExpandTile() {
#pragma unroll
    for (int s = 0; s < kSub; ++s)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][n][e] = 0.f;
  }

  __device__ void step(const bf16* hs, int ldh, const bf16* bs, int ldb,
                       int k0, int /*r*/, int nsub) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    // lanes 0-7 / 8-15 / 16-23 / 24-31 address the rows of the 8 x 8
    // matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
    unsigned a[kSub][4];
#pragma unroll
    for (int s = 0; s < kSub; ++s)
      if (s < nsub)
        ldmatrix_x4(a[s], hs + (s * kTileT + row) * ldh + k0 + half * 8);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {   // columns 16 np .. of the warp
      unsigned b[4];
      ldmatrix_x4_trans(b, bs + row * ldb + warp * kWarpCols + np * 16 +
                               half * 8);
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        if (s < nsub) {
          mma_bf16(acc[s][2 * np], a[s], b[0], b[1]);
          mma_bf16(acc[s][2 * np + 1], a[s], b[2], b[3]);
        }
      }
    }
  }

  __device__ void store(bf16* __restrict__ out_blk, int d_out, int block_t,
                        int nsub, int c0, int c1) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t4 = lane % 4;   // fragment row, column pair
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      if (s >= nsub) break;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int col = c0 + warp * kWarpCols + n * 8 + 2 * t4;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int t = s * kTileT + g + 8 * hi;
          if (t >= block_t) continue;
          bf16* o = out_blk + (size_t)t * d_out + col;
          const float v0 = acc[s][n][2 * hi], v1 = acc[s][n][2 * hi + 1];
          if (col + 1 < c1 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < c1) o[0] = __float2bfloat16(v0);
            if (col + 1 < c1) o[1] = __float2bfloat16(v1);
          }
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
template <class G>
__device__ __forceinline__ void stage_b(typename G::type* ring,
                                        const typename G::type* __restrict__ b,
                                        int r, int d_out, int c0, int c1,
                                        int s) {
  load_tile<typename G::type, kThreads>(
      ring + (s % G::kBStages) * kKStep * G::kStagePitch, G::kStagePitch,
      b + (size_t)s * kKStep * d_out + c0, d_out, min(kKStep, r - s * kKStep),
      c1 - c0, kKStep, G::kCols);
}

// The first kBStages - 1 k steps of columns [c0, c1), a commit group each.
template <class G>
__device__ __forceinline__ void start_b(typename G::type* ring,
                                        const typename G::type* __restrict__ b,
                                        int r, int d_out, int c0, int c1) {
#pragma unroll
  for (int s = 0; s < G::kBStages - 1; ++s) {
    if (s < cdiv(r, kKStep)) stage_b<G>(ring, b, r, d_out, c0, c1, s);
    cp_async_commit();
  }
}

// One token block as a cluster (B1, B2): x_blk (block_t, d), its first
// `live` rows live, a (d, r), b (r, d_out) -> out_blk (block_t, d_out), this
// block's column share.
template <class G>
__device__ void cluster_fused(const typename G::type* __restrict__ x_blk,
                              const typename G::type* __restrict__ a,
                              const typename G::type* __restrict__ b,
                              typename G::type* __restrict__ out_blk,
                              int block_t, int live, int d, int r,
                              int d_out) {
  using T = typename G::type;
  constexpr int kHP = kHPitch<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int split = cl.num_blocks(), j = cl.block_rank();
  const int dso = cdiv(cdiv(d_out, split), 8) * 8;  // 16-byte aligned
  const int col0 = min(d_out, j * dso), col1 = min(d_out, col0 + dso);
  if (live == 0) {               // a spare block: the whole cluster leaves
    zero_rows<T, kThreads>(out_blk, d_out, 0, block_t, col0, col1);
    return;
  }
  ShrinkSmem<G> sm(smem_raw, split);
  const int kp = k_padded(r), nsteps = kp / kKStep;
  const int nsub = cdiv(live, kTileT);           // live 16-row tiles
  cluster_partial<G>(x_blk, a, sm, live, d, r);
  // the ring is free: B's first steps load during the syncs below
  if (col0 < col1) start_b<G>(sm.ring, b, r, d_out, col0,
                              min(col1, col0 + G::kCols));
  cl.sync();                     // every partial ready
  // step 2: this block's share [e0, e1) of the live h entries e = t r + c
  const int per = cdiv(live * r, split);
  const int e0 = j * per, e1 = min(live * r, e0 + per);
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads)
    sm.red[e - e0] = to_f(from_f<T>(cluster_sum(sm.part, split, e / r,
                                                e % r)));
  cl.sync();                     // every share ready; partials are dead
  // step 3: gather every share into this block's h tile, over the partial
  T* hs = reinterpret_cast<T*>(sm.part);
  for (int e = threadIdx.x; e < nsub * kTileT * kp; e += kThreads) {
    const int t = e / kp, c = e % kp;
    const int eh = t * r + c;
    hs[t * kHP + c] = from_f<T>(
        t < live && c < r ? *cl.map_shared_rank(sm.red + eh % per, eh / per)
                          : 0.f);
  }
  cl.sync();                     // h ready; no share is read any more
  for (int c0 = col0; c0 < col1; c0 += G::kCols) {
    const int c1 = min(col1, c0 + G::kCols);
    if (c0 != col0) start_b<G>(sm.ring, b, r, d_out, c0, c1);
    ExpandTile<T, G::kCols, kThreads, G::kSub> ex;
    for (int s = 0; s < nsteps; ++s) {
      if (s + G::kBStages - 1 < nsteps)
        stage_b<G>(sm.ring, b, r, d_out, c0, c1, s + G::kBStages - 1);
      cp_async_commit();
      cp_async_wait<G::kBStages - 1>();    // step s landed
      __syncthreads();
      ex.step(hs, kHP,
              sm.ring + (s % G::kBStages) * kKStep * G::kStagePitch,
              G::kStagePitch, s * kKStep, r, nsub);
      __syncthreads();                     // the slot is free
    }
    ex.store(out_blk, d_out, block_t, nsub, c0, c1);
  }
  // rows past the live tiles
  zero_rows<T, kThreads>(out_blk, d_out, nsub * kTileT, block_t, col0, col1);
  cp_async_wait<0>();
}

// One token block's h as a cluster (B3a, B4a): h_blk (block_t, ld) gets
// the shrink of the `live` first rows in columns < r, zeros in r..ld and in
// the rows past the live ones, each block writing its share.
template <class G>
__device__ void cluster_shrink_to(const typename G::type* __restrict__ x_blk,
                                  const typename G::type* __restrict__ a,
                                  typename G::type* __restrict__ h_blk,
                                  int block_t, int live, int d, int r,
                                  int ld) {
  using T = typename G::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int split = cl.num_blocks(), j = cl.block_rank();
  // the dead rows' entries [live ld, block_t ld), split over the cluster
  const int nl = live * ld, nz = block_t * ld - nl;
  const int perz = cdiv(nz, split);
  for (int e = j * perz + threadIdx.x; e < min(nz, (j + 1) * perz);
       e += kThreads)
    h_blk[nl + e] = from_f<T>(0.f);
  if (live == 0) return;         // a spare block: the whole cluster leaves
  ShrinkSmem<G> sm(smem_raw, split);
  cluster_partial<G>(x_blk, a, sm, live, d, r);
  cl.sync();                     // every partial ready
  const int per = cdiv(nl, split);
  for (int e = j * per + threadIdx.x; e < min(nl, (j + 1) * per);
       e += kThreads) {
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
  ExpandTile<T, kTileCols, kTileThreads, 1> ex;
  for (int k0 = 0; k0 < kp; k0 += kKStep)
    ex.step(hs, kHPitch<T>, bs + k0 * kTilePitch<T>, kTilePitch<T>, k0, r, 1);
  ex.store(out_blk, d_out, block_t, 1, c0, c1);
}

// Blocks of B1 an SM must hold, as its shared memory allows: three in
// bf16, at 80 registers with 72 bytes spilled (21 clusters of 16 at d =
// 4096 instead of 14 at the compiler's own 128 registers: 17% faster at
// prefill, the same at decode, on the H100); two in fp32 (at most 128
// registers, what the compiler picks unasked; unbounded it took 140, one
// block an SM). B2 and B4a hold two (B2 spilled at 80 registers and ran
// 10% slower at decode).
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
                         const int* __restrict__ block_live,
                         T* __restrict__ out, int block_t, int d, int r,
                         int d_out) {
  const int i = blockIdx.x / cg::this_cluster().num_blocks();
  const int aid = block_adapter[i];
  cluster_fused<GeoFused<T>>(
      x + (size_t)i * block_t * d, A + (size_t)aid * d * r,
      B + (size_t)aid * r * d_out, out + (size_t)i * block_t * d_out,
      block_t, live_rows(block_live, i, block_t), d, r, d_out);
}

struct BankSet {                           // passed by value
  const void* A[kMaxBuckets];
  const void* B[kMaxBuckets];
  int rank[kMaxBuckets];
};

// B2 in geometry G (GeoBank for block_t <= 16, GeoWide for 32 and 64).
template <class G>
__global__ void __launch_bounds__(kThreads, 2)
sgmv_multibank_blocks_kernel(const typename G::type* __restrict__ x,
                             BankSet banks,
                             const int* __restrict__ block_bucket,
                             const int* __restrict__ block_row,
                             const int* __restrict__ block_live,
                             typename G::type* __restrict__ out, int block_t,
                             int d, int d_out) {
  using T = typename G::type;
  const int i = blockIdx.x / cg::this_cluster().num_blocks();
  const int bkt = block_bucket[i];
  const int row = block_row[i];
  const int r = banks.rank[bkt];
  const T* a = static_cast<const T*>(banks.A[bkt]) + (size_t)row * d * r;
  const T* b = static_cast<const T*>(banks.B[bkt]) + (size_t)row * r * d_out;
  cluster_fused<G>(x + (size_t)i * block_t * d, a, b,
                   out + (size_t)i * block_t * d_out, block_t,
                   live_rows(block_live, i, block_t), d, r, d_out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_shrink_kernel(const T* __restrict__ x, const T* __restrict__ A,
                   const int* __restrict__ block_adapter,
                   const int* __restrict__ block_live, T* __restrict__ h,
                   int block_t, int d, int r) {
  const int i = blockIdx.x / cg::this_cluster().num_blocks();
  const int aid = block_adapter[i];
  cluster_shrink_to<GeoFused<T>>(
      x + (size_t)i * block_t * d, A + (size_t)aid * d * r,
      h + (size_t)i * block_t * r, block_t, live_rows(block_live, i, block_t),
      d, r, r);
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
// block's shrink in columns < r and explicit zeros above and in the dead
// rows, because every entry enters the all-reduce across ranks.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
sgmv_multibank_shrink_kernel(const T* __restrict__ x, BankSet banks,
                             const int* __restrict__ block_bucket,
                             const int* __restrict__ block_row,
                             const int* __restrict__ block_live,
                             T* __restrict__ h, int block_t, int d,
                             int max_r) {
  const int i = blockIdx.x / cg::this_cluster().num_blocks();
  const int bkt = block_bucket[i];
  const int r = banks.rank[bkt];
  const T* a = static_cast<const T*>(banks.A[bkt]) +
               (size_t)block_row[i] * d * r;
  cluster_shrink_to<GeoBank<T>>(x + (size_t)i * block_t * d, a,
                                h + (size_t)i * block_t * max_r, block_t,
                                live_rows(block_live, i, block_t), d, r,
                                max_r);
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

// B2's block sizes: one 16-row tile (1..16), or 2 or 4 of them.
bool b2_block_ok(int block_t) {
  return (block_t >= 1 && block_t <= kTileT) || block_t == 32 ||
         block_t == 64;
}

// A launch of kern over nblocks token blocks, each a cluster of `split`
// blocks with `smem` bytes of dynamic shared memory: sets the kernel's
// attributes and fills cfg (whose attrs point at attr).
template <typename Kern>
cudaError_t cluster_config(Kern kern, int nblocks, int split, size_t smem,
                           cudaStream_t s, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  if (split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
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
template <class G, typename... Params, typename... Args>
int launch_clusters(void (*kern)(Params...), int nblocks, int split,
                    cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kern, nblocks, split,
                                   G::smem_bytes(split), s, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <class G, typename Kern>
int cluster_occupancy(Kern kern, int split, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kern, 1, split, G::smem_bytes(split),
                                   nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
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
             const int* ranks, int n_buckets, int max_r, BankSet* banks) {
  if (n_buckets < 1 || n_buckets > kMaxBuckets || max_r < 1 ||
      max_r > kMaxRank)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int b = 0; b < n_buckets; ++b) {
    if (ranks[b] < 1 || ranks[b] > max_r)
      return static_cast<int>(cudaErrorInvalidValue);
    if (A_ptrs) banks->A[b] = A_ptrs[b];
    if (B_ptrs) banks->B[b] = B_ptrs[b];
    banks->rank[b] = ranks[b];
  }
  return 0;
}

template <typename T>
int multibank_blocks(int split, const void* x, const BankSet& banks,
                     const int* bb, const int* br, const int* live, void* out,
                     int nblocks, int block_t, int d, int d_out,
                     cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (block_t <= kTileT)
    return launch_clusters<GeoBank<T>>(
        sgmv_multibank_blocks_kernel<GeoBank<T>>, nblocks, split, s, xt,
        banks, bb, br, live, ot, block_t, d, d_out);
  return launch_clusters<GeoWide<T>>(
      sgmv_multibank_blocks_kernel<GeoWide<T>>, nblocks, split, s, xt, banks,
      bb, br, live, ot, block_t, d, d_out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; split: the shrink's cluster size C
// (1..16); block_live: each token block's live rows (int32, nblocks).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int sgmv_fused_blocks_launch(int dtype, int split, const void* x,
                                        const void* A, const void* B,
                                        const void* block_adapter,
                                        const void* block_live, void* out,
                                        int nblocks, int block_t, int d,
                                        int r, int d_out, void* stream) {
  if (!shape_ok(block_t, r) || nblocks < 0 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ba = static_cast<const int*>(block_adapter);
  const int* lv = static_cast<const int*>(block_live);
  if (dtype == 0)
    return launch_clusters<GeoFused<float>>(
        sgmv_fused_blocks_kernel<float>, nblocks, split, s,
        static_cast<const float*>(x), static_cast<const float*>(A),
        static_cast<const float*>(B), ba, lv, static_cast<float*>(out),
        block_t, d, r, d_out);
  if (dtype == 1)
    return launch_clusters<GeoFused<bf16>>(
        sgmv_fused_blocks_kernel<bf16>, nblocks, split, s,
        static_cast<const bf16*>(x), static_cast<const bf16*>(A),
        static_cast<const bf16*>(B), ba, lv, static_cast<bf16*>(out),
        block_t, d, r, d_out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A_ptrs / B_ptrs / ranks are host arrays of n_buckets entries; block_t is
// 1..16, 32 or 64.
extern "C" int sgmv_multibank_blocks_launch(
    int dtype, int split, const void* x, const void* const* A_ptrs,
    const void* const* B_ptrs, const int* ranks, int n_buckets,
    const void* block_bucket, const void* block_row, const void* block_live,
    void* out, int nblocks, int block_t, int d, int d_out, void* stream) {
  if (nblocks < 0 || d < 1 || !b2_block_ok(block_t))
    return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(A_ptrs, B_ptrs, ranks, n_buckets, kMaxRank,
                               &banks))
    return err;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bb = static_cast<const int*>(block_bucket);
  const int* br = static_cast<const int*>(block_row);
  const int* lv = static_cast<const int*>(block_live);
  if (dtype == 0)
    return multibank_blocks<float>(split, x, banks, bb, br, lv, out, nblocks,
                                   block_t, d, d_out, s);
  if (dtype == 1)
    return multibank_blocks<bf16>(split, x, banks, bb, br, lv, out, nblocks,
                                  block_t, d, d_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sgmv_shrink_launch(int dtype, int split, const void* x,
                                  const void* A, const void* block_adapter,
                                  const void* block_live, void* h,
                                  int nblocks, int block_t, int d, int r,
                                  void* stream) {
  if (!shape_ok(block_t, r) || nblocks < 0 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ba = static_cast<const int*>(block_adapter);
  const int* lv = static_cast<const int*>(block_live);
  if (dtype == 0)
    return launch_clusters<GeoFused<float>>(
        sgmv_shrink_kernel<float>, nblocks, split, s,
        static_cast<const float*>(x), static_cast<const float*>(A), ba, lv,
        static_cast<float*>(h), block_t, d, r);
  if (dtype == 1)
    return launch_clusters<GeoFused<bf16>>(
        sgmv_shrink_kernel<bf16>, nblocks, split, s,
        static_cast<const bf16*>(x), static_cast<const bf16*>(A), ba, lv,
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
    const void* block_row, const void* block_live, void* h, int nblocks,
    int block_t, int d, int max_r, void* stream) {
  if (nblocks < 0 || d < 1 || !shape_ok(block_t, max_r))
    return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(A_ptrs, nullptr, ranks, n_buckets, max_r,
                               &banks))
    return err;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bb = static_cast<const int*>(block_bucket);
  const int* br = static_cast<const int*>(block_row);
  const int* lv = static_cast<const int*>(block_live);
  if (dtype == 0)
    return launch_clusters<GeoBank<float>>(
        sgmv_multibank_shrink_kernel<float>, nblocks, split, s,
        static_cast<const float*>(x), banks, bb, br, lv,
        static_cast<float*>(h), block_t, d, max_r);
  if (dtype == 1)
    return launch_clusters<GeoBank<bf16>>(
        sgmv_multibank_shrink_kernel<bf16>, nblocks, split, s,
        static_cast<const bf16*>(x), banks, bb, br, lv,
        static_cast<bf16*>(h), block_t, d, max_r);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int sgmv_multibank_expand_launch(
    int dtype, const void* h, const void* const* B_ptrs, const int* ranks,
    int n_buckets, const void* block_bucket, const void* block_row,
    void* out, int nblocks, int block_t, int max_r, int d_out,
    void* stream) {
  dim3 grid;
  if (nblocks < 0 || !shape_ok(block_t, max_r) ||
      !tile_grid(nblocks, d_out, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(nullptr, B_ptrs, ranks, n_buckets, max_r,
                               &banks))
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

// How many clusters of `split` blocks the card can hold at once, into
// *clusters, of B1's kernel (kernel 0) or of B2's at block_t (kernel 1);
// bf16 when dtype is 1, else fp32. 0 means it cannot schedule one. Returns
// a CUDA error code.
extern "C" int sgmv_cluster_occupancy(int kernel, int dtype, int split,
                                      int block_t, int* clusters) {
  if (kernel == 0)
    return dtype == 1
               ? cluster_occupancy<GeoFused<bf16>>(
                     sgmv_fused_blocks_kernel<bf16>, split, clusters)
               : cluster_occupancy<GeoFused<float>>(
                     sgmv_fused_blocks_kernel<float>, split, clusters);
  if (kernel != 1 || !b2_block_ok(block_t))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_t <= kTileT)
    return dtype == 1
               ? cluster_occupancy<GeoBank<bf16>>(
                     sgmv_multibank_blocks_kernel<GeoBank<bf16>>, split,
                     clusters)
               : cluster_occupancy<GeoBank<float>>(
                     sgmv_multibank_blocks_kernel<GeoBank<float>>, split,
                     clusters);
  return dtype == 1
             ? cluster_occupancy<GeoWide<bf16>>(
                   sgmv_multibank_blocks_kernel<GeoWide<bf16>>, split,
                   clusters)
             : cluster_occupancy<GeoWide<float>>(
                   sgmv_multibank_blocks_kernel<GeoWide<float>>, split,
                   clusters);
}

namespace {

template <typename T>
int kernel_resources(int kernel, int split, int block_t, long long* out) {
  switch (kernel) {
    case 0:
      return func_resources(sgmv_fused_blocks_kernel<T>,
                            GeoFused<T>::smem_bytes(split), out);
    case 1:
      if (!b2_block_ok(block_t)) break;
      if (block_t <= kTileT)
        return func_resources(sgmv_multibank_blocks_kernel<GeoBank<T>>,
                              GeoBank<T>::smem_bytes(split), out);
      return func_resources(sgmv_multibank_blocks_kernel<GeoWide<T>>,
                            GeoWide<T>::smem_bytes(split), out);
    case 2:
      return func_resources(sgmv_shrink_kernel<T>,
                            GeoFused<T>::smem_bytes(split), out);
    case 3:
      return func_resources(sgmv_expand_kernel<T>, 0, out);
    case 4:
      return func_resources(sgmv_multibank_shrink_kernel<T>,
                            GeoBank<T>::smem_bytes(split), out);
    case 5:
      return func_resources(sgmv_multibank_expand_kernel<T>, 0, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The resources of one SGMV kernel instantiation (kernel: 0 B1, 1 B2 at
// block_t, 2 B3a, 3 B3b, 4 B4a, 5 B4b; dtype 0 = float32, 1 = bfloat16)
// and the dynamic shared memory its launcher sets at the shrink split
// `split`, into out[0..4] (func_resources). Returns a CUDA error code.
extern "C" int sgmv_kernel_resources(int kernel, int dtype, int split,
                                     int block_t, long long* out) {
  if (split < 1 || split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return kernel_resources<float>(kernel, split, block_t, out);
  if (dtype == 1) return kernel_resources<bf16>(kernel, split, block_t, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
