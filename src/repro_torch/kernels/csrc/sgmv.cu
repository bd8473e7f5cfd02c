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
//     out[t, c] = round_to_T( sum_j h[t, j] * B[j, c] )    (fp32, j in
//                                                          order)
// where (A, B) is the block's adapter (B1: row block_adapter[i] of the
// one bank; B2: row block_row[i] of bank block_bucket[i], at that bank's
// rank), slice q of d is [q * ceil(d / C), (q + 1) * ceil(d / C)) cut at
// d, and C, the shrink split, is the wrapper's ``shrink_split(d, dtype)``:
// a function of d and the type only, never of the rank, the bucket,
// block_t or the kernel, so every kernel sums an h entry in the same
// order. Rounding h to the input type between the two products is part of
// the contract (sgmv.py:125-139). Rows >= nblocks * block_t are never
// written (T_pad need not be a multiple of block_t; ops never reads them).
//
// What bounds it on the H100. At decode a block reads its adapter's A and
// B, 2 * d * r * itemsize bytes (2 MB at d = 4096, r = 128, bf16), and
// does block_t * r * (d + d_out) FMAs; a decode call has ~8 token blocks
// and ~5 adapters, so the call's bytes (~10 MB, 3 us) bound it, and a
// block's work has to be spread over many SMs to reach that rate.
//
// Design. Each token block is a thread-block cluster of C blocks
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
//     own hs (the block_t x r h that every block then holds), syncs the
//     cluster once more (no block leaves while another reads its shared
//     memory), and runs the unchanged expand_block over its own output
//     columns [j ceil(d_out / C), ...). B3a/B4a write their share of h
//     straight to device memory (B4a with the zero columns r..max_r)
//     and sync the cluster before leaving.
// A decode call so fills ~8 C SMs instead of 8, and a block reads 2 MB /
// C of weights. An h entry's sum is the same code in every kernel, so B3a
// then B3b equals B1 bit for bit, the per-bucket host loop over B3a/B3b
// equals B2, B4a then B4b equals B2 (at one rank; across ranks the
// all-reduce reorders the d-sum), bgmv (block_t 1) equals sgmv_fused
// (block_t 16), and a bucketed bank gives the bits of the equivalent
// zero-padded bank: a column's sums never depend on the rank, and the
// padded bank's extra expand terms are exact zeros. expand_block keeps
// its order; B3b and B4b tile the output columns over a second grid
// dimension (block_o columns a thread block) and are unchanged. Tensor
// cores for the shrink, a faster expand, and skipping spare blocks (one
// per adapter) and the empty rows of a partly filled block (15 of 16 at
// bucketed decode) are left to a later version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlockT = 16;
constexpr int kMaxRank = 128;
constexpr int kMaxSplit = 16;              // the largest cluster
constexpr int kChunk = 32;                 // rows of A a ring stage holds
constexpr int kStages = 4;                 // ring depth of the A stream
constexpr int kMaxBuckets = 8;             // ranks 1..128 in powers of two
// rows of a partial one shrink thread owns: block_t / (kThreads / r)
constexpr int kRowsPerThread = kMaxBlockT * kMaxRank / kThreads;
constexpr int kHElems = kMaxBlockT * kMaxRank;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);            // round to nearest even, as torch
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) / 4 * 4;
}

// Shared memory of a cluster shrink, in this order: the partial P_j (and
// later the gathered hs), (kHElems, fp32); this block's reduce share,
// round4(ceil(kHElems / C)) fp32; x's slice, (kMaxBlockT, round4(ceil(d /
// C))) fp32; the A ring, kStages x (kChunk, kMaxRank) of T.
size_t shrink_smem_bytes(int split, int d, size_t item) {
  return sizeof(float) * (kHElems + round4(cdiv(kHElems, split)) +
                          kMaxBlockT * round4(cdiv(d, split))) +
         item * kStages * kChunk * kMaxRank;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
// partial over its d-slice, then a cluster barrier (every partial ready).
template <typename T>
__device__ void cluster_partial(const T* __restrict__ x_blk,
                                const T* __restrict__ a, ShrinkSmem<T>& sm,
                                int block_t, int d, int r) {
  cg::cluster_group cl = cg::this_cluster();
  const int ds = cdiv(d, cl.num_blocks());
  const int k_lo = min(d, static_cast<int>(cl.block_rank()) * ds);
  slice_partial<T>(x_blk, a, sm, block_t, d, r, k_lo, min(d, k_lo + ds));
  cl.sync();
}

// The expand of one token block over output columns [col0, col1), shared
// by B1, B2, B3b and B4b: one thread per column, coalesced reads of b's
// rows, block_t fp32 sums in registers, j = 0 .. r-1 in order.
template <typename T>
__device__ void expand_block(const float (*hs)[kMaxRank],
                             const T* __restrict__ b,
                             T* __restrict__ out_blk, int block_t, int r,
                             int d_out, int col0, int col1) {
  for (int col = col0 + threadIdx.x; col < col1; col += kThreads) {
    float o[kMaxBlockT];
#pragma unroll
    for (int t = 0; t < kMaxBlockT; ++t) o[t] = 0.f;
#pragma unroll 4
    for (int j = 0; j < r; ++j) {
      const float bv = to_f(b[(size_t)j * d_out + col]);
#pragma unroll
      for (int t = 0; t < kMaxBlockT; ++t)
        if (t < block_t) o[t] += hs[t][j] * bv;
    }
#pragma unroll
    for (int t = 0; t < kMaxBlockT; ++t)
      if (t < block_t) out_blk[(size_t)t * d_out + col] = from_f<T>(o[t]);
  }
}

// One token block as a cluster (B1, B2): x_blk (block_t, d), a (d, r),
// b (r, d_out) -> out_blk (block_t, d_out), this block's column slice.
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
  cluster_partial<T>(x_blk, a, sm, block_t, d, r);
  // step 2: this block's share [e0, e1) of the h entries e = t * r + c
  const int per = cdiv(block_t * r, split);
  const int e0 = j * per, e1 = min(block_t * r, e0 + per);
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads)
    sm.red[e - e0] = to_f(from_f<T>(cluster_sum(sm.part, split, e / r,
                                                e % r)));
  cl.sync();                     // every share ready; partials are dead
  // step 3: gather every share into this block's hs, over the partial
  for (int e = threadIdx.x; e < block_t * r; e += kThreads)
    sm.part[(e / r) * kMaxRank + e % r] =
        *cl.map_shared_rank(sm.red + e % per, e / per);
  cl.sync();                     // hs ready; no share is read any more
  expand_block<T>(reinterpret_cast<const float(*)[kMaxRank]>(sm.part), b,
                  out_blk, block_t, r, d_out, col0, col1);
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
  const int per = cdiv(block_t * ld, split);
  const int e1 = min(block_t * ld, (j + 1) * per);
  for (int e = j * per + threadIdx.x; e < e1; e += kThreads) {
    const int t = e / ld, c = e % ld;
    h_blk[e] = from_f<T>(c < r ? cluster_sum(sm.part, split, t, c) : 0.f);
  }
  cl.sync();                     // no block leaves while its partial is read
}

// Indices come from ops' segment layout, which keeps every adapter id,
// bucket and row in range of the bank it indexes. blockIdx.x / C is the
// token block: a cluster's blocks are consecutive in x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
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

// Grid (token blocks, column tiles of block_o).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_expand_kernel(const T* __restrict__ h, const T* __restrict__ B,
                   const int* __restrict__ block_adapter, T* __restrict__ out,
                   int block_t, int r, int d_out, int block_o) {
  __shared__ float hs[kMaxBlockT][kMaxRank];
  const int i = blockIdx.x;
  const int aid = block_adapter[i];
  const T* h_blk = h + (size_t)i * block_t * r;
  for (int e = threadIdx.x; e < block_t * r; e += kThreads)
    hs[e / r][e % r] = to_f(h_blk[e]);
  __syncthreads();
  const int col0 = blockIdx.y * block_o;
  expand_block<T>(hs, B + (size_t)aid * r * d_out,
                  out + (size_t)i * block_t * d_out, block_t, r, d_out, col0,
                  min(col0 + block_o, d_out));
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

// B4b. Grid (token blocks, column tiles of block_o): h[:, :r] of the
// block's bucket times its B on the rank's d_out columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_multibank_expand_kernel(const T* __restrict__ h, BankSet banks,
                             const int* __restrict__ block_bucket,
                             const int* __restrict__ block_row,
                             T* __restrict__ out, int block_t, int max_r,
                             int d_out, int block_o) {
  __shared__ float hs[kMaxBlockT][kMaxRank];
  const int i = blockIdx.x;
  const int bkt = block_bucket[i];
  const int r = banks.rank[bkt];
  const T* h_blk = h + (size_t)i * block_t * max_r;
  for (int e = threadIdx.x; e < block_t * r; e += kThreads)
    hs[e / r][e % r] = to_f(h_blk[(size_t)(e / r) * max_r + e % r]);
  __syncthreads();
  const int col0 = blockIdx.y * block_o;
  expand_block<T>(hs, static_cast<const T*>(banks.B[bkt]) +
                          (size_t)block_row[i] * r * d_out,
                  out + (size_t)i * block_t * d_out, block_t, r, d_out, col0,
                  min(col0 + block_o, d_out));
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

using bf16 = __nv_bfloat16;

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
                                  int block_o, void* stream) {
  if (!shape_ok(block_t, r) || nblocks < 0 || d_out < 1 || block_o < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ba = static_cast<const int*>(block_adapter);
  const dim3 grid(nblocks, (d_out + block_o - 1) / block_o);
  if (dtype == 0) {
    sgmv_expand_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(B), ba,
        static_cast<float*>(out), block_t, r, d_out, block_o);
  } else if (dtype == 1) {
    sgmv_expand_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(B), ba,
        static_cast<bf16*>(out), block_t, r, d_out, block_o);
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
    void* out, int nblocks, int block_t, int max_r, int d_out, int block_o,
    void* stream) {
  if (nblocks < 0 || d_out < 1 || block_o < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(nullptr, B_ptrs, ranks, n_buckets, block_t,
                               max_r, &banks))
    return err;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bb = static_cast<const int*>(block_bucket);
  const int* br = static_cast<const int*>(block_row);
  const dim3 grid(nblocks, (d_out + block_o - 1) / block_o);
  if (dtype == 0) {
    sgmv_multibank_expand_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), banks, bb, br, static_cast<float*>(out),
        block_t, max_r, d_out, block_o);
  } else if (dtype == 1) {
    sgmv_multibank_expand_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(h), banks, bb, br, static_cast<bf16*>(out),
        block_t, max_r, d_out, block_o);
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
