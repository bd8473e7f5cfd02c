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
//     h[t, :]   = round_to_T( sum_k x[t, k] * A[k, :] )   (fp32 sums)
//     out[t, c] = round_to_T( sum_j h[t, j] * B[j, c] )   (fp32 sums)
// where (A, B) is the block's adapter (B1: row block_adapter[i] of the
// one bank; B2: row block_row[i] of bank block_bucket[i], at that bank's
// rank). Rounding h to the input type between the two products is part
// of the contract (sgmv.py:125-139). Rows >= nblocks * block_t are never
// written (T_pad need not be a multiple of block_t; ops never reads them).
//
// What bounds it on the H100. At decode a block reads its adapter's A and
// B, 2 * d * r * itemsize bytes (2 MB at d = 4096, r = 128, bf16), and
// does 2 * block_t * r * (d + d_out) FMAs: it is memory-bound when the
// card's bandwidth is shared by enough blocks, but a decode batch gives
// only a handful of blocks, so each block's own compute on one SM is the
// limit of this first version.
//
// Design. One thread block per token block, as the TPU grid's first
// dimension. The block loads its own index (the TPU's scalar prefetch),
// streams A through shared memory in d-chunks while each thread keeps the
// fp32 sums of its (row, column) outputs in registers, rounds h into
// shared memory once, then loops over the output columns (the loop takes
// the place of the TPU's sequential j grid dimension): one thread per
// column, coalesced reads of B's rows, block_t fp32 sums in registers.
// The summation order of an output never depends on the bank's rank, so
// a bucketed bank and the equivalent zero-padded bank give bit-identical
// results. All four kernels run the same two device functions,
// shrink_block and expand_block, so an output's sums and their FMA
// contraction are the same code in each: B3a then B3b equals B1 bit for
// bit, the per-bucket host loop over B3a/B3b equals B2, and B4a then B4b
// equals B2 (at one rank; across ranks the all-reduce reorders the
// d-sum). B3b and B4b tile the
// output columns over a second grid dimension (block_o columns a thread
// block, as the TPU's j dimension), which spreads a token block over
// more SMs and changes no sum. CUDA cores in fp32 only: tensor cores,
// TMA and splitting a block's shrink over several SMs are left to a later
// version. Spare blocks
// (one per adapter, block_adapter = 0) and the empty rows of a partly
// filled block (15 of 16 rows at bucketed decode) are computed and never
// read; skipping them needs a per-block row count, also left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlockT = 16;
constexpr int kMaxRank = 128;
constexpr int kChunk = 32;                 // d-chunk staged per step
constexpr int kMaxBuckets = 8;             // ranks 1..128 in powers of two
// rows of h one shrink thread owns: block_t / (kThreads / r), r <= 128
constexpr int kRowsPerThread = kMaxBlockT * kMaxRank / kThreads;

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

// The shrink of one token block, shared by B1, B2 and B3a:
// hs[t][c] = round_to_T(sum_k x_blk[t, k] * a[k, c]) for t < block_t,
// c < r, held as fp32. Ends with a barrier, so hs is ready to read.
template <typename T>
__device__ void shrink_block(const T* __restrict__ x_blk,
                             const T* __restrict__ a,
                             float (*hs)[kMaxRank], int block_t, int d,
                             int r) {
  __shared__ float xs[kMaxBlockT][kChunk];
  __shared__ float as[kChunk][kMaxRank];

  const int tid = threadIdx.x;
  const int rows_per_pass = kThreads / r;          // >= 2
  const bool active = tid < rows_per_pass * r;
  const int c = tid % r;
  const int t0 = tid / r;

  // fp32 sums in registers
  float acc[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    for (int e = tid; e < block_t * kChunk; e += kThreads) {
      const int t = e / kChunk, kk = e % kChunk;
      xs[t][kk] = kk < kc ? to_f(x_blk[(size_t)t * d + k0 + kk]) : 0.f;
    }
    for (int e = tid; e < kChunk * r; e += kThreads) {
      const int kk = e / r, cc = e % r;
      as[kk][cc] = kk < kc ? to_f(a[(size_t)(k0 + kk) * r + cc]) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        const float av = as[kk][c];
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int t = t0 + m * rows_per_pass;
          if (t < block_t) acc[m] += xs[t][kk] * av;
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int t = t0 + m * rows_per_pass;
      if (t < block_t) hs[t][c] = to_f(from_f<T>(acc[m]));  // h in x's type
    }
  }
  __syncthreads();
}

// The expand of one token block over output columns [col0, col1), shared
// by B1, B2 and B3b: one thread per column, coalesced reads of b's rows,
// block_t fp32 sums in registers, j = 0 .. r-1 in order.
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

// One token block: x_blk (block_t, d), a (d, r), b (r, d_out) ->
// out_blk (block_t, d_out).
template <typename T>
__device__ void fused_block(const T* __restrict__ x_blk,
                            const T* __restrict__ a,
                            const T* __restrict__ b,
                            T* __restrict__ out_blk,
                            int block_t, int d, int r, int d_out) {
  __shared__ float hs[kMaxBlockT][kMaxRank];
  shrink_block<T>(x_blk, a, hs, block_t, d, r);
  expand_block<T>(hs, b, out_blk, block_t, r, d_out, 0, d_out);
}

// Indices come from ops' segment layout, which keeps every adapter id,
// bucket and row in range of the bank it indexes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_fused_blocks_kernel(const T* __restrict__ x, const T* __restrict__ A,
                         const T* __restrict__ B,
                         const int* __restrict__ block_adapter,
                         T* __restrict__ out, int block_t, int d, int r,
                         int d_out) {
  const int i = blockIdx.x;
  const int aid = block_adapter[i];
  fused_block<T>(x + (size_t)i * block_t * d, A + (size_t)aid * d * r,
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
  const int i = blockIdx.x;
  const int bkt = block_bucket[i];
  const int row = block_row[i];
  const int r = banks.rank[bkt];
  const T* a = static_cast<const T*>(banks.A[bkt]) + (size_t)row * d * r;
  const T* b = static_cast<const T*>(banks.B[bkt]) + (size_t)row * r * d_out;
  fused_block<T>(x + (size_t)i * block_t * d, a, b,
                 out + (size_t)i * block_t * d_out, block_t, d, r, d_out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_shrink_kernel(const T* __restrict__ x, const T* __restrict__ A,
                   const int* __restrict__ block_adapter, T* __restrict__ h,
                   int block_t, int d, int r) {
  __shared__ float hs[kMaxBlockT][kMaxRank];
  const int i = blockIdx.x;
  const int aid = block_adapter[i];
  shrink_block<T>(x + (size_t)i * block_t * d, A + (size_t)aid * d * r, hs,
                  block_t, d, r);
  T* h_blk = h + (size_t)i * block_t * r;
  for (int e = threadIdx.x; e < block_t * r; e += kThreads)
    h_blk[e] = from_f<T>(hs[e / r][e % r]);      // exact: hs holds T values
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
  __shared__ float hs[kMaxBlockT][kMaxRank];
  const int i = blockIdx.x;
  const int bkt = block_bucket[i];
  const int r = banks.rank[bkt];
  const T* a = static_cast<const T*>(banks.A[bkt]) +
               (size_t)block_row[i] * d * r;
  shrink_block<T>(x + (size_t)i * block_t * d, a, hs, block_t, d, r);
  T* h_blk = h + (size_t)i * block_t * max_r;
  for (int e = threadIdx.x; e < block_t * max_r; e += kThreads) {
    const int t = e / max_r, c = e % max_r;
    h_blk[e] = from_f<T>(c < r ? hs[t][c] : 0.f);  // exact: hs holds T
  }
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

// B4a / B4b take one bank pointer array (A for the shrink, B for the
// expand) and the buckets' ranks, host arrays of n_buckets entries; every
// rank must lie in 1..max_r, max_r <= 128.
int bank_set(const void* const* ptrs, const int* ranks, int n_buckets,
             int block_t, int max_r, bool is_b, BankSet* banks) {
  if (n_buckets < 1 || n_buckets > kMaxBuckets ||
      !shape_ok(block_t, max_r))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int b = 0; b < n_buckets; ++b) {
    if (!shape_ok(block_t, ranks[b]) || ranks[b] > max_r)
      return static_cast<int>(cudaErrorInvalidValue);
    (is_b ? banks->B : banks->A)[b] = ptrs[b];
    banks->rank[b] = ranks[b];
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int sgmv_fused_blocks_launch(int dtype, const void* x,
                                        const void* A, const void* B,
                                        const void* block_adapter, void* out,
                                        int nblocks, int block_t, int d,
                                        int r, int d_out, void* stream) {
  if (!shape_ok(block_t, r) || nblocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ba = static_cast<const int*>(block_adapter);
  if (dtype == 0) {
    sgmv_fused_blocks_kernel<float><<<nblocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(A),
        static_cast<const float*>(B), ba, static_cast<float*>(out), block_t,
        d, r, d_out);
  } else if (dtype == 1) {
    sgmv_fused_blocks_kernel<__nv_bfloat16><<<nblocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B), ba,
        static_cast<__nv_bfloat16*>(out), block_t, d, r, d_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// A_ptrs / B_ptrs / ranks are host arrays of n_buckets entries.
extern "C" int sgmv_multibank_blocks_launch(
    int dtype, const void* x, const void* const* A_ptrs,
    const void* const* B_ptrs, const int* ranks,
    int n_buckets, const void* block_bucket, const void* block_row,
    void* out, int nblocks, int block_t, int d, int d_out, void* stream) {
  if (n_buckets < 1 || n_buckets > kMaxBuckets || nblocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  for (int b = 0; b < n_buckets; ++b) {
    if (!shape_ok(block_t, ranks[b]))
      return static_cast<int>(cudaErrorInvalidValue);
    banks.A[b] = A_ptrs[b];
    banks.B[b] = B_ptrs[b];
    banks.rank[b] = ranks[b];
  }
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bb = static_cast<const int*>(block_bucket);
  const int* br = static_cast<const int*>(block_row);
  if (dtype == 0) {
    sgmv_multibank_blocks_kernel<float><<<nblocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), banks, bb, br,
        static_cast<float*>(out), block_t, d, d_out);
  } else if (dtype == 1) {
    sgmv_multibank_blocks_kernel<__nv_bfloat16><<<nblocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), banks, bb, br,
        static_cast<__nv_bfloat16*>(out), block_t, d, d_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sgmv_shrink_launch(int dtype, const void* x, const void* A,
                                  const void* block_adapter, void* h,
                                  int nblocks, int block_t, int d, int r,
                                  void* stream) {
  if (!shape_ok(block_t, r) || nblocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ba = static_cast<const int*>(block_adapter);
  if (dtype == 0) {
    sgmv_shrink_kernel<float><<<nblocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(A), ba,
        static_cast<float*>(h), block_t, d, r);
  } else if (dtype == 1) {
    sgmv_shrink_kernel<__nv_bfloat16><<<nblocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(A), ba,
        static_cast<__nv_bfloat16*>(h), block_t, d, r);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
    sgmv_expand_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(B), ba,
        static_cast<__nv_bfloat16*>(out), block_t, r, d_out, block_o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


extern "C" int sgmv_multibank_shrink_launch(
    int dtype, const void* x, const void* const* A_ptrs, const int* ranks,
    int n_buckets, const void* block_bucket, const void* block_row, void* h,
    int nblocks, int block_t, int d, int max_r, void* stream) {
  if (nblocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(A_ptrs, ranks, n_buckets, block_t, max_r,
                               false, &banks))
    return err;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bb = static_cast<const int*>(block_bucket);
  const int* br = static_cast<const int*>(block_row);
  if (dtype == 0) {
    sgmv_multibank_shrink_kernel<float><<<nblocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), banks, bb, br, static_cast<float*>(h),
        block_t, d, max_r);
  } else if (dtype == 1) {
    sgmv_multibank_shrink_kernel<__nv_bfloat16><<<nblocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), banks, bb, br,
        static_cast<__nv_bfloat16*>(h), block_t, d, max_r);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sgmv_multibank_expand_launch(
    int dtype, const void* h, const void* const* B_ptrs, const int* ranks,
    int n_buckets, const void* block_bucket, const void* block_row,
    void* out, int nblocks, int block_t, int max_r, int d_out, int block_o,
    void* stream) {
  if (nblocks < 0 || d_out < 1 || block_o < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BankSet banks{};
  if (const int err = bank_set(B_ptrs, ranks, n_buckets, block_t, max_r,
                               true, &banks))
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
    sgmv_multibank_expand_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h), banks, bb, br,
        static_cast<__nv_bfloat16*>(out), block_t, max_r, d_out, block_o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
