// Hand-written Hopper (sm_90a) flash attention of the PyTorch port.
//
// B5 replaces the Pallas TPU kernel src/repro/kernels/flash.py:flash_mha
//    (pallas_call at :103, body _flash_kernel :32): multi-head attention
//    (H == Kv) with an online softmax in fp32, kv blocks wholly above the
//    causal diagonal skipped. Two kernels serve it, one per input type:
//    flash_mha_bf16_kernel (tensor cores) and flash_mha_kernel<float>
//    (CUDA cores, the parity type).
//
// Contract. q (B, H, Sq, hd), k and v (B, H, Sk, hd), read through their
// strides (the unit stride on hd), so the port's (B, S, H, hd) activations
// need no transpose. For each (b, h) and each query row i < Sq
//     valid  = j < Sk and (not causal or i >= j)     (top-left aligned)
//     o[i]   = sum_j P(p[j]) v[j] / max(sum_j p[j], 1e-30),
//     p[j]   = exp(s[j] - max_valid s)  for valid j, 0 otherwise,
// computed kv block by kv block as flash.py does: running max m (starting
// at the -1e30 sentinel), running sum l and fp32 accumulator acc rescaled
// by exp(m_prev - m_new) at each kv block. A masked score contributes
// exactly 0 to l and acc. The two kernels differ in where they round:
//  - bf16: s[j] = (q[i] . k[j]) * scale, the product's fp32 sum scaled
//    in fp32 (q is never rounded after scaling); l sums the fp32 p; P
//    rounds p to bf16 as the A operand of p.v only (the reference keeps
//    p in fp32: a stated departure of at most 2^-9 relative a weight,
//    held against the plain version on the card).
//  - fp32: s[j] = (q[i] * scale) . k[j], q scaled first; P is the
//    identity.
//
// What bounds it on the H100. The causal square prefill of llama-7b-paper
// (S = 1000, hd = 128) does 4 * hd FLOPs per kept (query, key) pair,
// S (S + 1) / 2 pairs a head, and reads q, k, v and writes o once: about
// S / 4 = 250 FLOPs a byte in bf16, just below the card's ~295 for bf16
// tensor cores, so bytes bound the ideal (0.0196 ms at 2 x 32 heads) and
// the tensor cores come close behind (0.0166 ms). The fp32 kernel runs on
// CUDA cores (~20 FLOPs a byte), where operations bound it.
//
// Design, bf16 (FlashAttention-2's). One block of 4 warps per (q tile,
// head, batch row), q tiles of 64 rows, 16 a warp; the loop over kv tiles
// of 64 keys takes the place of the TPU's sequential fourth grid
// dimension and stops at the diagonal. K and V tiles stay bf16 in shared
// memory, double-buffered: 16-byte cp.async loads of tile n+1 run while
// tile n computes. Each row is padded by 16 bytes so that ldmatrix's 8
// row addresses fall on distinct banks. Both products are
// mma.sync.m16n8k16 (bf16 in, fp32 out): the warp-level tensor-core
// instruction, which needs no warpgroup, descriptors or TMA and keeps the
// whole online softmax in registers; wgmma, TMA and warp specialisation
// are left to a later version. q's fragments are loaded once (ldmatrix),
// K's with ldmatrix, V's with ldmatrix.trans. The scores stay in the fp32
// accumulator fragments; row max and row sum reduce across the 4 threads
// of a quad with __shfl_xor_sync; the score fragment of two adjacent
// 8-key tiles is, packed to bf16 pairs, the A fragment of p.v for that
// 16-key step, so p never touches shared memory. hd pads to a multiple
// of 16 (32, 64 or 128 in the tile) with zeros, which are inert; rows at
// or past Sq and keys at or past Sk load as zeros and are masked or never
// written. About 85 KB of shared memory a block at hd 128: 2 blocks an
// SM. q tiles are issued last-first, so the tiles with the most kv tiles
// start first.
//
// Design, fp32 (the first version's, kept). One block of 256 threads
// per (q block, head, batch row) with bq x bk tiles from the wrapper;
// the q tile (pre-scaled), one k or v tile and the score tile in shared
// memory, each row padded by one float; the threads form a 16 x 16 grid
// and each keeps an 8 x 8 register tile of scores and of the
// accumulator; two threads own each row's softmax update.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"
#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                 // bq, bk and hd at most this
constexpr int kGrid = 16;                  // threads form kGrid x kGrid
constexpr int kPer = kTile / kGrid;        // register tile of a thread
constexpr float kNegInf = -1e30f;          // flash.py:29

// the fp32 kernel's element conversions (it is instantiated for float)
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

struct Strides {                           // elements; passed by value
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

size_t smem_bytes(int bq, int bk, int hd) {
  return sizeof(float) *
         ((size_t)bq * (hd + 1) + (size_t)bk * (hd + 1) +
          (size_t)bq * (bk + 1) + 3 * (size_t)bq);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides st,
                 int Sq, int Sk, int hd, int bq, int bk, int causal,
                 float scale) {
  extern __shared__ float smem[];
  const int ldq = hd + 1, lds = bk + 1;
  float* qs = smem;                        // (bq, hd + 1)
  float* kvs = qs + bq * ldq;              // (bk, hd + 1): k, then v
  float* ss = kvs + bk * ldq;              // (bq, bk + 1): scores, then p
  float* m_s = ss + bq * lds;              // (bq,)
  float* l_s = m_s + bq;
  float* corr_s = l_s + bq;

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / kGrid, tx = tid % kGrid;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const int q0 = iq * bq;

  for (int e = tid; e < bq * hd; e += kThreads) {
    const int r = e / hd, c = e % hd;
    const int qpos = q0 + r;
    qs[r * ldq + c] = qpos < Sq ? to_f(qp[qpos * st.qs + c]) * scale : 0.f;
  }
  for (int r = tid; r < bq; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

  const int nk = (Sk + bk - 1) / bk;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * bk;
    if (causal && k0 > q0 + bq - 1) break;   // this and later: all masked
    __syncthreads();                         // kvs, ss free; qs, m_s ready
    for (int e = tid; e < bk * hd; e += kThreads) {
      const int r = e / hd, c = e % hd;
      const int kpos = k0 + r;
      kvs[r * ldq + c] = kpos < Sk ? to_f(kp[kpos * st.ks + c]) : 0.f;
    }
    __syncthreads();

    // scores: s = q_blk @ k_blk^T, the thread's 8 x 8 tile
    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    for (int c = 0; c < hd; ++c) {
      float qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = ty + kGrid * i;
        qv[i] = r < bq ? qs[r * ldq + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = tx + kGrid * j;
        kv[j] = col < bk ? kvs[col * ldq + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kGrid * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = tx + kGrid * j;
        if (r < bq && col < bk) {
          const int kpos = k0 + col;
          const bool valid = kpos < Sk && (!causal || q0 + r >= kpos);
          ss[r * lds + col] = valid ? s[i][j] : kNegInf;
        }
      }
    }
    __syncthreads();                         // k read, scores written

    // v into the tile k held, while two threads a row update the softmax
    for (int e = tid; e < bk * hd; e += kThreads) {
      const int r = e / hd, c = e % hd;
      const int kpos = k0 + r;
      kvs[r * ldq + c] = kpos < Sk ? to_f(vp[kpos * st.vs + c]) : 0.f;
    }
    {
      const int r = tid / 2, half = tid % 2;
      const bool live = r < bq;
      float* srow = ss + (live ? r : 0) * lds;
      float mx = kNegInf;
      if (live)
        for (int c = half; c < bk; c += 2) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = live ? m_s[r] : kNegInf;
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      if (live)
        for (int c = half; c < bk; c += 2) {
          const float sc = srow[c];
          const float p = sc > kNegInf ? expf(sc - m_new) : 0.f;
          srow[c] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (live && half == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        corr_s[r] = corr;
        m_s[r] = m_new;
      }
    }
    __syncthreads();                         // p, corr and v ready

    // acc = acc * corr + p_blk @ v_blk
    float pv[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) pv[i][j] = 0.f;
    for (int c = 0; c < bk; ++c) {
      float pr[kPer], vr[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = ty + kGrid * i;
        pr[i] = r < bq ? ss[r * lds + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int col = tx + kGrid * j;
        vr[j] = col < hd ? kvs[c * ldq + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) pv[i][j] += pr[i] * vr[j];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kGrid * i;
      const float corr = r < bq ? corr_s[r] : 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = acc[i][j] * corr + pv[i][j];
    }
  }
  __syncthreads();                           // the last l_s update

  T* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kGrid * i;
    const int qpos = q0 + r;
    if (r >= bq || qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = tx + kGrid * j;
      if (col < hd) op[qpos * st.os + col] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int H, int Sq, int Sk, int hd, int bq,
           int bk, int causal, float scale, cudaStream_t s) {
  const size_t bytes = smem_bytes(bq, bk, hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + bq - 1) / bq, H, B);
  flash_mha_kernel<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, Sq, Sk, hd, bq, bk,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;            // 4 warps
constexpr int kTcRows = 64;                // q rows a block, 16 a warp
constexpr int kTcKeys = 64;                // keys a kv tile
constexpr int kRowPad = 8;                 // bf16 padding a shared row

using bf16 = __nv_bfloat16;

size_t tc_smem_bytes(int hdp) {            // q tile, 2 k and 2 v tiles
  return sizeof(bf16) * (size_t)(kTcRows + 4 * kTcKeys) * (hdp + kRowPad);
}

// One 64-row tile, rows row0.. of a (S, hd) slab with row stride rs, into
// shared rows of HDP + kRowPad; rows at or past S and columns at or past
// hd are zero.
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int row0, int S,
                                          int hd) {
  constexpr int kChunks = HDP / 8;         // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kTcKeys * kChunks / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / kChunks, col = (e % kChunks) * 8;
    const int pos = row0 + r;
    const bool live = pos < S && col < hd;
    const bf16* g = live ? src + pos * rs + col : src;
    cp_async_16(dst + r * (HDP + kRowPad) + col, g,
                live ? 2 * min(8, hd - col) : 0);
  }
}

template <int HDP>
__global__ void __launch_bounds__(kTcThreads)
flash_mha_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      Strides st, int Sq, int Sk, int hd, int causal,
                      float scale) {
  constexpr int LD = HDP + kRowPad;
  constexpr int kSteps = HDP / 16;         // k-steps of q.k
  constexpr int kOutTiles = HDP / 8;       // 8-column tiles of o
  constexpr int kKV = kTcKeys * LD;        // elements of one k or v tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);    // (64, LD)
  bf16* ks = qs + kTcRows * LD;                    // 2 x (64, LD)
  bf16* vs = ks + 2 * kKV;                         // 2 x (64, LD)

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row, column pair
  const int q0 = iq * kTcRows;
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  // the two query positions whose fragment entries this thread holds
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;

  int nk = (Sk + kTcKeys - 1) / kTcKeys;
  if (causal)                              // the last tile the tile's
    nk = min(nk, (min(q0 + kTcRows, Sq) - 1) / kTcKeys + 1);   // rows see

  load_tile<HDP>(qs, qp, st.qs, q0, Sq, hd);
  load_tile<HDP>(ks, kp, st.ks, 0, Sk, hd);
  load_tile<HDP>(vs, vp, st.vs, 0, Sk, hd);
  cp_async_commit();

  unsigned qf[kSteps][4];
  float acc[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < nk; ++it) {
    const int stage = it & 1;
    if (it + 1 < nk) {                     // the next tile, into the
      load_tile<HDP>(ks + (stage ^ 1) * kKV, kp, st.ks,   // other stage
                     (it + 1) * kTcKeys, Sk, hd);
      load_tile<HDP>(vs + (stage ^ 1) * kKV, vp, st.vs,
                     (it + 1) * kTcKeys, Sk, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();                    // tile it (and q) landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * LD +
                                kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = ks + stage * kKV;
    const bf16* vt = vs + stage * kKV;
    const int k0 = it * kTcKeys;

    // s = q k^T: 8 tiles of 8 keys, fp32 fragments
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {     // key tiles 2 jp and 2 jp + 1
        unsigned bk[4];
        ldmatrix_x4(bk, kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }

    // scale in fp32, mask where the tile crosses the diagonal or Sk
    const bool edge = k0 + kTcKeys > Sk ||
                      (causal && k0 + kTcKeys - 1 > q0 + warp * 16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = s[j][e] * scale;
        if (edge) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          s[j][e] = key < Sk && (!causal || row >= key) ? sc : kNegInf;
        } else {
          s[j][e] = sc;
        }
      }

    // online softmax on the thread's two rows; a row spans a quad
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = __expf(m_run[r] - mx);
      m_run[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = s[j][e] > kNegInf ? __expf(s[j][e] - mx) : 0.f;
          s[j][e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * corr[r] + sum;   // l sums the fp32 p
    }
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P(p) v: key tiles 2 kk and 2 kk + 1 form the A fragment of
    // the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kOutTiles / 2; ++np) {   // o columns 16 np..
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                       // this stage is refilled next
  }
  cp_async_wait<0>();

  bf16* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    bf16* orow = op + row * st.os;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      const int col = n * 8 + 2 * t4;
      const float lo = acc[n][2 * r] * inv, hi = acc[n][2 * r + 1] * inv;
      if (col + 1 < hd && (hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < hd) orow[col] = __float2bfloat16(lo);
        if (col + 1 < hd) orow[col + 1] = __float2bfloat16(hi);
      }
    }
  }
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Strides& st, int B, int H, int Sq, int Sk, int hd,
                int causal, float scale, cudaStream_t s) {
  const size_t bytes = tc_smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_bf16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTcRows - 1) / kTcRows, H, B);
  flash_mha_bf16_kernel<HDP><<<grid, kTcThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), st, Sq, Sk, hd,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// cp.async moves 16-byte chunks: every row start of q, k and v must be
// 16-byte aligned (o is written in 2- or 4-byte pieces)
bool rows_aligned(const void* p, const long long* st3) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (st3[i] % 8) return false;          // 8 bf16 = 16 bytes
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 host values, in elements,
// of q, k, v and o over (b, h, s) in that order. bq and bk tile the fp32
// kernel (each 1..128); the bf16 kernel's tiles are its own (64 x 64) and
// it needs 16-byte aligned rows. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int flash_mha_launch(int dtype, const void* q, const void* k,
                                const void* v, void* o,
                                const long long* strides, int B, int H,
                                int Sq, int Sk, int hd, int bq, int bk,
                                int causal, float scale, void* stream) {
  if (B < 0 || H < 0 || Sq < 0 || Sk < 1 || hd < 1 || hd > kTile ||
      bq < 1 || bq > kTile || bk < 1 || bk > kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && !(rows_aligned(q, strides) &&
                      rows_aligned(k, strides + 3) &&
                      rows_aligned(v, strides + 6)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, st, B, H, Sq, Sk, hd, bq, bk, causal,
                         scale, s);
  if (dtype == 1) {                        // hd pads to 32, 64 or 128
    if (hd <= 32)
      return launch_bf16<32>(q, k, v, o, st, B, H, Sq, Sk, hd, causal,
                             scale, s);
    if (hd <= 64)
      return launch_bf16<64>(q, k, v, o, st, B, H, Sq, Sk, hd, causal,
                             scale, s);
    return launch_bf16<128>(q, k, v, o, st, B, H, Sq, Sk, hd, causal, scale,
                            s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The resources of one B5 kernel instantiation (kernel 0: the fp32
// kernel at tiles bq x bk and head dim hd; 1: the bf16 kernel for hd,
// padded to 32, 64 or 128) and the dynamic shared memory its launcher
// sets, into out[0..4]. Returns a CUDA error code.
extern "C" int flash_kernel_resources(int kernel, int hd, int bq, int bk,
                                      long long* out) {
  if (hd < 1 || hd > kTile || bq < 1 || bq > kTile || bk < 1 || bk > kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel == 0)
    return func_resources(flash_mha_kernel<float>, smem_bytes(bq, bk, hd),
                          out);
  if (kernel != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32)
    return func_resources(flash_mha_bf16_kernel<32>, tc_smem_bytes(32), out);
  if (hd <= 64)
    return func_resources(flash_mha_bf16_kernel<64>, tc_smem_bytes(64), out);
  return func_resources(flash_mha_bf16_kernel<128>, tc_smem_bytes(128), out);
}
