// Hand-written Hopper (sm_90a) flash attention of the PyTorch port.
//
// B5 flash_mha_kernel replaces the Pallas TPU kernel
//    src/repro/kernels/flash.py:flash_mha (pallas_call at :103, body
//    _flash_kernel :32): multi-head attention (H == Kv) with an online
//    softmax in fp32, kv blocks wholly above the causal diagonal skipped.
//
// Contract. q (B, H, Sq, hd), k and v (B, H, Sk, hd), read through their
// strides (the unit stride on hd), so the port's (B, S, H, hd) activations
// need no transpose. For each (b, h) and each query row i < Sq
//     s[j]   = (q[i] * scale) . k[j]                 (fp32, q scaled first)
//     valid  = j < Sk and (not causal or i >= j)     (top-left aligned)
//     o[i]   = sum_j p[j] v[j] / max(sum_j p[j], 1e-30),
//     p[j]   = exp(s[j] - max_valid s)  for valid j, 0 otherwise
// computed block by block as flash.py does: q blocks of bq rows, kv blocks
// of bk keys, running max m (starting at the -1e30 sentinel), running sum
// l and fp32 accumulator acc rescaled by exp(m_prev - m_new) at each kv
// block. A masked score contributes exactly 0 to l and acc, so a row with
// no valid key in a running block (possible when bq != bk, and for the
// padded rows past Sq) leaves its state as it was.
//
// What bounds it on the H100. The causal square prefill of llama-7b-paper
// (S = 1000, hd = 128) does 4 * hd FLOPs per kept (query, key) pair,
// S (S + 1) / 2 pairs a head, and reads q, k, v and writes o once: about
// S / 4 = 250 FLOPs a byte in bf16, just below the card's ~295 for bf16
// tensor cores (so bytes bound the ideal), far above its ~20 for fp32
// CUDA cores. This first version computes in fp32 on CUDA cores, so in
// practice operations bound it.
//
// Design. One thread block of 256 threads per (q block, head, batch row),
// the first three dimensions of the TPU grid; the loop over kv blocks
// takes the place of the TPU's sequential fourth dimension, and it stops
// at the first block wholly above the diagonal (flash.py:48). The q tile
// (pre-scaled, fp32), one k or v tile and the score tile live in shared
// memory, each row padded by one float so that the column reads of a warp
// fall on distinct banks; the threads form a 16 x 16 grid and each keeps
// an 8 x 8 register tile of scores and of the output accumulator (rows
// ty + 16 i, columns tx + 16 j). Two threads own each row's softmax
// update. q blocks are issued last-first, so the blocks with the most kv
// blocks start first. Tensor cores (wgmma), TMA and several thread blocks
// an SM are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                 // bq, bk and hd at most this
constexpr int kGrid = 16;                  // threads form kGrid x kGrid
constexpr int kPer = kTile / kGrid;        // register tile of a thread
constexpr float kNegInf = -1e30f;          // flash.py:29

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
  return __float2bfloat16(v);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 host values, in elements,
// of q, k, v and o over (b, h, s) in that order. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int flash_mha_launch(int dtype, const void* q, const void* k,
                                const void* v, void* o,
                                const long long* strides, int B, int H,
                                int Sq, int Sk, int hd, int bq, int bk,
                                int causal, float scale, void* stream) {
  if (B < 0 || H < 0 || Sq < 0 || Sk < 1 || hd < 1 || hd > kTile ||
      bq < 1 || bq > kTile || bk < 1 || bk > kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, st, B, H, Sq, Sk, hd, bq, bk, causal,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, st, B, H, Sq, Sk, hd, bq, bk,
                                 causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
