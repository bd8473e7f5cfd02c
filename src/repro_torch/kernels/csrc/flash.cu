// Hand-written Hopper (sm_90a) flash attention of the PyTorch port.
//
// B5 replaces the Pallas TPU kernel src/repro/kernels/flash.py:flash_mha
//    (pallas_call at :103, body _flash_kernel :32): multi-head attention
//    (H == Kv) with an online softmax in fp32, kv blocks wholly above the
//    causal diagonal skipped. Two kernels serve it, one per input type,
//    both on the tensor cores: flash_mha_bf16_kernel<HDP> (bf16 products)
//    and flash_mha_kernel<HDP> (fp32, each product as three TF32 ones).
//
// Contract. q (B, H, Sq, hd), k and v (B, H, Sk, hd), read through their
// strides (the unit stride on hd), so the port's (B, S, H, hd) activations
// need no transpose. For each (b, h) and each query row i < Sq
//     valid  = j < Sk and (not causal or i >= j)     (top-left aligned)
//     o[i]   = sum_j P(p[j]) v[j] / max(sum_j p[j], 1e-30),
//     p[j]   = exp(s[j] - max_valid s)  for valid j, 0 otherwise,
// computed kv tile by kv tile as flash.py does: running max m (starting
// at the -1e30 sentinel), running sum l and fp32 accumulator acc rescaled
// by exp(m_prev - m_new) at each kv tile. A masked score contributes
// exactly 0 to l and acc. The two kernels differ in where they round:
//  - bf16: s[j] = (q[i] . k[j]) * scale, the product's fp32 sum scaled
//    in fp32 (q is never rounded after scaling); l sums the fp32 p; P
//    rounds p to bf16 as the A operand of p.v only (the reference keeps
//    p in fp32: a stated departure of at most 2^-9 relative a weight,
//    held against the plain version on the card).
//  - fp32: s[j] = (q[i] * scale) . k[j], q scaled first in fp32; P is the
//    identity. Both products run as 3xTF32: each fp32 operand x splits
//    into big = tf32(x) and small = tf32(x - big) (tf32: round to nearest,
//    ties away from zero, cvt.rna), and a.b is summed as a_small.b_big +
//    a_big.b_small + a_big.b_big into one fp32 accumulator, 8 terms an
//    mma. The term a_small.b_small (at most 2^-22 relative a product) is
//    dropped, and each mma sums its 8 products in the tensor core's own
//    order: a stated departure from the reference's fp32 products, about
//    fp32's own rounding, held against the plain version at 1e-4 on the
//    card. No product runs as a single TF32 pass.
//
// What bounds it on the H100. The causal square prefill of llama-7b-paper
// (S = 1000, hd = 128) does 4 * hd FLOPs per kept (query, key) pair,
// S (S + 1) / 2 pairs a head, and reads q, k, v and writes o once: about
// S / 4 = 250 FLOPs a byte in bf16, just below the card's ~295 for bf16
// tensor cores, so bytes bound the ideal (0.0196 ms at 2 x 32 heads) and
// the tensor cores come close behind (0.0166 ms). In fp32 the bytes
// double (S / 8 = 125 FLOPs a byte) and each FLOP costs three TF32 ones:
// at the data sheet's 495 TFLOP/s dense TF32, 165 TFLOP/s of fp32-accurate
// products, whose balance point is ~49 FLOPs a byte, so operations bound
// every fp32 call of the port (seamless's encoder, 2 x 16 heads x 1024
// frames at hd 64: 0.052 ms, against 0.128 ms at the 67 TFLOP/s of the
// CUDA cores).
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
// Design, fp32 (the bf16 kernel's shape, on mma.sync.m16n8k8.tf32). The
// same blocks, warps, q tiles (64 rows, issued last-first) and kv loop;
// kv tiles of 64 keys at HDP 32 and 64 and of 32 keys at HDP 128, so
// that q (pre-scaled in place once it lands) and two stages of K and V,
// all fp32 in shared memory, leave room for 2 blocks an SM at every HDP
// (105 KB a block at HDP 128). 16-byte cp.async loads tile n+1 while
// tile n computes. Fragments are read as float4s, which the mma's own
// fragment layouts do not give, so two sums run in a permuted order
// (each a sum over the same terms):
//  - q.k: within each 16-column chunk of hd, the k index (step 2c, t)
//    is column 4t, (2c, t + 4) column 4t + 1, (2c + 1, t) 4t + 2 and
//    (2c + 1, t + 4) 4t + 3, for q and k alike: one float4 of a q row
//    and one of a k row give thread t its A and B fragments of both
//    k-steps. q and k rows are padded by 16 floats, so a quarter warp's
//    float4s fall on distinct banks.
//  - p.v: the score fragment of an 8-key tile holds keys 2t and 2t + 1
//    of thread t; taken as the A fragment with k index t as key 2t and
//    t + 4 as key 2t + 1, it needs no shuffle and p never touches shared
//    memory, and v's B fragment reads keys 2t and 2t + 1 to match. Output
//    column n of the four 8-column tiles of a 32-column group is 4n + j
//    of tile j, so one float4 of a v row gives lane g its B values of all
//    four tiles; v rows are padded by 4 floats (distinct banks), and each
//    thread ends holding 8 adjacent output columns of each of its two
//    rows, stored as two float4s.
// Each operand is split into big and small TF32 halves right before its
// mma (k and v by each of the 4 warps that read them). The scores stay in
// the accumulator fragments; the online softmax is the bf16 kernel's,
// with the fp32 scale applied to q instead of s. On the H100, 32-key
// tiles at HDP 64 (3 blocks an SM), a separate accumulator for the small
// terms and other mma orders measured slower or level (PERF.md). hd pads
// to 32, 64 or 128 with zeros, which are inert. Under the causal mask a
// warp whose 16 rows all precede a kv tile's first key skips that tile
// (a no-op on m, l and acc). The grid is (ceil(Sq / 64), H, B): the kv
// loop is not split across blocks, so a call of fewer than 2 x 132
// blocks leaves SMs idle (the tp = 2 cross call, 4 x 8 heads x 2 q
// tiles: 64 blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"
#include "resources.cuh"

namespace {

constexpr int kTile = 128;                 // hd (and block_q, block_k) at most
constexpr float kNegInf = -1e30f;          // flash.py:29

struct Strides {                           // elements; passed by value
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

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

// ---------------------------------------------------------------------------
// fp32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 64;               // keys a kv tile at HDP 32, 64
constexpr int kF32WideKeys = 32;           // at HDP 128: 2 blocks an SM
constexpr int kF32Pad = 16;                // floats padding a q or k row
constexpr int kF32VPad = 4;                // floats padding a v row

__host__ __device__ constexpr int f32_keys(int hdp) {
  return hdp > 64 ? kF32WideKeys : kF32Keys;
}

size_t f32_smem_bytes(int hdp) {           // q tile, 2 k and 2 v tiles
  const int keys = f32_keys(hdp);
  return sizeof(float) * ((size_t)(kTcRows + 2 * keys) * (hdp + kF32Pad) +
                          (size_t)2 * keys * (hdp + kF32VPad));
}

// ROWS rows, row0.. of a (S, hd) fp32 slab with row stride rs, into
// shared rows of LD floats; rows at or past S and columns at or past hd
// are zero.
template <int HDP, int ROWS, int LD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long rs, int row0, int S,
                                              int hd) {
  constexpr int kChunks = HDP / 4;         // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / kChunks, col = (e % kChunks) * 4;
    const int pos = row0 + r;
    const bool live = pos < S && col < hd;
    const float* g = live ? src + pos * rs + col : src;
    cp_async_16(dst + r * LD + col, g, live ? 4 * min(4, hd - col) : 0);
  }
}

template <int HDP>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides st, int Sq, int Sk, int hd, int causal, float scale,
                 int vec_o) {
  constexpr int NK = f32_keys(HDP);
  constexpr int LDK = HDP + kF32Pad;       // q and k rows
  constexpr int LDV = HDP + kF32VPad;      // v rows
  constexpr int kChunks = HDP / 16;        // of q.k: two k-steps each
  constexpr int kKeyTiles = NK / 8;
  constexpr int kGroups = HDP / 32;        // of o: four 8-column tiles each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (64, LDK)
  float* ks = qs + kTcRows * LDK;                   // 2 x (NK, LDK)
  float* vs = ks + 2 * NK * LDK;                    // 2 x (NK, LDV)

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row, k index
  const int q0 = iq * kTcRows;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  // the two query positions whose fragment entries this thread holds
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const int warp_last = q0 + warp * 16 + 15;
  float* qw = qs + warp * 16 * LDK;        // the warp's 16 rows of q

  int nk = (Sk + NK - 1) / NK;
  if (causal)                              // the last tile the tile's
    nk = min(nk, (min(q0 + kTcRows, Sq) - 1) / NK + 1);   // rows see

  load_rows_f32<HDP, kTcRows, LDK>(qs, qp, st.qs, q0, Sq, hd);
  load_rows_f32<HDP, NK, LDK>(ks, kp, st.ks, 0, Sk, hd);
  load_rows_f32<HDP, NK, LDV>(vs, vp, st.vs, 0, Sk, hd);
  cp_async_commit();

  float acc[4 * kGroups][4];
#pragma unroll
  for (int n = 0; n < 4 * kGroups; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < nk; ++it) {
    const int stage = it & 1;
    if (it + 1 < nk) {                     // the next tile, into the
      load_rows_f32<HDP, NK, LDK>(ks + (stage ^ 1) * NK * LDK, kp, st.ks,
                                  (it + 1) * NK, Sk, hd);   // other stage
      load_rows_f32<HDP, NK, LDV>(vs + (stage ^ 1) * NK * LDV, vp, st.vs,
                                  (it + 1) * NK, Sk, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();                    // tile it (and q) landed
    __syncthreads();
    if (it == 0) {                         // q * scale in fp32, once; a
      for (int e = lane; e < 16 * HDP; e += 32)   // warp reads only its
        qw[(e / HDP) * LDK + e % HDP] *= scale;   // own rows
      __syncwarp();
    }
    const int k0 = it * NK;
    if (!(causal && k0 > warp_last)) {     // else every key is masked
      const float* kt = ks + stage * NK * LDK;
      const float* vt = vs + stage * NK * LDV;

      // s = (q scale) k^T: kKeyTiles tiles of 8 keys, fp32 fragments
      float s[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 ql = *reinterpret_cast<const float4*>(
            qw + g * LDK + 16 * c + 4 * t4);
        const float4 qh = *reinterpret_cast<const float4*>(
            qw + (g + 8) * LDK + 16 * c + 4 * t4);
        unsigned ab0[4], as0[4], ab1[4], as1[4];  // k-steps 2c, 2c + 1
        split_tf32(ql.x, ab0[0], as0[0]);
        split_tf32(qh.x, ab0[1], as0[1]);
        split_tf32(ql.y, ab0[2], as0[2]);
        split_tf32(qh.y, ab0[3], as0[3]);
        split_tf32(ql.z, ab1[0], as1[0]);
        split_tf32(qh.z, ab1[1], as1[1]);
        split_tf32(ql.w, ab1[2], as1[2]);
        split_tf32(qh.w, ab1[3], as1[3]);
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kt + (j * 8 + g) * LDK + 16 * c + 4 * t4);
          unsigned bb[4], bs[4];
          split_tf32(kv.x, bb[0], bs[0]);
          split_tf32(kv.y, bb[1], bs[1]);
          split_tf32(kv.z, bb[2], bs[2]);
          split_tf32(kv.w, bb[3], bs[3]);
          mma_3xtf32(s[j], ab0, as0, bb[0], bb[1], bs[0], bs[1]);
          mma_3xtf32(s[j], ab1, as1, bb[2], bb[3], bs[2], bs[3]);
        }
      }

      // mask where the tile crosses the diagonal or Sk
      const bool edge = k0 + NK > Sk ||
                        (causal && k0 + NK - 1 > q0 + warp * 16);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * t4 + (e & 1);
            const int row = e < 2 ? row_lo : row_hi;
            if (!(key < Sk && (!causal || row >= key))) s[j][e] = kNegInf;
          }
      }

      // online softmax on the thread's two rows; a row spans a quad
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[r];
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[r] = __expf(m_run[r] - mx);
        m_run[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = s[j][e] > kNegInf ? __expf(s[j][e] - mx) : 0.f;
            s[j][e] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run[r] = l_run[r] * corr[r] + sum;
      }
#pragma unroll
      for (int n = 0; n < 4 * kGroups; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // acc += p v: key tile kk's fragment, k index t as key 2t and t + 4
      // as key 2t + 1, is the A fragment of 8-key step kk
#pragma unroll
      for (int kk = 0; kk < kKeyTiles; ++kk) {
        unsigned pb[4], ps[4];
        split_tf32(s[kk][0], pb[0], ps[0]);
        split_tf32(s[kk][2], pb[1], ps[1]);
        split_tf32(s[kk][1], pb[2], ps[2]);
        split_tf32(s[kk][3], pb[3], ps[3]);
        const float* v0 = vt + (kk * 8 + 2 * t4) * LDV + 4 * g;
#pragma unroll
        for (int grp = 0; grp < kGroups; ++grp) {
          const float4 lo = *reinterpret_cast<const float4*>(v0 + 32 * grp);
          const float4 hi =
              *reinterpret_cast<const float4*>(v0 + LDV + 32 * grp);
          const float vl[4] = {lo.x, lo.y, lo.z, lo.w};
          const float vh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {    // o tile j: columns 4n + j
            unsigned b0b, b0s, b1b, b1s;
            split_tf32(vl[j], b0b, b0s);
            split_tf32(vh[j], b1b, b1s);
            mma_3xtf32(acc[4 * grp + j], pb, ps, b0b, b1b, b0s, b1s);
          }
        }
      }
    }
    __syncthreads();                       // this stage is refilled next
  }
  cp_async_wait<0>();

  // acc[4 grp + j][2 r + half] is column 32 grp + 8 t + 4 half + j
  float* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_lo : row_hi;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    float* orow = op + row * st.os;
#pragma unroll
    for (int grp = 0; grp < kGroups; ++grp)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 32 * grp + 8 * t4 + 4 * half;
        const float4 val = {acc[4 * grp][2 * r + half] * inv,
                            acc[4 * grp + 1][2 * r + half] * inv,
                            acc[4 * grp + 2][2 * r + half] * inv,
                            acc[4 * grp + 3][2 * r + half] * inv};
        if (vec_o && col + 4 <= hd) {
          *reinterpret_cast<float4*>(orow + col) = val;
        } else {
          if (col < hd) orow[col] = val.x;
          if (col + 1 < hd) orow[col + 1] = val.y;
          if (col + 2 < hd) orow[col + 2] = val.z;
          if (col + 3 < hd) orow[col + 3] = val.w;
        }
      }
  }
}

template <int HDP>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Strides& st, int B, int H, int Sq, int Sk, int hd,
               int causal, float scale, int vec_o, cudaStream_t s) {
  const size_t bytes = f32_smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mha_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTcRows - 1) / kTcRows, H, B);
  flash_mha_kernel<HDP><<<grid, kTcThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, Sq, Sk, hd,
      causal, scale, vec_o);
  return static_cast<int>(cudaGetLastError());
}

// cp.async moves 16-byte chunks: every row start of q, k and v must be
// 16-byte aligned (per16 elements: 4 fp32, 8 bf16)
bool rows_aligned(const void* p, const long long* st3, int per16) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (st3[i] % per16) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 host values, in elements,
// of q, k, v and o over (b, h, s) in that order. Each kernel runs its own
// tiles, and both need 16-byte aligned rows of q, k and v; the fp32
// kernel stores o in float4s where o's rows are aligned too (else float
// by float; bf16 writes 2- or 4-byte pieces). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernels do
// not take).
extern "C" int flash_mha_launch(int dtype, const void* q, const void* k,
                                const void* v, void* o,
                                const long long* strides, int B, int H,
                                int Sq, int Sk, int hd, int causal,
                                float scale, void* stream) {
  if (B < 0 || H < 0 || Sq < 0 || Sk < 1 || hd < 1 || hd > kTile ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per16 = dtype == 0 ? 4 : 8;
  if (!(rows_aligned(q, strides, per16) &&
        rows_aligned(k, strides + 3, per16) &&
        rows_aligned(v, strides + 6, per16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {                        // hd pads to 32, 64 or 128
    const int vec_o = rows_aligned(o, strides + 9, 4);
    if (hd <= 32)
      return launch_f32<32>(q, k, v, o, st, B, H, Sq, Sk, hd, causal, scale,
                            vec_o, s);
    if (hd <= 64)
      return launch_f32<64>(q, k, v, o, st, B, H, Sq, Sk, hd, causal, scale,
                            vec_o, s);
    return launch_f32<128>(q, k, v, o, st, B, H, Sq, Sk, hd, causal, scale,
                           vec_o, s);
  }
  if (hd <= 32)
    return launch_bf16<32>(q, k, v, o, st, B, H, Sq, Sk, hd, causal, scale,
                           s);
  if (hd <= 64)
    return launch_bf16<64>(q, k, v, o, st, B, H, Sq, Sk, hd, causal, scale,
                           s);
  return launch_bf16<128>(q, k, v, o, st, B, H, Sq, Sk, hd, causal, scale, s);
}

// The resources of one B5 kernel instantiation (kernel 0: the fp32
// kernel, 1: the bf16 kernel, each for hd padded to 32, 64 or 128) and
// the dynamic shared memory its launcher sets, into out[0..4]. Returns a
// CUDA error code.
extern "C" int flash_kernel_resources(int kernel, int hd, long long* out) {
  if (hd < 1 || hd > kTile || (kernel != 0 && kernel != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kernel == 0) {
    if (hd <= 32)
      return func_resources(flash_mha_kernel<32>, f32_smem_bytes(32), out);
    if (hd <= 64)
      return func_resources(flash_mha_kernel<64>, f32_smem_bytes(64), out);
    return func_resources(flash_mha_kernel<128>, f32_smem_bytes(128), out);
  }
  if (hd <= 32)
    return func_resources(flash_mha_bf16_kernel<32>, tc_smem_bytes(32), out);
  if (hd <= 64)
    return func_resources(flash_mha_bf16_kernel<64>, tc_smem_bytes(64), out);
  return func_resources(flash_mha_bf16_kernel<128>, tc_smem_bytes(128), out);
}
