// Bidirectional vision-language cross-attention (GLIP's X-MHA), eval only.
//
// Replaces three TPU kernels of mqdet_tpu/ops/pallas/bi_attention_pallas.py:
// _kernel (:42, launched at :384 by _flash_bi_attention_jit) in its
// single-score (K3) and dual-score (K3b) forms, and _kernel_carry (K4, :142,
// launched at :252 by _flash_bi_attention_carry_jit, one call per FPN level).
// Per batch row and head, with s = q . k^T (N vision x T text tokens, q
// pre-scaled):
//     out_v = softmax_T(s + bias_l) . vl      (vision attends to text)
//     out_l = softmax_N(s^T) . vv             (text attends to vision)
//
// What bounds K3 and K3b on the H100. At GLIP's shape (B 4, N 22400, T 256,
// 8 heads of D 256) q, vv and out_v are 1.11 GB of traffic, 0.332 ms at
// 3.35 TB/s, and the function's least work, one score product shared by both
// sides (6 B N T E flops, the TPU kernel's single-score form), takes 0.285 ms
// at 989 TFLOP/s: the function is bytes bound. The TPU kernel shares the
// score product by keeping the l side's heads x T x D fp32 accumulator in
// VMEM; one head's 256 x 256 fp32 accumulator (256 KB) alone exceeds a
// block's 227 KB, so here the l side recomputes s^T = k . q^T and the tensor
// work is 8 B N T E (0.380 ms at peak). The design runs that work on the
// tensor cores with the accumulators in registers:
//
// Both sides are one flash-attention forward of head width 256, run by one
// device routine (bi_attn_wgmma_kernel) with different pointers:
//   v role: queries a 128-row tile of q, keys k, values vl, additive key
//      bias bias_l; the online softmax runs over T; out_v = acc / den.
//   l role: queries a 128-row tile of k (text), keys q, values vv, no bias;
//      the online softmax runs over one of S contiguous ranges of N (S from
//      the host's l_splits, so that the l blocks fill two waves of 132 SMs);
//      the block writes its unnormalised fp32 partial (m, den, acc) to
//      scratch, and bi_attn_combine_kernel takes
//      out_l = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) den_s, M = max m_s
//      (a range that got no rows has (m, den, acc) = (NEG, 0, 0), weight 0).
// A block is one producer warpgroup and two consumer warpgroups of 64 query
// rows (setmaxnreg 24 / 240):
//   - the producer's one thread fills a 2-stage ring of (K, V) chunks of 64
//     rows by TMA (3-D tensor maps (E, rows, B), 64 x 64 boxes, 128-byte
//     swizzle; a head is the 256 columns at h * 256), with mbarrier full
//     (K and V apart) and empty pairs; the 128 x 256 query tile is loaded
//     once. Rows past a batch item's end are zero-filled, never the next
//     item's: the l role masks their scores to NEG (a zero row scores 0);
//   - each consumer runs S = Q . K^T as m64n64k16 wgmma from shared memory
//     (both operands K-major), the online softmax on the S fragment in
//     registers, and O += P . V as m64n256k16 wgmma with P converted to bf16
//     in registers and V MN-major (the transposed B). The 64 x 256 fp32 O
//     (128 registers a thread) and the statistics stay in registers for the
//     whole tile.
// One launch holds both roles, the l-split blocks first (the T tiles of one
// (b, h, split) together, so their q / vv chunks come from device memory
// about once), then the v blocks (the N tiles of one (b, h) together); then
// the combine. Numerics as the plain versions: bf16 in and out, fp32 scores,
// statistics and accumulation, P cast to bf16 before the value product, NEG =
// -1e30 finite. A 64-token chunk whose text is wholly masked (bias -9e15),
// the first included, leaves the full softmax's result; a row whose tokens
// are all masked gives the uniform average. Both C entry points (K3 and K3b)
// launch the same kernels, so their outputs are bitwise equal.
//
// K4 (mqdet_bi_attention_carry_forward): ONE launch per FPN level,
// bi_attn_carry_kernel, on WMMA bf16 without pipelining. Its 1-D grid holds
// two block roles over this level's rows only: the T/64 x heads x B l tiles
// first (l_tile: 64 text rows load their rows of the carried fp32 state (m,
// den, acc of shapes (B, H, T), (B, H, T), (B, H, T, D)), run the online
// softmax over the level with a 64 x D accumulator in shared memory,
// recomputing s^T = k . q^T, and store the state back unnormalised, in
// place; the wrapper takes out_l = acc / den after the last level), then the
// N/64 x heads x B v tiles (v_tile: a 64-row tile of q against all T, the
// row softmax with bias_l, out_v = p . vl).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 256;        // head width (E / heads); the only width compiled
constexpr float NEG = -1e30f;

// ---- K4: WMMA tiles ------------------------------------------------------

constexpr int TILE = 64;      // rows of q (v tile) / rows of text (l tile) per block
constexpr int THREADS = 256;  // 8 warps
constexpr int LDH = D + 8;    // bf16 leading dimension of a 64 x D (or 64 x T) tile
constexpr int LDS = D + 4;    // fp32 leading dimension of a 64 x T (or 64 x D) tile
constexpr int LDT = TILE + 4; // fp32 leading dimension of a 64 x 64 score tile
constexpr int LDE = TILE + 8; // bf16 leading dimension of a 64 x 64 probability tile

// v tile shared memory: [q tile, later p] [k / vl chunk] [scores, later out staging]
constexpr size_t V_QP = 0;
constexpr size_t V_KV = V_QP + sizeof(__nv_bfloat16) * TILE * LDH;
constexpr size_t V_S = V_KV + sizeof(__nv_bfloat16) * TILE * LDH;
constexpr size_t V_SMEM = V_S + sizeof(float) * TILE * LDS;

// l tile shared memory: [k tile] [q / vv chunk] [score tile] [prob tile] [acc] [stats]
constexpr size_t L_K = 0;
constexpr size_t L_X = L_K + sizeof(__nv_bfloat16) * TILE * LDH;
constexpr size_t L_S = L_X + sizeof(__nv_bfloat16) * TILE * LDH;
constexpr size_t L_E = L_S + sizeof(float) * TILE * LDT;
constexpr size_t L_ACC = L_E + sizeof(__nv_bfloat16) * TILE * LDE;
constexpr size_t L_STAT = L_ACC + sizeof(float) * TILE * LDS;
constexpr size_t L_SMEM = L_STAT + sizeof(float) * 3 * TILE;

// a launch that holds both roles
constexpr size_t FUSED_SMEM = V_SMEM > L_SMEM ? V_SMEM : L_SMEM;

// Copy rows [r0, r0 + 64) x columns [col0, col0 + D) of a row-major (rows, ld)
// bf16 matrix into a shared tile with leading dimension LDH; rows >= rows are 0.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long r0, long long rows, long long ld,
                                          long long col0) {
  for (int v = threadIdx.x; v < TILE * (D / 8); v += THREADS) {
    const int r = v / (D / 8);
    const int c = (v % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// out_v rows [n0, n0 + 64) of head h, batch row b.
__device__ __forceinline__ void v_tile(unsigned char* smem,
                                       const __nv_bfloat16* __restrict__ q,   // (B, N, E) pre-scaled
                                       const __nv_bfloat16* __restrict__ k,   // (B, T, E)
                                       const __nv_bfloat16* __restrict__ vl,  // (B, T, E)
                                       const float* __restrict__ bias,        // (B, T)
                                       __nv_bfloat16* __restrict__ out_v,     // (B, N, E)
                                       int N, int T, int E, long long n0, int h, int b) {
  __nv_bfloat16* qp = reinterpret_cast<__nv_bfloat16*>(smem + V_QP);
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem + V_KV);
  float* s = reinterpret_cast<float*>(smem + V_S);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long col0 = (long long)h * D;
  const __nv_bfloat16* qb = q + (long long)b * N * E;
  const __nv_bfloat16* kb = k + (long long)b * T * E;
  const __nv_bfloat16* vlb = vl + (long long)b * T * E;

  load_tile(qp, qb, n0, N, E, col0);

  // scores s[64, T] = q_tile . k^T, one 64-column chunk of T at a time
  const int rf = warp >> 1;         // row fragment 0..3
  const int cf0 = (warp & 1) * 2;   // two column fragments
  for (int t0 = 0; t0 < T; t0 += TILE) {
    __syncthreads();
    load_tile(kv, kb, t0, T, E, col0);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, qp + rf * 16 * LDH + kk, LDH);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bm;
        wmma::load_matrix_sync(bm, kv + (cf0 + j) * 16 * LDH + kk, LDH);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s + rf * 16 * LDS + t0 + (cf0 + j) * 16, acc[j], LDS,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // row softmax over T with the additive text bias; p overwrites the q tile
  const float* bias_b = bias + (long long)b * T;
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float mx = NEG;
    for (int c = lane; c < T; c += 32) mx = fmaxf(mx, s[r * LDS + c] + bias_b[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < T; c += 32) {
      const float e = expf(s[r * LDS + c] + bias_b[c] - mx);
      s[r * LDS + c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
    for (int c = lane; c < T; c += 32) qp[r * LDH + c] = __float2bfloat16(s[r * LDS + c] * inv);
  }

  // out tile [64, D] = p . vl; warp w owns columns [32 w, 32 w + 32)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(o[i][j], 0.f);
  for (int t0 = 0; t0 < T; t0 += TILE) {
    __syncthreads();
    load_tile(kv, vlb, t0, T, E, col0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bm[j], kv + kk * LDH + warp * 32 + j * 16, LDH);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qp + i * 16 * LDH + t0 + kk, LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(o[i][j], a, bm[j], o[i][j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s + i * 16 * LDS + warp * 32 + j * 16, o[i][j], LDS,
                              wmma::mem_row_major);
  __syncthreads();
  __nv_bfloat16* ob = out_v + (long long)b * N * E;
  for (int v = threadIdx.x; v < TILE * (D / 8); v += THREADS) {
    const int r = v / (D / 8);
    const int c = (v % (D / 8)) * 8;
    if (n0 + r < N) {
      __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed[j] = __floats2bfloat162_rn(s[r * LDS + c + 2 * j], s[r * LDS + c + 2 * j + 1]);
      *reinterpret_cast<uint4*>(ob + (n0 + r) * E + col0 + c) =
          *reinterpret_cast<const uint4*>(packed);
    }
  }
}

// Text rows [t0, t0 + 64) of head h, batch row b, over all N rows of this
// level's q / vv: start from the carried state's rows and store them back
// unnormalised.
__device__ __forceinline__ void l_tile(unsigned char* smem,
                                       const __nv_bfloat16* __restrict__ q,   // (B, N, E) pre-scaled
                                       const __nv_bfloat16* __restrict__ k,   // (B, T, E)
                                       const __nv_bfloat16* __restrict__ vv,  // (B, N, E)
                                       float* __restrict__ acc_st,            // (B, H, T, D)
                                       float* __restrict__ den_st,            // (B, H, T)
                                       float* __restrict__ m_st,              // (B, H, T)
                                       int N, int T, int E, int heads, int t0, int h, int b) {
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem + L_K);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L_X);
  float* st = reinterpret_cast<float*>(smem + L_S);
  __nv_bfloat16* ep = reinterpret_cast<__nv_bfloat16*>(smem + L_E);
  float* acc = reinterpret_cast<float*>(smem + L_ACC);
  float* m_run = reinterpret_cast<float*>(smem + L_STAT);
  float* den = m_run + TILE;
  float* alpha = den + TILE;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long col0 = (long long)h * D;
  const long long srow = ((long long)b * heads + h) * T + t0;  // first state row
  const __nv_bfloat16* qb = q + (long long)b * N * E;
  const __nv_bfloat16* vvb = vv + (long long)b * N * E;

  load_tile(kt, k + (long long)b * T * E, t0, T, E, col0);
  for (int v = threadIdx.x; v < TILE * (D / 4); v += THREADS) {
    const int r = v / (D / 4);
    const int c = (v % (D / 4)) * 4;
    *reinterpret_cast<float4*>(acc + r * LDS + c) =
        *reinterpret_cast<const float4*>(acc_st + (srow + r) * D + c);
  }
  if (threadIdx.x < TILE) {
    m_run[threadIdx.x] = m_st[srow + threadIdx.x];
    den[threadIdx.x] = den_st[srow + threadIdx.x];
  }

  const int rf = warp >> 1;
  const int cf0 = (warp & 1) * 2;
  for (long long n0 = 0; n0 < N; n0 += TILE) {
    __syncthreads();  // previous chunk's readers of xs are done
    load_tile(xs, qb, n0, N, E, col0);
    __syncthreads();
    {  // st[64 text, 64 vision] = k_tile . q_chunk^T
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc[2];
      wmma::fill_fragment(sc[0], 0.f);
      wmma::fill_fragment(sc[1], 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, kt + rf * 16 * LDH + kk, LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bm;
          wmma::load_matrix_sync(bm, xs + (cf0 + j) * 16 * LDH + kk, LDH);
          wmma::mma_sync(sc[j], a, bm, sc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(st + rf * 16 * LDT + (cf0 + j) * 16, sc[j], LDT,
                                wmma::mem_row_major);
    }
    __syncthreads();
    // online softmax statistics over the vision axis; masked tail rows give 0
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const bool ok0 = n0 + lane < N;
      const bool ok1 = n0 + lane + 32 < N;
      const float s0 = ok0 ? st[r * LDT + lane] : NEG;
      const float s1 = ok1 ? st[r * LDT + lane + 32] : NEG;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, mx);
      const float e0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float e1 = ok1 ? expf(s1 - m_new) : 0.f;
      ep[r * LDE + lane] = __float2bfloat16(e0);
      ep[r * LDE + lane + 32] = __float2bfloat16(e1);
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        den[r] = den[r] * a + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    load_tile(xs, vvb, n0, N, E, col0);
    for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
      const int r = i / D;
      acc[r * LDS + (i % D)] *= alpha[r];
    }
    __syncthreads();
    {  // acc[64, D] += e . vv_chunk; warp w owns columns [32 w, 32 w + 32)
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(o[i][j], acc + i * 16 * LDS + warp * 32 + j * 16, LDS,
                                 wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bm[j], xs + kk * LDH + warp * 32 + j * 16, LDH);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, ep + i * 16 * LDE + kk, LDE);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(o[i][j], a, bm[j], o[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(acc + i * 16 * LDS + warp * 32 + j * 16, o[i][j], LDS,
                                  wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < TILE * (D / 4); v += THREADS) {
    const int r = v / (D / 4);
    const int c = (v % (D / 4)) * 4;
    *reinterpret_cast<float4*>(acc_st + (srow + r) * D + c) =
        *reinterpret_cast<const float4*>(acc + r * LDS + c);
  }
  if (threadIdx.x < TILE) {
    m_st[srow + threadIdx.x] = m_run[threadIdx.x];
    den_st[srow + threadIdx.x] = den[threadIdx.x];
  }
}

// One block of K4's 1-D grid: the (T/64) x heads x B l tiles first, then
// the ceil(N/64) x heads x B v tiles.
__global__ void __launch_bounds__(THREADS)
bi_attn_carry_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ vv, const __nv_bfloat16* __restrict__ vl,
                     const float* __restrict__ bias, float* __restrict__ acc,
                     float* __restrict__ den, float* __restrict__ m,
                     __nv_bfloat16* __restrict__ out_v, int B, int N, int T, int E, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int l_tiles = T / TILE;
  const long long n_l = (long long)l_tiles * heads * B;
  long long idx = blockIdx.x;
  if (idx < n_l) {
    const int t0 = (int)(idx % l_tiles) * TILE;
    const long long rest = idx / l_tiles;
    l_tile(smem, q, k, vv, acc, den, m, N, T, E, heads, t0, (int)(rest % heads),
           (int)(rest / heads));
    return;
  }
  idx -= n_l;
  const long long v_tiles = (N + TILE - 1) / TILE;
  const long long rest = idx / v_tiles;
  v_tile(smem, q, k, vl, bias, out_v, N, T, E, (idx % v_tiles) * TILE, (int)(rest % heads),
         (int)(rest / heads));
}

// ---- K3 / K3b: the flash-attention tile on wgmma and TMA -----------------

constexpr int FA_ROWS = 128;                     // query rows per block
constexpr int FA_CHUNK = 64;                     // key / value rows per ring stage
constexpr int FA_STAGES = 2;
constexpr int FA_THREADS = 384;                  // producer + two consumer warpgroups
constexpr int BOX = 64;                          // a TMA box: 64 rows x 64 bf16 (128 bytes)
constexpr uint32_t BOX_BYTES = BOX * 128;        // 8 KB, one 128-byte-swizzled panel
constexpr uint32_t HALF_BYTES = (D / BOX) * BOX_BYTES;  // 64 rows x 256 columns, 32 KB
constexpr uint32_t Q_BYTES = 2 * HALF_BYTES;     // the 128-row query tile
constexpr uint32_t STAGE_BYTES = 2 * HALF_BYTES; // a K chunk and a V chunk
constexpr uint32_t BAR_OFF = Q_BYTES + FA_STAGES * STAGE_BYTES;
constexpr size_t FA_SMEM = 1024 + BAR_OFF + 64;  // 1024: slack to align the base for the swizzle
constexpr int MAX_SPLITS = 64;
constexpr float LOG2E = 1.4426950408889634f;

struct FaArgs {
  const float* bias;        // (B, T) additive, v role
  __nv_bfloat16* out_v;     // (B, N, E)
  float* part_acc;          // (S, B, H, T, D) l role partials, unnormalised
  float* part_den;          // (S, B, H, T)
  float* part_m;            // (S, B, H, T)
  int B, N, T, E, heads, splits, split_chunks;
};

// K-major operand of 64-column panels (rows of 128 bytes, 8-row groups 1024
// bytes apart): k-step kk of 16 columns is panel kk / 4, 32 bytes per step.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  return sw128_desc(base + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 0, 1024);
}

// MN-major V chunk (64 keys x 256 columns as four 64-column panels): k-step
// kk of 16 keys starts 16 rows down; the next 64 columns are one panel on
// (leading byte offset), the next 8 keys 1024 bytes on (stride byte offset).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk) {
  return sw128_desc(base + kk * 16 * 128, BOX_BYTES, 1024);
}

// S (+)= A . B^T, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The 1-D grid: B x heads x splits x ceil(T/128) l blocks (T tile fastest,
// then split, head, batch row), then B x heads x ceil(N/128) v blocks (N
// tile fastest). Shared memory from a 1024-aligned base: the query tile
// [half][panel], the ring [stage][K panels, V panels], the barriers.
//
// Fragment layout of an m64nNk16 fp32 accumulator in a warpgroup: thread t
// (warp w = t / 32, lane l) holds d[4 j + 2 i + c] = element (16 w + l / 4 +
// 8 i, 8 j + 2 (l % 4) + c); the bf16 A fragment of k-step kk of P is the
// S accumulator's n8 blocks 2 kk and 2 kk + 1 in that order.
__global__ void __launch_bounds__(FA_THREADS, 1)
bi_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_vv,
                     const __grid_constant__ CUtensorMap tm_vl, const FaArgs args) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + Q_BYTES;
  const uint32_t bars = base + BAR_OFF;  // q_full, full_k[2], full_v[2], empty[2]
  const uint32_t q_full = bars;

  // this block's job
  const int t_tiles = (args.T + FA_ROWS - 1) / FA_ROWS;
  const long long n_l = (long long)t_tiles * args.splits * args.heads * args.B;
  long long idx = blockIdx.x;
  const bool l_role = idx < n_l;
  int row0, split = 0, c_begin, c_end, key_limit;
  const CUtensorMap *mq, *mk, *mv;
  if (l_role) {
    row0 = (int)(idx % t_tiles) * FA_ROWS;
    idx /= t_tiles;
    split = (int)(idx % args.splits);
    idx /= args.splits;
    const int chunks = (args.N + FA_CHUNK - 1) / FA_CHUNK;
    c_begin = min(split * args.split_chunks, chunks);
    c_end = min(c_begin + args.split_chunks, chunks);
    key_limit = args.N;
    mq = &tm_k;
    mk = &tm_q;
    mv = &tm_vv;
  } else {
    idx -= n_l;
    const int n_tiles = (args.N + FA_ROWS - 1) / FA_ROWS;
    row0 = (int)(idx % n_tiles) * FA_ROWS;
    idx /= n_tiles;
    c_begin = 0;
    c_end = args.T / FA_CHUNK;
    key_limit = args.T;
    mq = &tm_q;
    mk = &tm_k;
    mv = &tm_vl;
  }
  const int h = (int)(idx % args.heads);
  const int b = (int)(idx / args.heads);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, 1);                  // full_k[s]
      mbar_init(bars + 8 + 8 * FA_STAGES + 8 * s, 1);  // full_v[s]
      mbar_init(bars + 8 + 16 * FA_STAGES + 8 * s, 256);  // empty[s]: every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int half = 0; half < 2; ++half)
        for (int pn = 0; pn < D / BOX; ++pn)
          tma_load(base + half * HALF_BYTES + pn * BOX_BYTES, mq, q_full, h * D + pn * BOX,
                   row0 + half * BOX, b);
      for (int c = c_begin; c < c_end; ++c) {
        const int j = c - c_begin, s = j & 1;
        const uint32_t ph = (j >> 1) & 1;
        mbar_wait(bars + 8 + 16 * FA_STAGES + 8 * s, ph ^ 1);  // stage s released
        const uint32_t kb = ring + s * STAGE_BYTES, vb = kb + HALF_BYTES;
        const uint32_t fk = bars + 8 + 8 * s, fv = bars + 8 + 8 * FA_STAGES + 8 * s;
        mbar_expect_tx(fk, HALF_BYTES);
        for (int pn = 0; pn < D / BOX; ++pn)
          tma_load(kb + pn * BOX_BYTES, mk, fk, h * D + pn * BOX, c * FA_CHUNK, b);
        mbar_expect_tx(fv, HALF_BYTES);
        for (int pn = 0; pn < D / BOX; ++pn)
          tma_load(vb + pn * BOX_BYTES, mv, fv, h * D + pn * BOX, c * FA_CHUNK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31;
    const int r0 = 16 * warp + (lane >> 2);  // this thread's rows r0 and r0 + 8 of the 64
    const int col = 2 * (lane & 3);          // and columns 8 j + col + {0, 1}
    const uint32_t qa = base + cw * HALF_BYTES;
    const float* bias_b = args.bias + (long long)b * args.T;

    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int c = c_begin; c < c_end; ++c) {
      const int j = c - c_begin, s = j & 1;
      const uint32_t ph = (j >> 1) & 1;
      const uint32_t kb = ring + s * STAGE_BYTES, vb = kb + HALF_BYTES;
      const int key0 = c * FA_CHUNK;

      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      mbar_wait(bars + 8 + 8 * s, ph);
      fence_regs(sc);
      wg_fence();
      const uint32_t qc = opaque(qa);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_s(sc, kmajor_desc(qc, kk), kmajor_desc(kb, kk), kk > 0);
      wg_commit();
      wg_wait0();
      fence_regs(sc);

      if (!l_role) {  // the additive text bias
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(bias_b + key0 + 8 * jn + col));
          sc[4 * jn] += bv.x;
          sc[4 * jn + 1] += bv.y;
          sc[4 * jn + 2] += bv.x;
          sc[4 * jn + 3] += bv.y;
        }
      } else if (key0 + FA_CHUNK > key_limit) {  // keys past N score NEG
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (key0 + 8 * jn + col + e >= key_limit) {
              sc[4 * jn + e] = NEG;
              sc[4 * jn + 2 + e] = NEG;
            }
      }

      // online softmax of rows r0 (i = 0) and r0 + 8 (i = 1)
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float a0 = exp2f((m0 - n0) * LOG2E), a1 = exp2f((m1 - n1) * LOG2E);
      m0 = n0;
      m1 = n1;
      // subtract before scaling: at |s| ~ 9e15 (masked text) a fused
      // s * log2e - m * log2e keeps the products' rounding, ~1e9
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[4][4];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float p0 = exp2f((sc[4 * jn] - n0) * LOG2E);
        const float p1 = exp2f((sc[4 * jn + 1] - n0) * LOG2E);
        const float p2 = exp2f((sc[4 * jn + 2] - n1) * LOG2E);
        const float p3 = exp2f((sc[4 * jn + 3] - n1) * LOG2E);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pa[jn >> 1][2 * (jn & 1)] = pack_bf16(p0, p1);
        pa[jn >> 1][2 * (jn & 1) + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int jn = 0; jn < 32; ++jn) {
        o[4 * jn] *= a0;
        o[4 * jn + 1] *= a0;
        o[4 * jn + 2] *= a1;
        o[4 * jn + 3] *= a1;
      }

      mbar_wait(bars + 8 + 8 * FA_STAGES + 8 * s, ph);
      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < FA_CHUNK / 16; ++kk) wgmma_o(o, pa[kk], mnmajor_desc(vb, kk));
      wg_commit();
      wg_wait0();
      fence_regs(o);
      mbar_arrive(bars + 8 + 16 * FA_STAGES + 8 * s);
    }

#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const int rows = l_role ? args.T : args.N;
    const int g0 = row0 + 64 * cw + r0, g1 = g0 + 8;  // this thread's two rows
    if (!l_role) {
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      __nv_bfloat16* ob = args.out_v + (long long)b * args.N * args.E + h * D + col;
#pragma unroll
      for (int jn = 0; jn < 32; ++jn) {
        if (g0 < rows)
          *reinterpret_cast<uint32_t*>(ob + (long long)g0 * args.E + 8 * jn) =
              pack_bf16(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
        if (g1 < rows)
          *reinterpret_cast<uint32_t*>(ob + (long long)g1 * args.E + 8 * jn) =
              pack_bf16(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
      }
    } else {
      const long long prow = (((long long)split * args.B + b) * args.heads + h) * args.T;
      float* pa_out = args.part_acc + prow * D + col;
#pragma unroll
      for (int jn = 0; jn < 32; ++jn) {
        if (g0 < rows)
          *reinterpret_cast<float2*>(pa_out + (long long)g0 * D + 8 * jn) =
              make_float2(o[4 * jn], o[4 * jn + 1]);
        if (g1 < rows)
          *reinterpret_cast<float2*>(pa_out + (long long)g1 * D + 8 * jn) =
              make_float2(o[4 * jn + 2], o[4 * jn + 3]);
      }
      if ((lane & 3) == 0) {
        if (g0 < rows) {
          args.part_m[prow + g0] = m0;
          args.part_den[prow + g0] = l0;
        }
        if (g1 < rows) {
          args.part_m[prow + g1] = m1;
          args.part_den[prow + g1] = l1;
        }
      }
    }
  }
}

// out_l rows [t0, t0 + 16) of head h, batch row b, from the S partials:
// out_l = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) den_s, M = max_s m_s.
// 256 threads: 64 groups of 4 columns x 4 rows at a time.
constexpr int COMBINE_ROWS = 16;

__global__ void __launch_bounds__(256)
bi_attn_combine_kernel(const float* __restrict__ acc, const float* __restrict__ den,
                       const float* __restrict__ m, __nv_bfloat16* __restrict__ out_l, int B,
                       int T, int E, int heads, int splits) {
  __shared__ float w[MAX_SPLITS][COMBINE_ROWS];
  __shared__ float inv[COMBINE_ROWS];
  const int t0 = blockIdx.x * COMBINE_ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long plane = (long long)B * heads * T;  // rows of one split
  const long long row0 = ((long long)b * heads + h) * T + t0;
  const int rows = min(COMBINE_ROWS, T - t0);
  if (threadIdx.x < rows) {
    const long long r = row0 + threadIdx.x;
    float mx = NEG;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s * plane + r]);
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ws = exp2f((m[s * plane + r] - mx) * LOG2E);
      w[s][threadIdx.x] = ws;
      sum += ws * den[s * plane + r];
    }
    inv[threadIdx.x] = 1.f / sum;
  }
  __syncthreads();
  const int c = 4 * (threadIdx.x & 63);
  for (int r = threadIdx.x >> 6; r < rows; r += 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float ws = w[s][r];
      const float4 x = __ldg(reinterpret_cast<const float4*>(acc + (s * plane + row0 + r) * D + c));
      a.x += ws * x.x;
      a.y += ws * x.y;
      a.z += ws * x.z;
      a.w += ws * x.w;
    }
    const float iv = inv[r];
    uint2 packed;
    packed.x = pack_bf16(a.x * iv, a.y * iv);
    packed.y = pack_bf16(a.z * iv, a.w * iv);
    *reinterpret_cast<uint2*>(out_l + ((long long)b * T + t0 + r) * E + h * D + c) = packed;
  }
}

cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  const struct {
    const void* fn;
    size_t bytes;
  } kernels[] = {
      {(const void*)bi_attn_carry_kernel, FUSED_SMEM},
      {(const void*)bi_attn_wgmma_kernel, FA_SMEM},
  };
  for (const auto& kn : kernels) {
    cudaError_t err =
        cudaFuncSetAttribute(kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kn.bytes);
    if (err != cudaSuccess) return err;
  }
  configured = true;
  return cudaSuccess;
}

// A (E, rows, B) bf16 tensor in 64 x 64 boxes with 128-byte swizzle; rows
// past `rows` read as zeros.
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int rows, int E, int B) {
  const cuuint64_t dims[3] = {(cuuint64_t)E, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)E * 2, (cuuint64_t)rows * E * 2};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K3 and K3b: the wgmma kernel (both roles), then the combine.
int flash_forward(const void* q, const void* k, const void* vv, const void* vl, const void* bias,
                  void* out_v, void* out_l, void* part_acc, void* part_den, void* part_m, int B,
                  int N, int T, int E, int heads, int splits, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tvv, tvl;
  if (!tensor_map(&tq, encode, q, N, E, B) || !tensor_map(&tk, encode, k, T, E, B) ||
      !tensor_map(&tvv, encode, vv, N, E, B) || !tensor_map(&tvl, encode, vl, T, E, B))
    return (int)cudaErrorInvalidValue;
  const int chunks = (N + FA_CHUNK - 1) / FA_CHUNK;
  FaArgs args{reinterpret_cast<const float*>(bias), reinterpret_cast<__nv_bfloat16*>(out_v),
              reinterpret_cast<float*>(part_acc), reinterpret_cast<float*>(part_den),
              reinterpret_cast<float*>(part_m), B, N, T, E, heads, splits,
              (chunks + splits - 1) / splits};
  const long long blocks =
      ((long long)((T + FA_ROWS - 1) / FA_ROWS) * splits + (N + FA_ROWS - 1) / FA_ROWS) * heads * B;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  bi_attn_wgmma_kernel<<<(unsigned)blocks, FA_THREADS, FA_SMEM, s>>>(tq, tk, tvv, tvl, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((T + COMBINE_ROWS - 1) / COMBINE_ROWS), (unsigned)heads, (unsigned)B);
  bi_attn_combine_kernel<<<grid, 256, 0, s>>>(args.part_acc, args.part_den, args.part_m,
                                            reinterpret_cast<__nv_bfloat16*>(out_l), B, T, E,
                                            heads, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). Each requires E / heads == 256,
// T % 64 == 0, T <= 256, N >= 1; the Python wrapper checks. Each returns
// cudaGetLastError() after its launches. K3 and K3b take the l side's
// scratch (part_acc (S, B, H, T, D), part_den and part_m (S, B, H, T), fp32)
// and S = splits, 1 <= S <= 64.

// K3: out_v and out_l.
extern "C" int mqdet_bi_attention_forward(const void* q, const void* k, const void* vv,
                                          const void* vl, const void* bias, void* out_v,
                                          void* out_l, void* part_acc, void* part_den,
                                          void* part_m, int B, int N, int T, int E, int heads,
                                          int splits, void* stream) {
  return flash_forward(q, k, vv, vl, bias, out_v, out_l, part_acc, part_den, part_m, B, N, T, E,
                       heads, splits, stream);
}

// K3b: the dual-score form, the same kernels (the port's l side always
// makes its own score product).
extern "C" int mqdet_bi_attention_dual_forward(const void* q, const void* k, const void* vv,
                                               const void* vl, const void* bias, void* out_v,
                                               void* out_l, void* part_acc, void* part_den,
                                               void* part_m, int B, int N, int T, int E,
                                               int heads, int splits, void* stream) {
  return flash_forward(q, k, vv, vl, bias, out_v, out_l, part_acc, part_den, part_m, B, N, T, E,
                       heads, splits, stream);
}

// K4: one FPN level's out_v, and the carried l-side state (acc (B, H, T, D),
// den and m (B, H, T), fp32) updated in place, in one launch.
extern "C" int mqdet_bi_attention_carry_forward(const void* q, const void* k, const void* vv,
                                                const void* vl, const void* bias, void* acc,
                                                void* den, void* m, void* out_v, int B, int N,
                                                int T, int E, int heads, void* stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)(T / TILE + (N + TILE - 1) / TILE) * heads * B);
  bi_attn_carry_kernel<<<blocks, THREADS, FUSED_SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(vv), reinterpret_cast<const __nv_bfloat16*>(vl),
      reinterpret_cast<const float*>(bias), reinterpret_cast<float*>(acc),
      reinterpret_cast<float*>(den), reinterpret_cast<float*>(m),
      reinterpret_cast<__nv_bfloat16*>(out_v), B, N, T, E, heads);
  return (int)cudaGetLastError();
}
