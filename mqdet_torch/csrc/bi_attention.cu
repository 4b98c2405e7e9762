// Bidirectional vision-language cross-attention (GLIP's X-MHA), eval only.
//
// Replaces three TPU kernels of mqdet_tpu/ops/pallas/bi_attention_pallas.py:
// _kernel in its single-score (K3) and dual-score (K3b) forms, both launched
// by _flash_bi_attention_jit, and _kernel_carry (K4, launched by
// _flash_bi_attention_carry_jit, one call per FPN level). Per batch row and
// head, with s = q . k^T (N vision tokens x T text tokens, q pre-scaled):
//     out_v = softmax_T(s + bias_l) . vl      (vision attends to text)
//     out_l = softmax_N(s^T) . vv             (text attends to vision)
//
// The TPU kernel keeps the whole l-side accumulator (heads x T x D f32, 2 MB)
// in VMEM across a sequential grid over N. On Hopper one head's T x D f32
// accumulator (256 KB) alone exceeds a block's 227 KB of shared memory, and
// blocks run in no order, so the work is split into two block roles:
//   v tile (v_tile): a 64-row tile of q against all T, the row softmax with
//      bias_l, and out_v = p . vl. Rows are complete in one block, so nothing
//      crosses blocks.
//   l tile (l_tile): a 64-token tile of text queries loops over N with an
//      online softmax (running max, denominator, a 64 x D fp32 accumulator in
//      shared memory), recomputing the score tile s^T = k . q^T from k and q.
// Every form therefore makes two score products, the dual-score formulation:
// 8*B*N*T*E flops, where the TPU's single-score kernel makes 6. Scores never
// reach device memory; q and vv are each read twice.
//
// The three C entry points:
//   mqdet_bi_attention_forward (K3): bi_attn_v_kernel, grid (N/64, heads, B),
//      then bi_attn_l_kernel, grid (T/64, heads, B): two launches in turn.
//   mqdet_bi_attention_dual_forward (K3b): ONE launch, bi_attn_dual_kernel,
//      whose 1-D grid holds both roles: the T/64 x heads x B l tiles first
//      (each runs over all of N), then the N/64 x heads x B v tiles, which
//      fill the SMs the l tiles leave free (at 4 heads the l tiles are 64
//      blocks on 132 SMs).
//   mqdet_bi_attention_carry_forward (K4): ONE launch per FPN level,
//      bi_attn_carry_kernel, the same two roles over this level's rows only.
//      Its l tiles load their 64 rows of the carried fp32 state (m, den, acc
//      of shapes (B, H, T), (B, H, T), (B, H, T, D)), run the online softmax
//      over the level and store the state back unnormalised, in place (each
//      block owns its rows); the wrapper takes out_l = acc / den after the
//      last level. bias_l enters only the v side.
//
// What bounds it on the H100: the main path's shapes (B = 4, N = 22400,
// T = 256, 8 heads of D = 256) need 2*B*N*T*E = 94 GFLOP per product, four
// products, against ~0.8 GB of q/vv/out_v traffic: compute bound. This first
// version uses WMMA bf16 with fp32 accumulation and no software pipelining,
// so it reaches a fraction of the tensor-core peak; the l tiles number only
// B * heads * T/64 = 128 blocks, about one per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 256;        // head width (E / heads); the only width compiled
constexpr int TILE = 64;      // rows of q (v tile) / rows of text (l tile) per block
constexpr int THREADS = 256;  // 8 warps
constexpr int LDH = D + 8;    // bf16 leading dimension of a 64 x D (or 64 x T) tile
constexpr int LDS = D + 4;    // fp32 leading dimension of a 64 x T (or 64 x D) tile
constexpr int LDT = TILE + 4; // fp32 leading dimension of a 64 x 64 score tile
constexpr int LDE = TILE + 8; // bf16 leading dimension of a 64 x 64 probability tile
constexpr float NEG = -1e30f;

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

// Text rows [t0, t0 + 64) of head h, batch row b, over all N rows of q / vv.
// CARRY false: start from (m, den, acc) = (-1e30, 0, 0) and write out_l =
// acc / den. CARRY true: start from the carried state's rows and store them
// back unnormalised (out_l unused).
template <bool CARRY>
__device__ __forceinline__ void l_tile(unsigned char* smem,
                                       const __nv_bfloat16* __restrict__ q,   // (B, N, E) pre-scaled
                                       const __nv_bfloat16* __restrict__ k,   // (B, T, E)
                                       const __nv_bfloat16* __restrict__ vv,  // (B, N, E)
                                       __nv_bfloat16* __restrict__ out_l,     // (B, T, E)
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
  if constexpr (CARRY) {
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
  } else {
    for (int i = threadIdx.x; i < TILE * LDS; i += THREADS) acc[i] = 0.f;
    if (threadIdx.x < TILE) {
      m_run[threadIdx.x] = NEG;
      den[threadIdx.x] = 0.f;
    }
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
  if constexpr (CARRY) {
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
    return;
  }
  __nv_bfloat16* ob = out_l + (long long)b * T * E;
  for (int v = threadIdx.x; v < TILE * (D / 8); v += THREADS) {
    const int r = v / (D / 8);
    const int c = (v % (D / 8)) * 8;
    const float inv = 1.f / den[r];
    __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      packed[j] = __floats2bfloat162_rn(acc[r * LDS + c + 2 * j] * inv,
                                        acc[r * LDS + c + 2 * j + 1] * inv);
    *reinterpret_cast<uint4*>(ob + (long long)(t0 + r) * E + col0 + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

__global__ void __launch_bounds__(THREADS)
bi_attn_v_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ vl, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out_v, int N, int T, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  v_tile(smem, q, k, vl, bias, out_v, N, T, E, (long long)blockIdx.x * TILE, blockIdx.y,
         blockIdx.z);
}

__global__ void __launch_bounds__(THREADS)
bi_attn_l_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ vv, __nv_bfloat16* __restrict__ out_l,
                 int N, int T, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  l_tile<false>(smem, q, k, vv, out_l, nullptr, nullptr, nullptr, N, T, E, gridDim.y,
                blockIdx.x * TILE, blockIdx.y, blockIdx.z);
}

// One block of a launch that holds both roles in a 1-D grid: the
// (T/64) x heads x B l tiles first, then the ceil(N/64) x heads x B v tiles.
template <bool CARRY>
__device__ __forceinline__ void fused_block(unsigned char* smem, const __nv_bfloat16* q,
                                            const __nv_bfloat16* k, const __nv_bfloat16* vv,
                                            const __nv_bfloat16* vl, const float* bias,
                                            __nv_bfloat16* out_v, __nv_bfloat16* out_l,
                                            float* acc_st, float* den_st, float* m_st,
                                            int B, int N, int T, int E, int heads) {
  const int l_tiles = T / TILE;
  const long long n_l = (long long)l_tiles * heads * B;
  long long idx = blockIdx.x;
  if (idx < n_l) {
    const int t0 = (int)(idx % l_tiles) * TILE;
    const long long rest = idx / l_tiles;
    l_tile<CARRY>(smem, q, k, vv, out_l, acc_st, den_st, m_st, N, T, E, heads, t0,
                  (int)(rest % heads), (int)(rest / heads));
    return;
  }
  idx -= n_l;
  const long long v_tiles = (N + TILE - 1) / TILE;
  const long long rest = idx / v_tiles;
  v_tile(smem, q, k, vl, bias, out_v, N, T, E, (idx % v_tiles) * TILE, (int)(rest % heads),
         (int)(rest / heads));
}

__global__ void __launch_bounds__(THREADS)
bi_attn_dual_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ vv, const __nv_bfloat16* __restrict__ vl,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out_v,
                    __nv_bfloat16* __restrict__ out_l, int B, int N, int T, int E, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  fused_block<false>(smem, q, k, vv, vl, bias, out_v, out_l, nullptr, nullptr, nullptr, B, N,
                     T, E, heads);
}

__global__ void __launch_bounds__(THREADS)
bi_attn_carry_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ vv, const __nv_bfloat16* __restrict__ vl,
                     const float* __restrict__ bias, float* __restrict__ acc,
                     float* __restrict__ den, float* __restrict__ m,
                     __nv_bfloat16* __restrict__ out_v, int B, int N, int T, int E, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  fused_block<true>(smem, q, k, vv, vl, bias, out_v, nullptr, acc, den, m, B, N, T, E, heads);
}

cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  const struct {
    const void* fn;
    size_t bytes;
  } kernels[] = {
      {(const void*)bi_attn_v_kernel, V_SMEM},
      {(const void*)bi_attn_l_kernel, L_SMEM},
      {(const void*)bi_attn_dual_kernel, FUSED_SMEM},
      {(const void*)bi_attn_carry_kernel, FUSED_SMEM},
  };
  for (const auto& kn : kernels) {
    cudaError_t err =
        cudaFuncSetAttribute(kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kn.bytes);
    if (err != cudaSuccess) return err;
  }
  configured = true;
  return cudaSuccess;
}

unsigned fused_blocks(int B, int N, int T, int heads) {
  return (unsigned)((long long)(T / TILE + (N + TILE - 1) / TILE) * heads * B);
}

}  // namespace

// C interface (loaded with ctypes). Each requires E / heads == 256,
// T % 64 == 0, T <= 256, N >= 1; the Python wrapper checks. Each returns
// cudaGetLastError() after its launches.

// K3: out_v and out_l, two launches in turn.
extern "C" int mqdet_bi_attention_forward(const void* q, const void* k, const void* vv,
                                          const void* vl, const void* bias, void* out_v,
                                          void* out_l, int B, int N, int T, int E, int heads,
                                          void* stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qp = reinterpret_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = reinterpret_cast<const __nv_bfloat16*>(k);
  dim3 grid_v((unsigned)((N + TILE - 1) / TILE), (unsigned)heads, (unsigned)B);
  bi_attn_v_kernel<<<grid_v, THREADS, V_SMEM, s>>>(
      qp, kp, reinterpret_cast<const __nv_bfloat16*>(vl), reinterpret_cast<const float*>(bias),
      reinterpret_cast<__nv_bfloat16*>(out_v), N, T, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_l((unsigned)(T / TILE), (unsigned)heads, (unsigned)B);
  bi_attn_l_kernel<<<grid_l, THREADS, L_SMEM, s>>>(
      qp, kp, reinterpret_cast<const __nv_bfloat16*>(vv), reinterpret_cast<__nv_bfloat16*>(out_l),
      N, T, E);
  return (int)cudaGetLastError();
}

// K3b: out_v and out_l in one launch.
extern "C" int mqdet_bi_attention_dual_forward(const void* q, const void* k, const void* vv,
                                               const void* vl, const void* bias, void* out_v,
                                               void* out_l, int B, int N, int T, int E,
                                               int heads, void* stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  bi_attn_dual_kernel<<<fused_blocks(B, N, T, heads), THREADS, FUSED_SMEM,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(vv), reinterpret_cast<const __nv_bfloat16*>(vl),
      reinterpret_cast<const float*>(bias), reinterpret_cast<__nv_bfloat16*>(out_v),
      reinterpret_cast<__nv_bfloat16*>(out_l), B, N, T, E, heads);
  return (int)cudaGetLastError();
}

// K4: one FPN level's out_v, and the carried l-side state (acc (B, H, T, D),
// den and m (B, H, T), fp32) updated in place, in one launch.
extern "C" int mqdet_bi_attention_carry_forward(const void* q, const void* k, const void* vv,
                                                const void* vl, const void* bias, void* acc,
                                                void* den, void* m, void* out_v, int B, int N,
                                                int T, int E, int heads, void* stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  bi_attn_carry_kernel<<<fused_blocks(B, N, T, heads), THREADS, FUSED_SMEM,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(vv), reinterpret_cast<const __nv_bfloat16*>(vl),
      reinterpret_cast<const float*>(bias), reinterpret_cast<float*>(acc),
      reinterpret_cast<float*>(den), reinterpret_cast<float*>(m),
      reinterpret_cast<__nv_bfloat16*>(out_v), B, N, T, E, heads);
  return (int)cudaGetLastError();
}
