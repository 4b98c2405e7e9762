// Modulated deformable convolution (DCNv2), 3x3, pad 1, stride 1 or 2, as an
// implicit GEMM on Hopper tensor cores.
//
// Replaces the TPU kernel mqdet_tpu/ops/pallas/deform_conv_pallas.py
// (_kernel_v2, launched by _mdc_pallas_core) on the DyConv tower path. Unlike
// that kernel it does not clip offsets to a window: every sample is the exact
// 4-corner bilinear read of mqdet_tpu/ops/deform_conv.py::modulated_deform_conv
// (zero outside the image, zero for a corner outside the image).
//
// GEMM view: out[M = B*Ho*Wo, Cout] = A[M, 9*C] @ Wt[9*C, Cout] + bias, where
// A[m, tap*C + c] = mask[m, tap] * bilinear(x[b], p(m, tap) + offset[m, tap])[c].
// A is never written to device memory: a block owns a BM x BN output tile, walks
// the 9 taps and C in BK-wide chunks, gathers the modulated samples of its BM
// positions into shared memory as bf16 (16-byte loads along C from NHWC x), and
// multiplies them with the matching weight tile through WMMA bf16 with fp32
// accumulation. The bias is added and the tile written once.
//
// What bounds it on the H100: at the main path's shapes (C = Cout = 256) the
// product is 2*9*C*Cout = 1.18 MFLOP per output position against 4 corner reads
// of C bf16 values per tap (~18 KB per position, mostly hits in L2 because
// neighbouring positions read neighbouring pixels), so it sits near the ridge of
// the roofline; this first version is bounded by the gather latency it does not
// hide (no software pipelining, one k-step in flight). The sampled tile is built
// once per block for BN = 128 output channels, so the gather is repeated only
// Cout / 128 = 2 times per position.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output positions per block
constexpr int BN = 128;       // output channels per block
constexpr int BK = 32;        // input channels per k-step
constexpr int THREADS = 256;  // 8 warps as 2 (M) x 4 (N), 32 x 32 each
constexpr int A_LD = BK + 8;  // padded leading dimensions (bf16 / float)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

struct SmemAB {
  __nv_bfloat16 a[BM * A_LD];
  __nv_bfloat16 b[BK * B_LD];
};

union SmemMain {
  SmemAB ab;
  float c[BM * C_LD];
};

__global__ void __launch_bounds__(THREADS)
dcn_forward_kernel(const __nv_bfloat16* __restrict__ x,       // (B, H, W, C)
                   const __nv_bfloat16* __restrict__ offset,  // (B, Ho, Wo, 18) (dy, dx) per tap
                   const __nv_bfloat16* __restrict__ mask,    // (B, Ho, Wo, 9)
                   const __nv_bfloat16* __restrict__ weight,  // (9 * C, Cout)
                   const __nv_bfloat16* __restrict__ bias,    // (Cout,) or null
                   __nv_bfloat16* __restrict__ out,           // (B, Ho, Wo, Cout)
                   int B, int H, int W, int C, int Ho, int Wo, int Cout, int stride) {
  __shared__ __align__(128) unsigned char smem_raw[sizeof(SmemMain)];
  SmemMain& sm = *reinterpret_cast<SmemMain*>(smem_raw);
  __shared__ int s_idx[4][BM];    // element offset of each bilinear corner in x, -1 if absent
  __shared__ float s_wt[4][BM];   // its bilinear weight times the modulation mask

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 0..1
  const int warp_n = warp & 3;   // 0..3
  const long long hw_out = (long long)Ho * Wo;
  const long long M = (long long)B * hw_out;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3;
    const int kx = tap % 3;
    __syncthreads();  // the previous tap's readers of s_idx / s_wt are done
    if (tid < BM) {
      const long long m = m0 + tid;
      int idx[4] = {-1, -1, -1, -1};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < M) {
        const int b = (int)(m / hw_out);
        const int r = (int)(m - (long long)b * hw_out);
        const int oy = r / Wo;
        const int ox = r - oy * Wo;
        const float dy = __bfloat162float(offset[m * 18 + 2 * tap]);
        const float dx = __bfloat162float(offset[m * 18 + 2 * tap + 1]);
        const float mk = __bfloat162float(mask[m * 9 + tap]);
        const float y = (float)(oy * stride - 1 + ky) + dy;
        const float xx = (float)(ox * stride - 1 + kx) + dx;
        if (y > -1.f && y < (float)H && xx > -1.f && xx < (float)W) {
          const float y0f = floorf(y);
          const float x0f = floorf(xx);
          const float ly = y - y0f;
          const float lx = xx - x0f;
          const int y0 = (int)y0f;
          const int x0 = (int)x0f;
          const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx, ly * (1.f - lx), ly * lx};
          const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
          const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (cy[q] >= 0 && cy[q] < H && cx[q] >= 0 && cx[q] < W) {
              idx[q] = ((b * H + cy[q]) * W + cx[q]) * C;
              wt[q] = cw[q] * mk;
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_idx[q][tid] = idx[q];
        s_wt[q][tid] = wt[q];
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += BK) {
      {  // A tile: one 8-channel vector of one position per thread
        const int row = tid >> 2;
        const int c = c0 + (tid & 3) * 8;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
        if (c < C) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int base = s_idx[q][row];
            if (base >= 0) {
              const float w = s_wt[q][row];
              const uint4 raw = *reinterpret_cast<const uint4*>(x + base + c);
              const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(p[j]);
                v[2 * j] += w * f.x;
                v[2 * j + 1] += w * f.y;
              }
            }
          }
        }
        __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) packed[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(&sm.ab.a[row * A_LD + (tid & 3) * 8]) =
            *reinterpret_cast<const uint4*>(packed);
      }
      // B tile: BK rows of the (9*C, Cout) weight, BN columns
      for (int v = tid; v < BK * (BN / 8); v += THREADS) {
        const int row = v / (BN / 8);
        const int vec = v % (BN / 8);
        const int c = c0 + row;
        const int n = n0 + vec * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (c < C && n < Cout)
          val = *reinterpret_cast<const uint4*>(weight + ((long long)tap * C + c) * Cout + n);
        *reinterpret_cast<uint4*>(&sm.ab.b[row * B_LD + vec * 8]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], sm.ab.a + (warp_m * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], sm.ab.b + kk * B_LD + warp_n * 32 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: stage the fp32 tile through shared memory, add bias, store bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sm.c + (warp_m * 32 + i * 16) * C_LD + warp_n * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < BM * (BN / 8); v += THREADS) {
    const int row = v / (BN / 8);
    const int vec = v % (BN / 8);
    const long long m = m0 + row;
    const int n = n0 + vec * 8;
    if (m < M && n < Cout) {
      __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a0 = sm.c[row * C_LD + vec * 8 + 2 * j];
        float a1 = sm.c[row * C_LD + vec * 8 + 2 * j + 1];
        if (bias != nullptr) {
          a0 += __bfloat162float(bias[n + 2 * j]);
          a1 += __bfloat162float(bias[n + 2 * j + 1]);
        }
        packed[j] = __floats2bfloat162_rn(a0, a1);
      }
      *reinterpret_cast<uint4*>(out + m * Cout + n) = *reinterpret_cast<const uint4*>(packed);
    }
  }
}

}  // namespace

// C interface (loaded with ctypes). Returns cudaGetLastError() after the launch.
extern "C" int mqdet_dcn_forward(const void* x, const void* offset, const void* mask,
                                 const void* weight, const void* bias, void* out, int B, int H,
                                 int W, int C, int Ho, int Wo, int Cout, int stride,
                                 void* stream) {
  const long long M = (long long)B * Ho * Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  dcn_forward_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(offset),
      reinterpret_cast<const __nv_bfloat16*>(mask), reinterpret_cast<const __nv_bfloat16*>(weight),
      reinterpret_cast<const __nv_bfloat16*>(bias), reinterpret_cast<__nv_bfloat16*>(out), B, H, W,
      C, Ho, Wo, Cout, stride);
  return (int)cudaGetLastError();
}
