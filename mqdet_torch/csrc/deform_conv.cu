// Modulated deformable convolution (DCNv2), 3x3, pad 1, stride 1 or 2, as an
// implicit GEMM on Hopper tensor cores. Two kernels share the tensor-core
// product and the epilogue; they differ in where the A tile comes from.
//
// GEMM view: out[M = B*Ho*Wo, Cout] = A[M, 9*C] @ Wt[9*C, Cout] + bias, where
// A[m, tap*C + c] = mask[m, tap] * bilinear(x[b], p(m, tap) + offset[m, tap])[c].
// A is never written to device memory: a block owns a BM x BN output tile,
// builds the modulated samples of its BM positions in shared memory as bf16 and
// multiplies them with the matching weight tile through WMMA bf16 with fp32
// accumulation. The bias is added and the tile written once. Each block builds
// its samples for BN = 128 output channels, so they are built Cout / 128 = 2
// times per position at the main path's width.
//
// dcn_forward_kernel: the 4-corner gather straight from device memory.
//   * radius < 0: exact, unclipped sampling, the function of
//     mqdet_tpu/ops/deform_conv.py::modulated_deform_conv (zero outside the
//     image). It replaces that XLA gather composite.
//   * radius >= 0: each (dy, dx) is clamped to [-radius, radius] before the
//     tap is added (rel = clip(offset) + tap), the function of
//     mqdet_tpu/ops/pallas/deform_conv_gather_pallas.py::_kernel (K2), which
//     it replaces. The gather index absorbs the stride.
//   Per tap it loads C in BK-wide chunks: 4 corner reads of 16 bytes per
//   (position, 8 channels), mostly hits in L2 since neighbouring positions read
//   neighbouring pixels. What bounds it on the H100: at C = Cout = 256 the
//   product is 2*9*C*Cout = 1.18 MFLOP per position, near the roofline's
//   ridge; this version is held back by the gather latency it does not hide
//   (one k-step in flight).
//
// dcn_band_kernel<VERSION, BK>: the clipped DCNv2 of
// mqdet_tpu/ops/pallas/deform_conv_pallas.py::_mdc_pallas_core (K1, and the
// versions of K1b). Once offsets are clipped to +-radius, every corner that a
// BR x BW tile of output positions reads lies in a band of
// (BR-1)*stride + 2*radius + 4 rows by (BW-1)*stride + 2*radius + 4 columns
// (the +2 rows and columns past 1 + radius hold the zero-weight corner of an
// offset clipped to exactly +radius). Per BK-channel chunk the block stages that
// band in shared memory, zero-filled outside the image (the window composite's
// zero padding), and builds the A tile of each tap from four shared-memory
// corner reads per (position, 8 channels) at indices precomputed once per block.
// The band is read from device memory once per chunk instead of 4 x 9 corner
// reads per position. Versions (template flag), as the TPU launcher names them:
//   1: the band is loaded synchronously, one chunk at a time (load, sync,
//      blend, MMA) -- the TPU's _kernel.
//   2: the band of chunk k+1 is in flight (cp.async into the second buffer)
//      while chunk k is blended and multiplied -- the TPU's double-buffered
//      band DMA of _kernel_v2, the production version.
//   3: version 2 with the 4-corner blend accumulated in bf16 (__hfma2), the
//      TPU's input-dtype accumulator.
//   5: version 2 with a 2x2 fast path: where the clipped floor(rel) of a tap is
//      uniform over the tile, its four corners are four fixed shifts of each
//      position, so the corner address comes from the position and the tap's
//      shift, not from the index table (the TPU's _kernel_v5). The weights are
//      the table's, so the result is bitwise version 2's.
//   6: version 2 with the band converted to fp32 once per chunk, as it is
//      staged (cp.async into a bf16 staging buffer, then one conversion pass).
//      The blend reads the same values, so the result is bitwise version 2's.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // output positions per block
constexpr int BN = 128;       // output channels per block
constexpr int THREADS = 256;  // 8 warps as 2 (M) x 4 (N), 32 x 32 each
constexpr int B_LD = BN + 8;  // padded leading dimensions (bf16 / float)
constexpr int C_LD = BN + 4;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

template <int BK>
struct SmemAB {
  __nv_bfloat16 a[BM * (BK + 8)];
  __nv_bfloat16 b[BK * B_LD];
};

template <int BK>
union SmemTile {
  SmemAB<BK> ab;
  float c[BM * C_LD];
};

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void zero_acc(Acc (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// B tile: BK rows (input channels c0.. of one tap) of the (9*C, Cout) weight, BN columns
template <int BK>
__device__ __forceinline__ void load_weight_tile(__nv_bfloat16* sb, const __nv_bfloat16* __restrict__ weight,
                                                 int tap, int c0, int C, int Cout, int n0, int tid) {
  for (int v = tid; v < BK * (BN / 8); v += THREADS) {
    const int row = v / (BN / 8);
    const int vec = v % (BN / 8);
    const int c = c0 + row;
    const int n = n0 + vec * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < C && n < Cout)
      val = *reinterpret_cast<const uint4*>(weight + ((long long)tap * C + c) * Cout + n);
    *reinterpret_cast<uint4*>(&sb[row * B_LD + vec * 8]) = val;
  }
}

template <int BK>
__device__ __forceinline__ void mma_tile(Acc (&acc)[2][2], const __nv_bfloat16* sa, const __nv_bfloat16* sb,
                                         int warp_m, int warp_n) {
  constexpr int A_LD = BK + 8;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], sa + (warp_m * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], sb + kk * B_LD + warp_n * 32 + j * 16, B_LD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
  }
}

// Epilogue: stage the fp32 tile through shared memory, add bias, store bf16.
// row_of(r) is the output row (flat b, oy, ox) of tile row r, or -1.
template <int BK, typename RowOf>
__device__ __forceinline__ void store_tile(Acc (&acc)[2][2], SmemTile<BK>& sm, RowOf row_of,
                                           const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                                           int Cout, int n0, int warp_m, int warp_n, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sm.c + (warp_m * 32 + i * 16) * C_LD + warp_n * 32 + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < BM * (BN / 8); v += THREADS) {
    const int row = v / (BN / 8);
    const int vec = v % (BN / 8);
    const long long m = row_of(row);
    const int n = n0 + vec * 8;
    if (m >= 0 && n < Cout) {
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

constexpr int GATHER_BK = 32;

__global__ void __launch_bounds__(THREADS)
dcn_forward_kernel(const __nv_bfloat16* __restrict__ x,       // (B, H, W, C)
                   const __nv_bfloat16* __restrict__ offset,  // (B, Ho, Wo, 18) (dy, dx) per tap
                   const __nv_bfloat16* __restrict__ mask,    // (B, Ho, Wo, 9)
                   const __nv_bfloat16* __restrict__ weight,  // (9 * C, Cout)
                   const __nv_bfloat16* __restrict__ bias,    // (Cout,) or null
                   __nv_bfloat16* __restrict__ out,           // (B, Ho, Wo, Cout)
                   int B, int H, int W, int C, int Ho, int Wo, int Cout, int stride, int radius) {
  constexpr int BK = GATHER_BK;
  constexpr int A_LD = BK + 8;
  __shared__ __align__(128) unsigned char smem_raw[sizeof(SmemTile<BK>)];
  SmemTile<BK>& sm = *reinterpret_cast<SmemTile<BK>*>(smem_raw);
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

  Acc acc[2][2];
  zero_acc(acc);

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
        bool live;
        int y0 = 0, x0 = 0;
        float ly = 0.f, lx = 0.f;
        if (radius >= 0) {  // clipped: rel = clip(offset) + tap; corners outside the image are 0
          const float rad = (float)radius;
          const float rely = fminf(fmaxf(dy, -rad), rad) + (float)(ky - 1);
          const float relx = fminf(fmaxf(dx, -rad), rad) + (float)(kx - 1);
          const float fy = floorf(rely);
          const float fx = floorf(relx);
          y0 = oy * stride + (int)fy;
          x0 = ox * stride + (int)fx;
          ly = rely - fy;
          lx = relx - fx;
          live = true;
        } else {  // exact: zero for samples at or beyond one pixel outside the image
          const float y = (float)(oy * stride - 1 + ky) + dy;
          const float xx = (float)(ox * stride - 1 + kx) + dx;
          live = y > -1.f && y < (float)H && xx > -1.f && xx < (float)W;
          if (live) {
            const float y0f = floorf(y);
            const float x0f = floorf(xx);
            y0 = (int)y0f;
            x0 = (int)x0f;
            ly = y - y0f;
            lx = xx - x0f;
          }
        }
        if (live) {
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
        *reinterpret_cast<uint4*>(&sm.ab.a[row * A_LD + (tid & 3) * 8]) = *reinterpret_cast<const uint4*>(packed);
      }
      load_weight_tile<BK>(sm.ab.b, weight, tap, c0, C, Cout, n0, tid);
      __syncthreads();
      mma_tile<BK>(acc, sm.ab.a, sm.ab.b, warp_m, warp_n);
      __syncthreads();
    }
  }

  store_tile<BK>(acc, sm, [&](int row) { return m0 + row < M ? m0 + row : -1LL; }, bias, out, Cout, n0,
                 warp_m, warp_n, tid);
}

// ---- the band kernel ---------------------------------------------------------

__host__ __device__ constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

// Dynamic shared memory: the A/B/C tile union, the per-block tables, the band.
constexpr int TABLE_BYTES = 9 * BM * 4     // s_idx: band offset of each sample's top-left corner
                            + 9 * BM * 16  // s_wt: its 4 corner weights times the mask
                            + BM * 4       // s_row: output row of each tile position, -1 past the edge
                            + 16 * 4       // s_fast: version 5's uniform shift per tap, -1 if none
                            + 36 * 4;      // s_lim: version 5's min / max corner row and column per tap
constexpr int BAND_OFFSET = align_up((int)sizeof(SmemTile<32>) + TABLE_BYTES, 128);
static_assert(sizeof(SmemTile<32>) == sizeof(SmemTile<16>), "the C tile sets the union's size");

__host__ __device__ constexpr int band_bytes(int version, int bk, int band_px) {
  // v1 one bf16 buffer; v6 a bf16 staging buffer and an fp32 band; else two bf16 buffers
  return version == 1 ? band_px * bk * 2 : version == 6 ? band_px * bk * 6 : band_px * bk * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Copy channels [c0, c0 + BK) of the band's pixels into dst ([pixel][BK] bf16),
// zeros outside the image; cp.async when ASYNC, else loads and stores.
template <int BK, bool ASYNC>
__device__ __forceinline__ void stage_band(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x, int b,
                                           int iy0, int ix0, int H, int W, int C, int c0, int band_cols,
                                           int band_px, int tid) {
  constexpr int VPP = BK / 8;
  for (int v = tid; v < band_px * VPP; v += THREADS) {
    const int px = v / VPP;
    const int cv = v - px * VPP;
    const int row = px / band_cols;
    const int iy = iy0 + row;
    const int ix = ix0 + px - row * band_cols;
    const bool inb = (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
    const __nv_bfloat16* src = inb ? x + (((long long)b * H + iy) * W + ix) * C + c0 + cv * 8 : x;
    __nv_bfloat16* d = dst + px * BK + cv * 8;
    if (ASYNC) {
      cp_async16(d, src, inb);
    } else {
      *reinterpret_cast<uint4*>(d) = inb ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int VERSION, int BK>
__global__ void __launch_bounds__(THREADS)
dcn_band_kernel(const __nv_bfloat16* __restrict__ x,       // (B, H, W, C)
                const __nv_bfloat16* __restrict__ offset,  // (B, Ho, Wo, 18) (dy, dx) per tap
                const __nv_bfloat16* __restrict__ mask,    // (B, Ho, Wo, 9)
                const __nv_bfloat16* __restrict__ weight,  // (9 * C, Cout)
                const __nv_bfloat16* __restrict__ bias,    // (Cout,) or null
                __nv_bfloat16* __restrict__ out,           // (B, Ho, Wo, Cout)
                int H, int W, int C, int Ho, int Wo, int Cout, int stride, int radius, int br, int bw,
                int tiles_y, int tiles_x) {
  constexpr bool PREFETCH = VERSION != 1;
  constexpr bool BF16_BLEND = VERSION == 3;
  constexpr bool FAST = VERSION == 5;
  constexpr bool F32_BAND = VERSION == 6;
  constexpr int VPP = BK / 8;  // 16-byte vectors per band pixel and chunk
  constexpr int A_LD = BK + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemTile<BK>& sm = *reinterpret_cast<SmemTile<BK>*>(smem);
  int* s_idx = reinterpret_cast<int*>(smem + sizeof(SmemTile<32>));
  float4* s_wt = reinterpret_cast<float4*>(s_idx + 9 * BM);
  int* s_row = reinterpret_cast<int*>(s_wt + 9 * BM);
  int* s_fast = s_row + BM;
  int* s_lim = s_fast + 16;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;
  const int per_img = tiles_y * tiles_x;
  const int b = blockIdx.x / per_img;
  const int t = blockIdx.x - b * per_img;
  const int oy0 = (t / tiles_x) * br;
  const int ox0 = (t % tiles_x) * bw;
  const int n0 = blockIdx.y * BN;
  const int band_rows = (br - 1) * stride + 2 * radius + 4;
  const int band_cols = (bw - 1) * stride + 2 * radius + 4;
  const int band_px = band_rows * band_cols;
  const int iy0 = oy0 * stride - 1 - radius;  // image row and column of band pixel (0, 0)
  const int ix0 = ox0 * stride - 1 - radius;

  // ---- per-block tables: corner index and weights of every (tap, position) ----
  if (tid < 9) {
    s_lim[tid * 4 + 0] = INT_MAX;
    s_lim[tid * 4 + 1] = INT_MIN;
    s_lim[tid * 4 + 2] = INT_MAX;
    s_lim[tid * 4 + 3] = INT_MIN;
  }
  if (tid < BM) {
    const int oy = oy0 + tid / bw;
    const int ox = ox0 + tid % bw;
    s_row[tid] = oy < Ho && ox < Wo ? (b * Ho + oy) * Wo + ox : -1;
  }
  __syncthreads();
  for (int e = tid; e < 9 * BM; e += THREADS) {
    const int tap = e / BM;
    const int p = e - tap * BM;
    const int m = s_row[p];
    int idx = (p / bw) * stride * band_cols + (p % bw) * stride;  // the position's zero shift
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m >= 0) {
      const float rad = (float)radius;
      const float dy = __bfloat162float(offset[(long long)m * 18 + 2 * tap]);
      const float dx = __bfloat162float(offset[(long long)m * 18 + 2 * tap + 1]);
      const float mk = __bfloat162float(mask[(long long)m * 9 + tap]);
      const float rely = fminf(fmaxf(dy, -rad), rad) + (float)(tap / 3 - 1);
      const float relx = fminf(fmaxf(dx, -rad), rad) + (float)(tap % 3 - 1);
      const float fy = floorf(rely);
      const float fx = floorf(relx);
      const float ly = rely - fy;
      const float lx = relx - fx;
      const int sy = (int)fy + 1 + radius;  // in [0, 2 * radius + 2]
      const int sx = (int)fx + 1 + radius;
      idx += sy * band_cols + sx;
      w = make_float4((1.f - ly) * (1.f - lx) * mk, (1.f - ly) * lx * mk, ly * (1.f - lx) * mk, ly * lx * mk);
      if (FAST) {
        atomicMin(&s_lim[tap * 4 + 0], sy);
        atomicMax(&s_lim[tap * 4 + 1], sy);
        atomicMin(&s_lim[tap * 4 + 2], sx);
        atomicMax(&s_lim[tap * 4 + 3], sx);
      }
    }
    s_idx[e] = idx;
    s_wt[e] = w;
  }
  __syncthreads();
  if (FAST && tid < 9) {
    const int* l = s_lim + tid * 4;
    s_fast[tid] = l[0] == l[1] && l[2] == l[3] ? l[0] * band_cols + l[2] : -1;
  }

  __nv_bfloat16* band16[2];
  band16[0] = reinterpret_cast<__nv_bfloat16*>(smem + BAND_OFFSET);
  band16[1] = band16[0] + band_px * BK;
  float* band32 = reinterpret_cast<float*>(band16[1]);  // v6: after the staging buffer

  Acc acc[2][2];
  zero_acc(acc);
  const int nchunks = C / BK;
  if (PREFETCH) {
    stage_band<BK, true>(band16[0], x, b, iy0, ix0, H, W, C, 0, band_cols, band_px, tid);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    const int c0 = k * BK;
    const __nv_bfloat16* cur = band16[0];
    if (!PREFETCH) {
      __syncthreads();  // the previous chunk's readers of the band are done
      stage_band<BK, false>(band16[0], x, b, iy0, ix0, H, W, C, c0, band_cols, band_px, tid);
      __syncthreads();
    } else {
      cp_async_wait_all();
      __syncthreads();  // chunk k has landed; chunk k-1's readers are done
      if (F32_BAND) {
        for (int v = tid; v < band_px * VPP; v += THREADS) {
          const uint4 raw = *reinterpret_cast<const uint4*>(band16[0] + v * 8);
          const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          float4* d = reinterpret_cast<float4*>(band32 + v * 8);
          const float2 f0 = __bfloat1622float2(p2[0]), f1 = __bfloat1622float2(p2[1]);
          const float2 f2 = __bfloat1622float2(p2[2]), f3 = __bfloat1622float2(p2[3]);
          d[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
          d[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
        }
        __syncthreads();  // the staging buffer is free for chunk k+1
      }
      if (k + 1 < nchunks) {
        __nv_bfloat16* next = F32_BAND ? band16[0] : band16[(k + 1) & 1];
        stage_band<BK, true>(next, x, b, iy0, ix0, H, W, C, c0 + BK, band_cols, band_px, tid);
        cp_async_commit();
      }
      cur = band16[F32_BAND ? 0 : (k & 1)];
    }

    for (int tap = 0; tap < 9; ++tap) {
      for (int v = tid; v < BM * VPP; v += THREADS) {  // A tile: 8 channels of one position per item
        const int p = v / VPP;
        const int cv = v - p * VPP;
        int idx;
        if (FAST && s_fast[tap] >= 0) {
          idx = (p / bw) * stride * band_cols + (p % bw) * stride + s_fast[tap];
        } else {
          idx = s_idx[tap * BM + p];
        }
        const float4 w4 = s_wt[tap * BM + p];
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
        const int corner[4] = {idx, idx + 1, idx + band_cols, idx + band_cols + 1};
        __align__(16) __nv_bfloat162 packed[4];
        if (BF16_BLEND) {
#pragma unroll
          for (int j = 0; j < 4; ++j) packed[j] = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const __nv_bfloat162 w2 = __float2bfloat162_rn(wq[q]);
            const uint4 raw = *reinterpret_cast<const uint4*>(cur + corner[q] * BK + cv * 8);
            const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int j = 0; j < 4; ++j) packed[j] = __hfma2(w2, p2[j], packed[j]);
          }
        } else {
          float val[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) val[j] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float f[8];
            if (F32_BAND) {
              const float4* src = reinterpret_cast<const float4*>(band32 + corner[q] * BK + cv * 8);
              const float4 a = src[0], c = src[1];
              f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
              f[4] = c.x; f[5] = c.y; f[6] = c.z; f[7] = c.w;
            } else {
              const uint4 raw = *reinterpret_cast<const uint4*>(cur + corner[q] * BK + cv * 8);
              const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float2 f2 = __bfloat1622float2(p2[j]);
                f[2 * j] = f2.x;
                f[2 * j + 1] = f2.y;
              }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) val[j] += wq[q] * f[j];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) packed[j] = __floats2bfloat162_rn(val[2 * j], val[2 * j + 1]);
        }
        *reinterpret_cast<uint4*>(&sm.ab.a[p * A_LD + cv * 8]) = *reinterpret_cast<const uint4*>(packed);
      }
      load_weight_tile<BK>(sm.ab.b, weight, tap, c0, C, Cout, n0, tid);
      __syncthreads();
      mma_tile<BK>(acc, sm.ab.a, sm.ab.b, warp_m, warp_n);
      __syncthreads();
    }
  }

  store_tile<BK>(acc, sm, [&](int row) { return (long long)s_row[row]; }, bias, out, Cout, n0, warp_m,
                 warp_n, tid);
}

template <int VERSION, int BK>
int launch_band(const void* x, const void* offset, const void* mask, const void* weight, const void* bias,
                void* out, int B, int H, int W, int C, int Ho, int Wo, int Cout, int stride, int radius, int br,
                int bw, int smem_bytes, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(dcn_band_kernel<VERSION, BK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int tiles_y = (Ho + br - 1) / br;
  const int tiles_x = (Wo + bw - 1) / bw;
  dim3 grid((unsigned)(B * tiles_y * tiles_x), (unsigned)((Cout + BN - 1) / BN));
  dcn_band_kernel<VERSION, BK><<<grid, THREADS, smem_bytes, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(offset),
      reinterpret_cast<const __nv_bfloat16*>(mask), reinterpret_cast<const __nv_bfloat16*>(weight),
      reinterpret_cast<const __nv_bfloat16*>(bias), reinterpret_cast<__nv_bfloat16*>(out), H, W, C, Ho, Wo, Cout,
      stride, radius, br, bw, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

template <int BK>
int launch_band_version(int version, const void* x, const void* offset, const void* mask, const void* weight,
                        const void* bias, void* out, int B, int H, int W, int C, int Ho, int Wo, int Cout,
                        int stride, int radius, int br, int bw, int smem_bytes, cudaStream_t s) {
  switch (version) {
    case 1: return launch_band<1, BK>(x, offset, mask, weight, bias, out, B, H, W, C, Ho, Wo, Cout, stride, radius, br, bw, smem_bytes, s);
    case 2: return launch_band<2, BK>(x, offset, mask, weight, bias, out, B, H, W, C, Ho, Wo, Cout, stride, radius, br, bw, smem_bytes, s);
    case 3: return launch_band<3, BK>(x, offset, mask, weight, bias, out, B, H, W, C, Ho, Wo, Cout, stride, radius, br, bw, smem_bytes, s);
    case 5: return launch_band<5, BK>(x, offset, mask, weight, bias, out, B, H, W, C, Ho, Wo, Cout, stride, radius, br, bw, smem_bytes, s);
    case 6: return launch_band<6, BK>(x, offset, mask, weight, bias, out, B, H, W, C, Ho, Wo, Cout, stride, radius, br, bw, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (loaded with ctypes). Each returns cudaGetLastError() after the launch.
extern "C" int mqdet_dcn_forward(const void* x, const void* offset, const void* mask,
                                 const void* weight, const void* bias, void* out, int B, int H,
                                 int W, int C, int Ho, int Wo, int Cout, int stride, int radius,
                                 void* stream) {
  const long long M = (long long)B * Ho * Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  dcn_forward_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(offset),
      reinterpret_cast<const __nv_bfloat16*>(mask), reinterpret_cast<const __nv_bfloat16*>(weight),
      reinterpret_cast<const __nv_bfloat16*>(bias), reinterpret_cast<__nv_bfloat16*>(out), B, H, W,
      C, Ho, Wo, Cout, stride, radius);
  return (int)cudaGetLastError();
}

// The band kernel at tile br x bw (br * bw = 64), channel chunk bk (16 or 32).
// smem_bytes is the caller's count of the dynamic shared memory; a count that
// differs from this file's layout, or exceeds what a block may use, is refused.
extern "C" int mqdet_dcn_band_forward(const void* x, const void* offset, const void* mask, const void* weight,
                                      const void* bias, void* out, int B, int H, int W, int C, int Ho, int Wo,
                                      int Cout, int stride, int radius, int br, int bw, int version, int bk,
                                      int smem_bytes, void* stream) {
  const int band_px = ((br - 1) * stride + 2 * radius + 4) * ((bw - 1) * stride + 2 * radius + 4);
  const int want = BAND_OFFSET + band_bytes(version, bk, band_px);
  if (br * bw != BM || radius < 0 || want != smem_bytes || want > SMEM_LIMIT || C % bk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bk == 32)
    return launch_band_version<32>(version, x, offset, mask, weight, bias, out, B, H, W, C, Ho, Wo, Cout, stride,
                                   radius, br, bw, smem_bytes, s);
  if (bk == 16)
    return launch_band_version<16>(version, x, offset, mask, weight, bias, out, B, H, W, C, Ho, Wo, Cout, stride,
                                   radius, br, bw, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
