// Modulated deformable convolution (DCNv2), 3x3, pad 1, stride 1 or 2, as an
// implicit GEMM on Hopper tensor cores:
//   out[M = B*Ho*Wo, Cout] = A[M, 9*C] @ Wt[9*C, Cout] + bias, where
//   A[m, tap*C + c] = mask[m, tap] * bilinear(x[b], p(m, tap) + offset[m, tap])[c].
// A is never written to device memory: each block builds the modulated
// samples of its positions on chip and multiplies them in bf16 with fp32
// accumulation; the bias is added and the output written once, in bf16.
//
// dcn_gather_kernel: the 4-corner gather straight from device memory, for
// any radius and any C % 8 == 0, in two modes:
//   * radius < 0: exact, unclipped sampling, the function of
//     mqdet_tpu/ops/deform_conv.py::modulated_deform_conv (zero for a sample
//     at or beyond one pixel outside the image). It replaces that XLA gather
//     composite.
//   * radius >= 0: each (dy, dx) is clamped to [-radius, radius] before the
//     tap is added (rel = clip(offset) + tap; each corner outside the image
//     is zero), the function of
//     mqdet_tpu/ops/pallas/deform_conv_gather_pallas.py::_kernel (K2), which
//     it replaces. The gather index absorbs the stride.
//   What bounds it on the H100: not the product (0.080 ms at level 0, as for
//   the band kernel below), nor the bytes (9 taps x 4 corners x 2 C bytes
//   per position, 1.24 GB at level 0 for C = 256, from L1 and L2), but the
//   latency of the corner loads one gather warpgroup keeps in flight
//   (tools/perf_dcn_band: without the product it runs about as long, with
//   smooth offsets as with random ones). The design keeps that latency off
//   the tensor cores' path:
//   * A block owns 128 positions of the flat m = (b, oy, ox) (a ragged tail
//     is masked) x 256 output channels, so each sample is built once per
//     position for Cout <= 256.
//   * Warp specialisation, 384 threads: a gather warpgroup fills A stages,
//     two consumer warpgroups each hold an m64n256 fp32 accumulator in
//     registers. No setmaxnreg: ptxas compiles every region within the
//     launch bound's 168 registers (an m64n256 wgmma needs 154; at 512
//     threads, 128, it refuses), so raising the consumers' count buys them
//     nothing, and the gather warps keep 168 for loads in flight.
//   * The K loop runs tap by tap, within a tap over 64-channel chunks, within
//     a chunk over its four 16-channel groups: one stage per (tap, chunk),
//     one m64n256k16 wgmma per group, A and B both from shared memory.
//   * A stage holds the A tile, 128 positions x 64 bf16 written by the
//     gather warps in the 128-byte-swizzled K-major layout that wgmma reads
//     (16 KB), and the weight rows of (tap, chunk), 64 x 256 as four
//     128-byte-swizzled 64-column panels (32 KB), loaded by TMA from a 3-D
//     map over (Cout, C, 9) whose out-of-bounds zero fill gives zero rows
//     past C and zero columns past Cout. The ring has 3 stages (2 to 4
//     measured alike) with full / empty mbarriers; one gather thread issues
//     a stage's weight loads as the stage frees up.
//   * A gather thread owns one 8-channel group of 8 positions: per position
//     four 16-byte corner loads (four positions' sixteen in flight at once;
//     a software pipeline that kept two or one positions' loads in flight
//     across the blend ran slower, and eight positions' spill), the blend in
//     fp32 in corner order, one 16-byte store. The eight
//     threads of a position read one 128-byte line of each corner and write
//     one 128-byte row of the stage.
//   * Per block, a table of every (tap, position)'s top-left pixel, its
//     four bilinear weights times the mask (zero for a corner outside the
//     image, and for the whole sample where the exact mode drops it) and
//     which of its corners lie in the image is built once. Every corner in
//     the image is loaded, whatever its weight, so a pixel's inf or NaN
//     reaches the output as 0 * inf does in the plain versions; no corner
//     outside it is. A NaN offset makes the tap's four weights NaN (the clip
//     would take a bound, `fmaxf` returning the operand that is not NaN; the
//     exact mode's in-image tests would drop the sample), so the position's
//     output is NaN, as in the plain versions and JAX (the exact mode keeps
//     a zero where the sample's other coordinate is outside the image, as
//     the exact composite does), and the blend loop is the same for finite
//     offsets.
//   * The epilogue adds the bias in registers and writes bf16.
//
// dcn_band_kernel<VERSION>: the clipped DCNv2 of
// mqdet_tpu/ops/pallas/deform_conv_pallas.py::_mdc_pallas_core (K1, and the
// versions of K1b), the GLIP head's default DCN. Once offsets are clipped to
// +-radius, every corner that a br x bw tile of output positions reads lies in
// a band of (br-1)*stride + 2*radius + 4 rows by (bw-1)*stride + 2*radius + 4
// columns (the +2 past 1 + radius hold the zero-weight corner of an offset
// clipped to exactly +radius).
//   What bounds it on the H100: at C = Cout = 256 the product is
//   2*9*C*Cout = 1.18 MFLOP per position (level 0 of the 800x1344 pyramid,
//   4 x 16800 positions: 0.080 ms at 989 TFLOP/s) against ~1.1 KB of bytes
//   per position (0.023 ms at 3.35 TB/s): the tensor cores. The design keeps
//   them fed:
//   * A block owns 128 positions (br x bw, br = the model's block rows) x 256
//     output channels, so each sample is built once per position and each
//     block streams the whole (9C, 256) weight from L2 once (1.18 MB).
//   * Warp specialisation: one producer thread issues TMA loads, two consumer
//     warpgroups of 64 positions each hold an m64n256 fp32 accumulator in
//     registers (128 a thread).
//   * The K loop runs over (16-channel group, tap), one m64n256k16 wgmma a
//     step, whatever the band chunk's width bk (64, 32 or 16: the largest that
//     fits shared memory), so every version and chunk width sums in one order.
//     A comes from registers: each consumer thread blends its own m16n8k16 A
//     fragment (two positions x 4 channels) from the band in shared memory,
//     with no shared-memory round trip for A and no barrier between the
//     blenders and the tensor cores; the fragments alternate between two
//     register sets, so the next step's blend runs while the current product
//     is in flight (wgmma.wait_group 1).
//   * The band of each bk-channel chunk comes by TMA from a 4-D tensor map
//     over x (C, W, H, B), box (bk, band_cols, band_rows, 1): its
//     out-of-bounds zero fill is the window composite's zero padding. A
//     pixel's bk channels are swizzled by TMA (128B / 64B / 32B), so the
//     eight positions a warp reads at once hit different banks. Two band
//     buffers take turns: chunk k + 1 lands while chunk k is blended.
//   * The weight comes by TMA as (tap, group) slabs of 16 x 256 (four
//     128-byte-swizzled 64-column panels, read by wgmma as an MN-major B)
//     through a ring of up to 8 stages, with full / empty mbarriers.
//   * Per block, tables of the band index of every (tap, position)'s top-left
//     corner and its four bilinear weights times the mask are built once. A
//     NaN offset makes the tap's weights NaN (its clip would take a bound),
//     so its position's output is NaN, as in the plain version and JAX.
// Versions (template flag), as the TPU launcher names them:
//   1: one band buffer: chunk k + 1 is loaded after chunk k's last step (the
//      TPU's _kernel, its band loaded synchronously).
//   2: two band buffers, chunk k + 1 in flight while chunk k is used (the
//      TPU's double-buffered _kernel_v2, the production version).
//   3: version 2 with the 4-corner blend accumulated in bf16 (__hfma2), the
//      TPU's input-dtype accumulator.
//   5: version 2 with a 2x2 fast path: where the clipped floor(rel) of a tap is
//      uniform over the tile, the corner address comes from the position and
//      the tap's shift, not from the index table (the TPU's _kernel_v5). The
//      weights are the table's, so the result is bitwise version 2's.
//   6: version 2 with the band converted to fp32 once per chunk, as it lands
//      (one bf16 staging buffer, then one conversion pass by the consumers).
//      The blend reads the same values, so the result is bitwise version 2's.
#include <climits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

// ---- the band kernel ---------------------------------------------------------

constexpr int BAND_M = 128;        // output positions per block: two consumer warpgroups of 64
constexpr int BAND_N = 256;        // output channels per block: one m64n256 accumulator per consumer
constexpr int BAND_THREADS = 384;  // the producer warpgroup and two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int GROUP = 16;                          // input channels per k-step (the wgmma depth)
constexpr int PANEL_BYTES = GROUP * 128;           // a weight slab's 64-column panel: 16 rows x 128 bytes
constexpr int SLAB_BYTES = (BAND_N / 64) * PANEL_BYTES;  // one (tap, group) weight slab, 16 x 256 bf16
constexpr int MAX_STAGES = 8;                      // the weight ring's stages
constexpr int TABLE_BYTES = 9 * BAND_M * 4      // s_idx: band pixel of each sample's top-left corner
                            + 9 * BAND_M * 16   // s_wt: its 4 corner weights times the mask
                            + BAND_M * 4        // s_row: output row of each tile position, -1 past the edge
                            + 16 * 4            // s_fast: version 5's uniform shift per tap, -1 if none
                            + 36 * 4;           // s_lim: version 5's min / max corner row and column per tap
constexpr int BAR_BYTES = (4 + 2 * MAX_STAGES) * 8;  // full / empty band [2], full / empty slab [MAX_STAGES]

__host__ __device__ constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

// Four NaN corner weights: the sample of a NaN offset.
__device__ __forceinline__ float4 nan4() {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

// Dynamic shared memory, in bytes from a 1024-aligned base (each buffer a TMA
// destination whose swizzle pattern follows the address bits): the bf16 band
// buffers (one for versions 1 and 6, else two), version 6's fp32 band, the
// weight ring, the per-block tables, the barriers; `total` adds the 1024 bytes
// of slack that align the base. band_layout in ops/deform_conv.py mirrors it.
struct BandLayout {
  int nbuf, buf_bytes, band32, ring, tables, bars, total;
};

__host__ __device__ inline BandLayout band_layout(int version, int bk, int band_px, int stages) {
  BandLayout l;
  l.nbuf = (version == 1 || version == 6) ? 1 : 2;
  l.buf_bytes = align_up(band_px * bk * 2, 1024);
  l.band32 = l.nbuf * l.buf_bytes;
  l.ring = l.band32 + (version == 6 ? align_up(band_px * bk * 4, 1024) : 0);
  l.tables = l.ring + stages * SLAB_BYTES;
  l.bars = l.tables + TABLE_BYTES;
  l.total = 1024 + l.bars + BAR_BYTES;
  return l;
}

// The swizzled address of byte b of a band buffer whose 128-byte rows carry
// `mask` + 1 16-byte chunks XOR-permuted by the row (TMA's 128B, 64B and 32B
// swizzles for pixels of 128, 64 and 32 bytes: mask 7, 3, 1). Neighbouring
// pixels' same channels then lie in different banks.
__device__ __forceinline__ uint32_t swz(uint32_t b, uint32_t mask) { return b ^ (((b >> 7) & mask) << 4); }

struct BandArgs {
  const __nv_bfloat16* offset;  // (B, Ho, Wo, 18) (dy, dx) per tap
  const __nv_bfloat16* mask;    // (B, Ho, Wo, 9)
  const __nv_bfloat16* bias;    // (Cout,) or null
  __nv_bfloat16* out;           // (B, Ho, Wo, Cout)
  int H, W, C, Ho, Wo, Cout, stride, radius, br, bw, tiles_y, tiles_x, bk, stages;
};

// The consumer's walk over the k-steps in the one K order (16-channel group
// G, then tap): chunk k = G / (bk / 16) of the band, group gl within it, and
// the weight ring's slot and phase.
struct Cursor {
  int tap, gl, k, slot;
  uint32_t phase;
  __device__ __forceinline__ void next(int gpc, int stages) {
    if (++tap == 9) {
      tap = 0;
      if (++gl == gpc) {
        gl = 0;
        ++k;
      }
    }
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// One consumer thread's view: its two positions (rows p and p + 8 of the
// 128) and its channel pair offset cl (channels cl, cl + 1, cl + 8, cl + 9 of
// each group: the m16n8k16 A fragment).
template <int VERSION>
struct Blender {
  const int* s_idx;
  const float4* s_wt;
  const int* s_fast;
  const unsigned char* band;  // the current chunk's band (bf16; version 6: fp32)
  int p, cl, band_cols, bk, zero0, zero1;
  uint32_t mask;

  // The bf16 pairs (channels c, c + 1) and (c + 8, c + 9) of one corner pixel.
  __device__ __forceinline__ void corner16(int pix, int c, __nv_bfloat162& lo, __nv_bfloat162& hi) const {
    const uint32_t b = (uint32_t)(pix * bk + c) * 2u;
    lo = *reinterpret_cast<const __nv_bfloat162*>(band + swz(b, mask));
    hi = *reinterpret_cast<const __nv_bfloat162*>(band + swz(b + 16u, mask));
  }

  // The position's modulated sample at channels (c, c + 1) and (c + 8, c + 9),
  // as two bf16 pairs: the blend of its four corners in corner order.
  __device__ __forceinline__ void sample(int pos, int zero, int tap, int c, uint32_t& lo, uint32_t& hi) const {
    int idx;
    if (VERSION == 5 && s_fast[tap] >= 0) {
      idx = zero + s_fast[tap];
    } else {
      idx = s_idx[tap * BAND_M + pos];
    }
    const float4 w4 = s_wt[tap * BAND_M + pos];
    const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
    const int corner[4] = {idx, idx + 1, idx + band_cols, idx + band_cols + 1};
    if (VERSION == 3) {  // the blend in bf16
      __nv_bfloat162 vlo = __floats2bfloat162_rn(0.f, 0.f), vhi = vlo;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 w2 = __float2bfloat162_rn(wq[q]);
        __nv_bfloat162 flo, fhi;
        corner16(corner[q], c, flo, fhi);
        vlo = __hfma2(w2, flo, vlo);
        vhi = __hfma2(w2, fhi, vhi);
      }
      lo = *reinterpret_cast<uint32_t*>(&vlo);
      hi = *reinterpret_cast<uint32_t*>(&vhi);
      return;
    }
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float f[4];
      if (VERSION == 6) {  // the fp32 band: 8-byte pairs, swizzled as 128-byte rows
        const uint32_t b = (uint32_t)(corner[q] * bk + c) * 4u;
        const float2 flo = *reinterpret_cast<const float2*>(band + swz(b, 7u));
        const float2 fhi = *reinterpret_cast<const float2*>(band + swz(b + 32u, 7u));
        f[0] = flo.x; f[1] = flo.y; f[2] = fhi.x; f[3] = fhi.y;
      } else {
        __nv_bfloat162 blo, bhi;
        corner16(corner[q], c, blo, bhi);
        const float2 flo = __bfloat1622float2(blo), fhi = __bfloat1622float2(bhi);
        f[0] = flo.x; f[1] = flo.y; f[2] = fhi.x; f[3] = fhi.y;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] += wq[q] * f[j];
    }
    lo = pack_bf16(v[0], v[1]);
    hi = pack_bf16(v[2], v[3]);
  }

  // The A fragment of k-step (group gl of the chunk, tap): registers
  // {row p lo, row p + 8 lo, row p hi, row p + 8 hi}.
  __device__ __forceinline__ void fragment(int gl, int tap, uint32_t (&a)[4]) const {
    const int c = gl * GROUP + cl;
    sample(p, zero0, tap, c, a[0], a[2]);
    sample(p + 8, zero1, tap, c, a[1], a[3]);
  }
};

template <int VERSION>
__global__ void __launch_bounds__(BAND_THREADS, 1)
dcn_band_kernel(const __grid_constant__ CUtensorMap tm_x,  // x (B, H, W, C) as a 4-D map (C, W, H, B)
                const __grid_constant__ CUtensorMap tm_w,  // weight (9 C, Cout_w) as a 2-D map (Cout_w, 9 C)
                const BandArgs a) {
  constexpr bool F32_BAND = VERSION == 6;
  constexpr int NBUF = (VERSION == 1 || VERSION == 6) ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int band_rows = (a.br - 1) * a.stride + 2 * a.radius + 4;
  const int band_cols = (a.bw - 1) * a.stride + 2 * a.radius + 4;
  const int band_px = band_rows * band_cols;
  const BandLayout lay = band_layout(VERSION, a.bk, band_px, a.stages);
  int* s_idx = reinterpret_cast<int*>(gbase + lay.tables);
  float4* s_wt = reinterpret_cast<float4*>(s_idx + 9 * BAND_M);
  int* s_row = reinterpret_cast<int*>(s_wt + 9 * BAND_M);
  int* s_fast = s_row + BAND_M;
  int* s_lim = s_fast + 16;
  const uint32_t bars = base + lay.bars;
  const uint32_t full_band = bars, empty_band = bars + 16;  // [NBUF] each
  const uint32_t full_w = bars + 32, empty_w = bars + 32 + 8 * MAX_STAGES;  // [stages] each

  const int tid = threadIdx.x;
  const int per_img = a.tiles_y * a.tiles_x;
  const int b = blockIdx.x / per_img;
  const int t = blockIdx.x - b * per_img;
  const int oy0 = (t / a.tiles_x) * a.br;
  const int ox0 = (t % a.tiles_x) * a.bw;
  const int n0 = blockIdx.y * BAND_N;
  const int gpc = a.bk / GROUP;  // 16-channel groups per band chunk
  const int nchunks = a.C / a.bk;
  const int nsteps = (a.C / GROUP) * 9;

  if (tid == 0) {
    for (int i = 0; i < NBUF; ++i) {
      mbar_init(full_band + 8 * i, 1);
      mbar_init(empty_band + 8 * i, CONSUMERS);
    }
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full_w + 8 * s, 1);
      mbar_init(empty_w + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // ---- per-block tables: corner index and weights of every (tap, position) ----
  if (tid < 9) {
    s_lim[tid * 4 + 0] = INT_MAX;
    s_lim[tid * 4 + 1] = INT_MIN;
    s_lim[tid * 4 + 2] = INT_MAX;
    s_lim[tid * 4 + 3] = INT_MIN;
  }
  if (tid < BAND_M) {
    const int oy = oy0 + tid / a.bw;
    const int ox = ox0 + tid % a.bw;
    s_row[tid] = oy < a.Ho && ox < a.Wo ? (b * a.Ho + oy) * a.Wo + ox : -1;
  }
  __syncthreads();
  for (int e = tid; e < 9 * BAND_M; e += BAND_THREADS) {
    const int tap = e / BAND_M;
    const int p = e - tap * BAND_M;
    const int m = s_row[p];
    int idx = (p / a.bw) * a.stride * band_cols + (p % a.bw) * a.stride;  // the position's zero shift
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m >= 0) {
      const float rad = (float)a.radius;
      const float dy = __bfloat162float(a.offset[(long long)m * 18 + 2 * tap]);
      const float dx = __bfloat162float(a.offset[(long long)m * 18 + 2 * tap + 1]);
      const float mk = __bfloat162float(a.mask[(long long)m * 9 + tap]);
      const float rely = fminf(fmaxf(dy, -rad), rad) + (float)(tap / 3 - 1);
      const float relx = fminf(fmaxf(dx, -rad), rad) + (float)(tap % 3 - 1);
      const float fy = floorf(rely);
      const float fx = floorf(relx);
      const float ly = rely - fy;
      const float lx = relx - fx;
      const int sy = (int)fy + 1 + a.radius;  // in [0, 2 * radius + 2]
      const int sx = (int)fx + 1 + a.radius;
      idx += sy * band_cols + sx;
      w = make_float4((1.f - ly) * (1.f - lx) * mk, (1.f - ly) * lx * mk, ly * (1.f - lx) * mk, ly * lx * mk);
      if (isnan(dy) || isnan(dx)) w = nan4();
      if (VERSION == 5) {
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
  if (VERSION == 5 && tid < 9) {
    const int* l = s_lim + tid * 4;
    s_fast[tid] = l[0] == l[1] && l[2] == l[3] ? l[0] * band_cols + l[2] : -1;
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const int iy0 = oy0 * a.stride - 1 - a.radius;  // image row and column of band pixel (0, 0)
      const int ix0 = ox0 * a.stride - 1 - a.radius;
      const uint32_t band_tx = (uint32_t)(band_px * a.bk * 2);
      int slot = 0;
      uint32_t phase = 0;
      // The band of chunk k into buffer k % NBUF, once the consumers have released it.
      auto load_band = [&](int k) {
        const int i = k % NBUF;
        mbar_wait(empty_band + 8 * i, (uint32_t)((k / NBUF) & 1) ^ 1u);
        mbar_expect_tx(full_band + 8 * i, band_tx);
        tma_load_4d(base + i * lay.buf_bytes, &tm_x, full_band + 8 * i, k * a.bk, ix0, iy0, b);
      };
      load_band(0);
      for (int k = 0; k < nchunks; ++k) {
        for (int j = 0; j < gpc * 9; ++j) {  // the weight slabs of chunk k, in the K order
          // chunk k + 1's band: where two buffers take turns (version 6 frees its staging
          // buffer as a chunk starts), once the ring holds chunk k's first slabs, so that it
          // never runs dry; version 1 after chunk k's last step
          if (VERSION != 1 && j == a.stages && k + 1 < nchunks) load_band(k + 1);
          const int row = (j % 9) * a.C + (k * gpc + j / 9) * GROUP;
          mbar_wait(empty_w + 8 * slot, phase ^ 1u);
          mbar_expect_tx(full_w + 8 * slot, SLAB_BYTES);
          const uint32_t dst = base + lay.ring + slot * SLAB_BYTES;
#pragma unroll
          for (int pn = 0; pn < BAND_N / 64; ++pn)
            tma_load_2d(dst + pn * PANEL_BYTES, &tm_w, full_w + 8 * slot, n0 + 64 * pn, row);
          if (++slot == a.stages) {
            slot = 0;
            phase ^= 1u;
          }
        }
        if (VERSION == 1 && k + 1 < nchunks) load_band(k + 1);
      }
    }
  } else {
    // ---- consumers: 64 positions x 256 output channels each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = tid - 128;  // 0..255 over both consumer warpgroups
    const int warp = (ct & 127) >> 5, lane = ct & 31;
    Blender<VERSION> bl;
    bl.s_idx = s_idx;
    bl.s_wt = s_wt;
    bl.s_fast = s_fast;
    bl.p = (wg - 1) * 64 + 16 * warp + (lane >> 2);
    bl.cl = 2 * (lane & 3);
    bl.band_cols = band_cols;
    bl.bk = a.bk;
    bl.mask = (uint32_t)(a.bk / 8 - 1);
    bl.zero0 = (bl.p / a.bw) * a.stride * band_cols + (bl.p % a.bw) * a.stride;
    bl.zero1 = ((bl.p + 8) / a.bw) * a.stride * band_cols + ((bl.p + 8) % a.bw) * a.stride;
    bl.band = gbase;

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t a0[4], a1[4];
    Cursor cur{0, 0, 0, 0, 0u};
    int prev_slot = -1;

    // Enter chunk k: release chunk k - 1's band buffer, wait for chunk k's.
    auto enter = [&](int k) {
      if (!F32_BAND && k > 0) mbar_arrive(empty_band + 8 * ((k - 1) % NBUF));
      mbar_wait(full_band + 8 * (k % NBUF), (uint32_t)((k / NBUF) & 1));
      if (F32_BAND) {
        named_sync(1, CONSUMERS);  // every consumer is done with chunk k - 1's fp32 band
        const unsigned char* src = gbase;
        unsigned char* dst = gbase + lay.band32;
        for (int v = ct; v < band_px * a.bk / 8; v += CONSUMERS) {  // 8 channels per item
          const uint4 raw16 = *reinterpret_cast<const uint4*>(src + swz((uint32_t)v * 16u, bl.mask));
          const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw16);
          const float2 f0 = __bfloat1622float2(p2[0]), f1 = __bfloat1622float2(p2[1]);
          const float2 f2 = __bfloat1622float2(p2[2]), f3 = __bfloat1622float2(p2[3]);
          *reinterpret_cast<float4*>(dst + swz((uint32_t)v * 32u, 7u)) = make_float4(f0.x, f0.y, f1.x, f1.y);
          *reinterpret_cast<float4*>(dst + swz((uint32_t)v * 32u + 16u, 7u)) = make_float4(f2.x, f2.y, f3.x, f3.y);
        }
        named_sync(1, CONSUMERS);  // chunk k's fp32 band is complete
        mbar_arrive(empty_band);   // the staging buffer takes chunk k + 1
        bl.band = dst;
      } else {
        bl.band = gbase + (k % NBUF) * lay.buf_bytes;
      }
    };
    // One k-step: its A fragment into `frag` (blended while the previous
    // step's product runs), then its product, leaving it in flight.
    auto step = [&](uint32_t (&frag)[4]) {
      if (cur.tap == 0 && cur.gl == 0) enter(cur.k);
      bl.fragment(cur.gl, cur.tap, frag);
      mbar_wait(full_w + 8 * cur.slot, cur.phase);
      wg_fence();
      wgmma_o(acc, frag, sw128_desc(base + lay.ring + cur.slot * SLAB_BYTES, PANEL_BYTES, 1024));
      wg_commit();
      wg_wait1();  // the previous step's product is done: its slab is free
      if (prev_slot >= 0) mbar_arrive(empty_w + 8 * prev_slot);
      prev_slot = cur.slot;
      cur.next(gpc, a.stages);
    };
    int s = 0;
    for (; s + 1 < nsteps; s += 2) {
      step(a0);
      step(a1);
    }
    if (s < nsteps) step(a0);
    wg_wait0();
    fence_regs(acc);

    // ---- epilogue: bias in registers, bf16 out ----
    const int col = bl.cl;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = s_row[bl.p + 8 * i];
      if (m < 0) continue;
      __nv_bfloat16* orow = a.out + (long long)m * a.Cout;
#pragma unroll
      for (int j = 0; j < BAND_N / 8; ++j) {
        const int n = n0 + 8 * j + col;
        if (n >= a.Cout) continue;
        float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
        if (a.bias != nullptr) {
          v0 += __bfloat162float(a.bias[n]);
          v1 += __bfloat162float(a.bias[n + 1]);
        }
        *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16(v0, v1);
      }
    }
  }
}

// cuTensorMapEncodeTiled for the band kernel: x (B, H, W, C) bf16 as (C, W,
// H, B) in (bk, band_cols, band_rows, 1) boxes, swizzled by the pixel's bytes
// (out-of-image coordinates read as zeros: the window composite's padding);
// the weight (9 C, cout_w) as (cout_w, 9 C) in 64 x 16 boxes, 128-byte swizzle.
bool band_maps(CUtensorMap* tx, CUtensorMap* tw, const void* x, const void* weight, int B, int H, int W, int C,
               int cout_w, int bk, int band_cols, int band_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const CUtensorMapSwizzle sw = bk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : bk == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)bk, (cuuint32_t)band_cols, (cuuint32_t)band_rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdims, xstrides, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const cuuint64_t wdims[2] = {(cuuint64_t)cout_w, (cuuint64_t)9 * C};
  const cuuint64_t wstrides[1] = {(cuuint64_t)cout_w * 2};
  const cuuint32_t wbox[2] = {64, GROUP};
  return encode(tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(weight), wdims, wstrides, wbox, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int VERSION>
int launch_band(const CUtensorMap& tx, const CUtensorMap& tw, const BandArgs& args, int B, int smem_bytes,
                cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(dcn_band_kernel<VERSION>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)(B * args.tiles_y * args.tiles_x), (unsigned)((args.Cout + BAND_N - 1) / BAND_N));
  dcn_band_kernel<VERSION><<<grid, BAND_THREADS, smem_bytes, stream>>>(tx, tw, args);
  return (int)cudaGetLastError();
}

// ---- the gather kernel -------------------------------------------------------

constexpr int GATHER_THREADS = 384;  // the gather warpgroup, then two consumer warpgroups
constexpr int GATHERERS = 128;
constexpr int CHUNK = 64;                                // input channels per stage (128 bytes a position)
constexpr int A_BYTES = BAND_M * CHUNK * 2;              // 128 positions x 64 bf16, 16 KB
constexpr int W_PANEL_BYTES = CHUNK * 128;               // 64 weight rows x 64 columns, 8 KB
constexpr int W_BYTES = (BAND_N / 64) * W_PANEL_BYTES;   // 64 rows x 256 columns, 32 KB
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int GATHER_STAGES = 3;  // the ring: 2, 3 and 4 ran alike (tools/perf_dcn_band); 3 leaves L1 more room
// Dynamic shared memory, in bytes from a 1024-aligned base: the stages (A
// tile, then the weight panels), the table (s_pix, s_gw, s_in), the full /
// empty barriers; GATHER_SMEM adds the 1024 bytes of slack that align the base.
constexpr int GATHER_TABLE = GATHER_STAGES * STAGE_BYTES;
constexpr int GATHER_BARS = GATHER_TABLE + 9 * BAND_M * (4 + 16 + 1);
constexpr int GATHER_SMEM = 1024 + GATHER_BARS + 2 * GATHER_STAGES * 8;
static_assert(GATHER_BARS % 8 == 0 && GATHER_SMEM <= SMEM_LIMIT, "the gather kernel's shared memory");

struct GatherArgs {
  const __nv_bfloat16* x;       // (B, H, W, C)
  const __nv_bfloat16* offset;  // (B, Ho, Wo, 18) (dy, dx) per tap
  const __nv_bfloat16* mask;    // (B, Ho, Wo, 9)
  const __nv_bfloat16* bias;    // (Cout,) or null
  __nv_bfloat16* out;           // (B, Ho, Wo, Cout)
  int H, W, C, Ho, Wo, Cout, stride, radius, M;
};

__global__ void __launch_bounds__(GATHER_THREADS, 1)
dcn_gather_kernel(const __grid_constant__ CUtensorMap tm_w,  // weight (3, 3, C, Cout) as a 3-D map (Cout, C, 9)
                  const GatherArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  int* s_pix = reinterpret_cast<int*>(gbase + GATHER_TABLE);
  float4* s_gw = reinterpret_cast<float4*>(s_pix + 9 * BAND_M);
  unsigned char* s_in = reinterpret_cast<unsigned char*>(s_gw + 9 * BAND_M);
  const uint32_t full = base + GATHER_BARS, empty = full + 8 * GATHER_STAGES;  // [GATHER_STAGES] each

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BAND_M;
  const int n0 = blockIdx.y * BAND_N;
  const int nchunks = (a.C + CHUNK - 1) / CHUNK;

  if (tid == 0) {
    for (int s = 0; s < GATHER_STAGES; ++s) {
      mbar_init(full + 8 * s, GATHERERS + 1);  // every gather thread, and the weight's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // ---- the table: top-left pixel, four corner weights and which corners lie
  // in the image, for every (tap, position) ----
  const int hw_out = a.Ho * a.Wo;
  for (int e = tid; e < 9 * BAND_M; e += GATHER_THREADS) {
    const int tap = e / BAND_M;
    const int m = m0 + (e - tap * BAND_M);
    const int ky = tap / 3, kx = tap % 3;
    int pix = 0;
    float4 gw = make_float4(0.f, 0.f, 0.f, 0.f);
    unsigned in = 0;  // bit q: corner q lies in the image (of a sample the mode keeps)
    if (m < a.M) {
      const int b = m / hw_out;
      const int r = m - b * hw_out;
      const int oy = r / a.Wo;
      const int ox = r - oy * a.Wo;
      const float dy = __bfloat162float(a.offset[(long long)m * 18 + 2 * tap]);
      const float dx = __bfloat162float(a.offset[(long long)m * 18 + 2 * tap + 1]);
      const float mk = __bfloat162float(a.mask[(long long)m * 9 + tap]);
      const float y = (float)(oy * a.stride - 1 + ky) + dy;  // the exact mode's sample
      const float xx = (float)(ox * a.stride - 1 + kx) + dx;
      bool live;
      int y0 = 0, x0 = 0;
      float ly = 0.f, lx = 0.f;
      if (a.radius >= 0) {  // clipped: rel = clip(offset) + tap; corners outside the image are 0
        const float rad = (float)a.radius;
        const float rely = fminf(fmaxf(dy, -rad), rad) + (float)(ky - 1);
        const float relx = fminf(fmaxf(dx, -rad), rad) + (float)(kx - 1);
        const float fy = floorf(rely);
        const float fx = floorf(relx);
        y0 = oy * a.stride + (int)fy;
        x0 = ox * a.stride + (int)fx;
        ly = rely - fy;
        lx = relx - fx;
        live = true;
      } else {  // exact: zero for samples at or beyond one pixel outside the image
        live = y > -1.f && y < (float)a.H && xx > -1.f && xx < (float)a.W;
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
        const bool in_y0 = y0 >= 0 && y0 < a.H, in_y1 = y0 + 1 >= 0 && y0 + 1 < a.H;
        const bool in_x0 = x0 >= 0 && x0 < a.W, in_x1 = x0 + 1 >= 0 && x0 + 1 < a.W;
        pix = (b * a.H + y0) * a.W + x0;  // may lie outside the image: only corners inside are read
        in = (in_y0 && in_x0) | (in_y0 && in_x1) << 1 | (in_y1 && in_x0) << 2 | (in_y1 && in_x1) << 3;
        gw = make_float4(in_y0 && in_x0 ? (1.f - ly) * (1.f - lx) * mk : 0.f,
                         in_y0 && in_x1 ? (1.f - ly) * lx * mk : 0.f,
                         in_y1 && in_x0 ? ly * (1.f - lx) * mk : 0.f,
                         in_y1 && in_x1 ? ly * lx * mk : 0.f);
      }
      // a NaN offset: NaN weights on zero or loaded corners, a NaN sample; in the exact mode only where its
      // other coordinate lies inside, as the exact composite drops a sample outside (NaN compares false)
      const bool outside = y <= -1.f || y >= (float)a.H || xx <= -1.f || xx >= (float)a.W;
      if ((isnan(dy) || isnan(dx)) && !(a.radius < 0 && outside)) gw = nan4();
    }
    s_pix[e] = pix;
    s_gw[e] = gw;
    s_in[e] = (unsigned char)in;
  }
  __syncthreads();

  if (tid < GATHERERS) {
    // ---- gather warps: A stages, and each stage's weight by TMA ----
    const int j = tid & 7;    // 8-channel group of the chunk
    const int p0 = tid >> 3;  // positions p0 + 16 i, i = 0 .. 7
    const int dq[4] = {0, 1, a.W, a.W + 1};
    int slot = 0;
    uint32_t phase = 0;
    for (int tap = 0; tap < 9; ++tap) {
      for (int k = 0; k < nchunks; ++k) {
        mbar_wait(empty + 8 * slot, phase ^ 1u);
        const uint32_t st = base + slot * STAGE_BYTES;
        if (tid == 0) {
          mbar_expect_tx(full + 8 * slot, W_BYTES);
#pragma unroll
          for (int pn = 0; pn < BAND_N / 64; ++pn)
            tma_load(st + A_BYTES + pn * W_PANEL_BYTES, &tm_w, full + 8 * slot, n0 + 64 * pn, k * CHUNK, tap);
        }
        const int c = k * CHUNK + 8 * j;
        const bool live_c = c < a.C;
#pragma unroll
        for (int h = 0; h < 8; h += 4) {
          uint4 cv[4][4];
          float wq[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {  // four positions' corner loads in flight together
            const int e = tap * BAND_M + p0 + 16 * (h + u);
            const int pix = s_pix[e];
            const float4 g4 = s_gw[e];
            const unsigned in = s_in[e];
            wq[u][0] = g4.x; wq[u][1] = g4.y; wq[u][2] = g4.z; wq[u][3] = g4.w;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              cv[u][q] = make_uint4(0u, 0u, 0u, 0u);
              if (live_c && (in >> q & 1u))  // every corner in the image, whatever its weight
                cv[u][q] = __ldg(reinterpret_cast<const uint4*>(a.x + (pix + dq[q]) * a.C + c));
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&cv[u][q]);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(b2[i]);
                v[2 * i] += wq[u][q] * f.x;
                v[2 * i + 1] += wq[u][q] * f.y;
              }
            }
            const int p = p0 + 16 * (h + u);
            *reinterpret_cast<uint4*>(gbase + (st - base) + p * 128 + ((j ^ (p & 7)) << 4)) =
                make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                           pack_bf16(v[6], v[7]));
          }
        }
        fence_async_smem();  // the stores, before the consumers' wgmma reads them
        mbar_arrive(full + 8 * slot);
        if (++slot == GATHER_STAGES) {
          slot = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers: 64 positions x 256 output channels each ----
    const int cw = (tid - GATHERERS) >> 7;  // consumer warpgroup: positions 64 cw ..
    const int warp = (tid & 127) >> 5, lane = tid & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int slot = 0, prev = -1;
    uint32_t phase = 0;
    for (int s = 0; s < 9 * nchunks; ++s) {
      mbar_wait(full + 8 * slot, phase);
      const uint32_t st = base + slot * STAGE_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / GROUP; ++kk)
        wgmma_ss(acc, sw128_desc(st + cw * 64 * 128 + kk * 32, 0, 1024),
                 sw128_desc(st + A_BYTES + kk * GROUP * 128, W_PANEL_BYTES, 1024));
      wg_commit();
      wg_wait1();  // the previous stage's products are done: its stage is free
      if (prev >= 0) mbar_arrive(empty + 8 * prev);
      prev = slot;
      if (++slot == GATHER_STAGES) {
        slot = 0;
        phase ^= 1u;
      }
    }
    wg_wait0();
    fence_regs(acc);

    // ---- epilogue: bias in registers, bf16 out ----
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + cw * 64 + 16 * warp + (lane >> 2) + 8 * i;
      if (m >= a.M) continue;
      __nv_bfloat16* orow = a.out + (long long)m * a.Cout;
#pragma unroll
      for (int jn = 0; jn < BAND_N / 8; ++jn) {
        const int n = n0 + 8 * jn + col;
        if (n >= a.Cout) continue;
        float v0 = acc[4 * jn + 2 * i], v1 = acc[4 * jn + 2 * i + 1];
        if (a.bias != nullptr) {
          v0 += __bfloat162float(a.bias[n]);
          v1 += __bfloat162float(a.bias[n + 1]);
        }
        *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16(v0, v1);
      }
    }
  }
}

// cuTensorMapEncodeTiled for the gather kernel's weight: (3, 3, C, Cout) bf16
// as (Cout, C, 9) in 64 x 64 x 1 boxes, 128-byte swizzle; coordinates past C
// or Cout read as zeros.
bool gather_weight_map(CUtensorMap* tw, const void* weight, int C, int Cout) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Cout, (cuuint64_t)C, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)C * Cout * 2};
  const cuuint32_t box[3] = {64, CHUNK, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(weight), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// C interface (loaded with ctypes). Each returns cudaGetLastError() after the launch.

// The gather kernel: exact for radius < 0, else offsets clipped to +-radius.
extern "C" int mqdet_dcn_forward(const void* x, const void* offset, const void* mask, const void* weight,
                                 const void* bias, void* out, int B, int H, int W, int C, int Ho, int Wo,
                                 int Cout, int stride, int radius, void* stream) {
  const long long M = (long long)B * Ho * Wo;
  if ((stride != 1 && stride != 2) || C < 8 || C % 8 != 0 || Cout < 8 || Cout % 8 != 0 || M >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap tw;
  if (!gather_weight_map(&tw, weight, C, Cout)) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(dcn_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GATHER_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const GatherArgs args{reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(offset),
                        reinterpret_cast<const __nv_bfloat16*>(mask), reinterpret_cast<const __nv_bfloat16*>(bias),
                        reinterpret_cast<__nv_bfloat16*>(out), H, W, C, Ho, Wo, Cout, stride, radius, (int)M};
  dim3 grid((unsigned)((M + BAND_M - 1) / BAND_M), (unsigned)((Cout + BAND_N - 1) / BAND_N));
  dcn_gather_kernel<<<grid, GATHER_THREADS, GATHER_SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(tw, args);
  return (int)cudaGetLastError();
}

// The band kernel at tile br x bw (br * bw = 128), channel chunk bk (64, 32
// or 16), a weight ring of `stages` slabs (2 to 8). The weight has Cout
// rounded up to a multiple of 256 columns (zeros past Cout). smem_bytes is the
// caller's count of the dynamic shared memory; a count that differs from this
// file's layout, or exceeds what a block may use, is refused, as is a band
// wider than a TMA box (256 pixels a side).
extern "C" int mqdet_dcn_band_forward(const void* x, const void* offset, const void* mask, const void* weight,
                                      const void* bias, void* out, int B, int H, int W, int C, int Ho, int Wo,
                                      int Cout, int stride, int radius, int br, int bw, int version, int bk,
                                      int stages, int smem_bytes, void* stream) {
  const int band_rows = (br - 1) * stride + 2 * radius + 4;
  const int band_cols = (bw - 1) * stride + 2 * radius + 4;
  if (br < 1 || br * bw != BAND_M || radius < 0 || (stride != 1 && stride != 2) ||
      (bk != 16 && bk != 32 && bk != 64) || C % bk != 0 || Cout % 8 != 0 || stages < 2 || stages > MAX_STAGES ||
      band_rows > 256 || band_cols > 256)
    return (int)cudaErrorInvalidValue;
  const BandLayout lay = band_layout(version, bk, band_rows * band_cols, stages);
  if (lay.total != smem_bytes || lay.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!band_maps(&tx, &tw, x, weight, B, H, W, C, align_up(Cout, BAND_N), bk, band_cols, band_rows))
    return (int)cudaErrorInvalidValue;
  const BandArgs args{reinterpret_cast<const __nv_bfloat16*>(offset), reinterpret_cast<const __nv_bfloat16*>(mask),
                      reinterpret_cast<const __nv_bfloat16*>(bias), reinterpret_cast<__nv_bfloat16*>(out),
                      H, W, C, Ho, Wo, Cout, stride, radius, br, bw, (Ho + br - 1) / br, (Wo + bw - 1) / bw, bk,
                      stages};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (version) {
    case 1: return launch_band<1>(tx, tw, args, B, smem_bytes, s);
    case 2: return launch_band<2>(tx, tw, args, B, smem_bytes, s);
    case 3: return launch_band<3>(tx, tw, args, B, smem_bytes, s);
    case 5: return launch_band<5>(tx, tw, args, B, smem_bytes, s);
    case 6: return launch_band<6>(tx, tw, args, B, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
