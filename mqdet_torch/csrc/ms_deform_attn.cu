// Multi-scale deformable attention (MSDA) sampling, forward, on Hopper:
//
//   out[b, q, h, :] = sum_{l, p} attn[b, q, h, l, p] *
//                     bilinear(value level l of head h, (x, y))
//   (x, y) = loc[b, q, h, l, p] * (W_l, H_l) - 0.5
//
// with zero padding corner by corner (grid_sample, align_corners=False).
//
// Exact mode, msda_forward_kernel: the gather composite
// mqdet_tpu/ops/ms_deform_attn.py::ms_deform_attn_sample at any level shapes
// and for any queries (the decoder's 900 queries, MQDET_MSDA_IMPL=gather).
// hd / 8 lanes per (b, q, head); each lane owns 8 channels and reads each
// bilinear corner as one 16-byte load from device memory.
//
// Clipped mode, msda_band_kernel: the function of the TPU's encoder kernel
// K5, mqdet_tpu/ops/pallas/msda_pallas.py::ms_deform_attn_encoder (`_kernel`
// :81, launched through pallas_call at :455), which it replaces on the
// encoder path (queries are the pyramid's pixels, Q = S). Each sample pixel
// is clamped per axis to a window around its query by the (query level lq,
// value level lv) pair's rule of PairTable, filled by the host from
// mqdet_torch/ops/ms_deform_attn.py::clip_pairs:
//   COARSE (lv >= lq at an exact ratio k): y in [c - R, c + R + 1],
//     c = floor((yq + 0.5) / k - 0.5);
//   FINER (lv < lq at an exact ratio f): y in [c - R, c + R + 1],
//     c = f (yq + 0.5) - 0.5;
//   EXACT: no clamp (non-exact ratios, f = 8);
// x likewise with xq.
//
// What bounds the clipped mode on the H100. Its compulsory traffic at
// GroundingDINO's encoder shape (B 4, S = Q = 22323, 8 heads of 32, 4 levels
// x 4 points) is 228 MB (value 45.7, fp32 locations 91.4 and weights 45.7,
// output 45.7), 0.068 ms at 3.35 TB/s, while gathering every corner from
// device memory, as the exact mode does, asks the L1/L2 for 16 samples x 4
// corners x 64 B = 4 KB per (q, head), 2.9 GB per call. The clip confines
// the pixels a tile of queries can touch to a known band of each level, so
// the kernel stages that band in shared memory, as the TPU kernel DMAs it
// into VMEM (msda_pallas.py:34-36), and gathers there. The 2.9 GB then come
// from shared memory (about 0.1 ms at its ~30 TB/s over 132 SMs), and the
// kernel is bound by those reads, by unpacking and weighing 1.46 G bf16
// corner values on the integer and fp32 pipes (each ~0.05-0.1 ms), and by
// the latency of both at two blocks per SM (tools/perf_msda_band.py
// measures each part):
//   - a block is a tile of 8 query rows x (32 / lanes) query columns of one
//     query level, one head, one batch item, lanes = hd / 8 threads per query
//     (256 threads: a warp is one tile row, lane-major, so the 8 threads of
//     one 16-byte shared-memory phase read the same channels of 8
//     neighbouring queries' corners). Lane j takes value levels j, j + lanes,
//     ..., all hd channels, so each sample's coordinates are computed once;
//     the lanes' sums meet by a reduce-scatter of shuffles at the end;
//   - per value level the host's band table (ops/ms_deform_attn.py::
//     msda_band_geometry) says BAND (a COARSE pair: rows [c(y_first) - R,
//     c(y_last) + R + 2], columns likewise; "+ 2": a coordinate clamped to
//     exactly c + R + 1 reads row c + R + 2 with weight 0), WHOLE (an EXACT
//     pair whose level fits: staged whole) or GATHER (FINER pairs and
//     larger EXACT levels: the exact mode's clamped global gather,
//     gather_level, shared with msda_forward_kernel);
//   - one TMA load per staged level fills its band, from a tensor map over
//     the value level viewed as (nh hd, W, H, B) with a box of (hd, band
//     columns, band rows, 1); out-of-map coordinates are zero-filled, which
//     is grid_sample's zero padding, so a BAND gather needs no bounds test.
//     Every band of the tile is in flight at once, each in its own region,
//     behind one mbarrier (the lanes take the levels side by side, so no
//     band waits for another's buffer); GATHER levels run meanwhile. At
//     hd 32 the band's 64-byte pixel rows are 64B-swizzled and the gather
//     XORs its chunk addresses to match, which spreads neighbouring pixels'
//     rows over the banks;
//   - locations and weights are prefetched into L1 as the bands land and
//     read as 16-byte vectors (P % 4 == 0);
//   - accumulation is fp32 in registers; the output row is written once in
//     bf16. Both modes take head widths 8 and 32 and up to 4 levels; their
//     tables are __grid_constant__ (indexed by a runtime level without a
//     stack frame).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int THREADS = 256;
constexpr int TILE_ROWS = THREADS / 32;  // the band kernel's tile: one query row per warp
constexpr int MAX_BAND_BYTES = 24576;    // a staged band's cap (ops/ms_deform_attn.py MSDA_BAND_BYTES)

struct LevelTable {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];  // first row of the level in the flattened S axis
};

enum PairMode { EXACT = 0, COARSE = 1, FINER = 2 };
enum Stage { GATHER = 0, BAND = 1, WHOLE = 2 };

// The clipped mode's rule per (query level, value level) pair.
struct PairTable {
  int mode[MAX_LEVELS][MAX_LEVELS];
  float scale[MAX_LEVELS][MAX_LEVELS];   // 1 / k (COARSE; k a power of two, so exact) or f (FINER)
  float radius[MAX_LEVELS][MAX_LEVELS];  // R (COARSE) or FINER_RV (FINER)
};

// The band kernel's staging per (query level, value level) pair and its grid.
struct BandTable {
  CUtensorMap map[MAX_LEVELS][MAX_LEVELS];  // value level lv, box (hd, cols, rows, 1); staged pairs only
  int stage[MAX_LEVELS][MAX_LEVELS];
  int cols[MAX_LEVELS][MAX_LEVELS];
  int offset[MAX_LEVELS][MAX_LEVELS];  // the band's first byte in shared memory
  int tx_bytes[MAX_LEVELS];            // the bytes staged for a tile of query level lq
  int tiles_x[MAX_LEVELS];             // tiles per row of query level lq
  int tile0[MAX_LEVELS + 1];           // first block of query level lq
  int bar_offset;                      // the mbarrier, past every query level's bands
};

// The clamp range of one axis of a sample at value level lv for query coordinate qc.
__device__ __forceinline__ void window(int mode, float scale, float radius, float qc, float& lo, float& hi) {
  const float c = mode == COARSE ? floorf((qc + 0.5f) * scale - 0.5f) : scale * (qc + 0.5f) - 0.5f;
  lo = c - radius;
  hi = c + radius + 1.f;
}

// acc[c0, c0 + 8) += w * the 8 bf16 channels of raw. A bf16 is the high half
// of its fp32: the unpacking is a shift and a mask (exact), kept explicit.
template <int N>
__device__ __forceinline__ void accumulate8(float (&acc)[N], int c0, float w, const uint4& raw) {
  const uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[c0 + 2 * j] += w * __uint_as_float(v[j] << 16);
    acc[c0 + 2 * j + 1] += w * __uint_as_float(v[j] & 0xffff0000u);
  }
}

// One level's P samples of one (q, head), gathered from device memory into
// CHUNKS x 8 channels: vl points at the first channel of pixel 0 of the
// level; lp / ap at the level's P (x, y) pairs and weights. mode EXACT: no
// clamp.
template <int CHUNKS>
__device__ __forceinline__ void gather_level(float (&acc)[CHUNKS * 8], const __nv_bfloat16* vl,
                                             long long row_stride, int h, int w, const float2* lp, const float* ap,
                                             int P, int mode, float scale, float radius, float yq, float xq) {
  float ylo = 0.f, yhi = 0.f, xlo = 0.f, xhi = 0.f;
  if (mode != EXACT) {
    window(mode, scale, radius, yq, ylo, yhi);
    window(mode, scale, radius, xq, xlo, xhi);
  }
  for (int p = 0; p < P; ++p) {
    const float2 xy = lp[p];
    const float a = ap[p];
    float x = xy.x * (float)w - 0.5f;
    float y = xy.y * (float)h - 0.5f;
    if (mode != EXACT) {
      x = fminf(fmaxf(x, xlo), xhi);
      y = fminf(fmaxf(y, ylo), yhi);
    }
    // every corner lies outside the map: the sample is zero
    if (!(y > -1.f && y < (float)h && x > -1.f && x < (float)w)) continue;
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float lx = x - x0f;
    const float ly = y - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const float cw[4] = {(1.f - ly) * (1.f - lx) * a, (1.f - ly) * lx * a, ly * (1.f - lx) * a, ly * lx * a};
    const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
    const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (cy[k] >= 0 && cy[k] < h && cx[k] >= 0 && cx[k] < w) {
        const __nv_bfloat16* px = vl + ((long long)cy[k] * w + cx[k]) * row_stride;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(px + 8 * c);
          accumulate8(acc, 8 * c, cw[k], raw);
        }
      }
    }
  }
}

__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&acc)[8]) {
  __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) packed[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
}

// The exact mode: one thread per (b, q, head, lane).
template <int LANES>
__global__ void __launch_bounds__(THREADS)
msda_forward_kernel(const __nv_bfloat16* __restrict__ value,  // (B, S, nh, hd)
                    const float* __restrict__ loc,            // (B, Q, nh, L, P, 2) (x, y)
                    const float* __restrict__ attn,           // (B, Q, nh, L, P)
                    __nv_bfloat16* __restrict__ out,          // (B, Q, nh * hd)
                    const __grid_constant__ LevelTable lv, int S, int Q, int nh, int L, int P,
                    long long n_groups) {
  constexpr int HD = LANES * 8;
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long group = gid / LANES;  // flat (b, q, head)
  if (group >= n_groups) return;
  const int lane = (int)(gid - group * LANES);
  const int head = (int)(group % nh);
  const int b = (int)(group / nh / Q);
  const long long row_stride = (long long)nh * HD;  // elements from one pixel to the next
  const __nv_bfloat16* vb = value + ((long long)b * S * nh + head) * HD + lane * 8;
  const float2* lp = reinterpret_cast<const float2*>(loc) + group * L * P;
  const float* ap = attn + group * L * P;

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int l = 0; l < L; ++l)
    gather_level<1>(acc, vb + (long long)lv.start[l] * row_stride, row_stride, lv.h[l], lv.w[l], lp + l * P,
                    ap + l * P, P, EXACT, 0.f, 0.f, 0.f, 0.f);
  store_row(out + group * HD + lane * 8, acc);
}

// The first band row and column of a staged pair for the tile at (ty0, tx0):
// c(ty0) - R for a BAND, 0 for a WHOLE level.
__device__ __forceinline__ void band_origin(const PairTable& pt, int stage, int lq, int lv, int ty0, int tx0,
                                            int& oy, int& ox) {
  oy = ox = 0;
  if (stage == BAND) {
    float lo, hi;
    window(COARSE, pt.scale[lq][lv], pt.radius[lq][lv], (float)ty0, lo, hi);
    oy = (int)lo;
    window(COARSE, pt.scale[lq][lv], pt.radius[lq][lv], (float)tx0, lo, hi);
    ox = (int)lo;
  }
}

// 16 bytes of shared memory at a 32-bit shared address.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// One level's P samples of one (q, head) from a staged band in shared
// memory, all HD channels (band: the shared address of the band's first
// byte; cols: its width; (oy, ox): the level pixel of its first row and
// column). A BAND clamps to the pair's window [ylo, yhi] x [xlo, xhi], and
// every corner of a clamped sample lies in the band (a corner outside the
// map reads TMA's zeros); a WHOLE level clamps to [-1, h] x [-1, w], which
// leaves a sample with a corner in the map as it is and gives any other
// sample weight 0, and skips its corners outside the map, as the gather
// does. Locations and weights are read 16 bytes at a time where P % 4 == 0.
template <int HD>
__device__ __forceinline__ void band_level(float (&acc)[HD], uint32_t band, int cols, int oy, int ox,
                                           int h, int w, const float* lp, const float* ap, int P, bool whole,
                                           float ylo, float yhi, float xlo, float xhi) {
  const bool vec = (P & 3) == 0;
  for (int p0 = 0; p0 < P; p0 += 4) {
    float px[4], py[4], pa[4];
    if (vec) {  // the weights of 4 points, the (x, y) of 2, per 16-byte read
      const float4 a4 = *reinterpret_cast<const float4*>(ap + p0);
      const float4 l01 = *reinterpret_cast<const float4*>(lp + 2 * p0);
      const float4 l23 = *reinterpret_cast<const float4*>(lp + 2 * p0 + 4);
      pa[0] = a4.x; pa[1] = a4.y; pa[2] = a4.z; pa[3] = a4.w;
      px[0] = l01.x; py[0] = l01.y; px[1] = l01.z; py[1] = l01.w;
      px[2] = l23.x; py[2] = l23.y; px[3] = l23.z; py[3] = l23.w;
    } else {  // points past P weigh 0
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = p0 + i < P;
        pa[i] = in ? ap[p0 + i] : 0.f;
        px[i] = in ? lp[2 * (p0 + i)] : 0.f;
        py[i] = in ? lp[2 * (p0 + i) + 1] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = pa[i];
      const float x = fminf(fmaxf(px[i] * (float)w - 0.5f, xlo), xhi);
      const float y = fminf(fmaxf(py[i] * (float)h - 0.5f, ylo), yhi);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float lx = x - x0f;
      const float ly = y - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float cw[4] = {(1.f - ly) * (1.f - lx) * a, (1.f - ly) * lx * a, ly * (1.f - lx) * a, ly * lx * a};
      const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
      const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (whole && !(cy[k] >= 0 && cy[k] < h && cx[k] >= 0 && cx[k] < w)) continue;
        const uint32_t pix = band + (uint32_t)(((cy[k] - oy) * cols + (cx[k] - ox)) * HD * 2);
        // TMA's 64B swizzle of 64-byte pixel rows puts chunk c of a row at chunk c ^ ((pix >> 7) & 3)
        // (the band starts 1024-aligned)
        const uint32_t sw = HD == 32 ? (pix >> 3) & 0x30u : 0u;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) accumulate8(acc, 8 * c, cw[k], lds128(pix | ((16u * c) ^ sw)));
      }
    }
  }
}

// The clipped mode. Grid (tiles of all query levels, heads, batch items); a
// block is a tile of 8 query rows x (32 / LANES) columns, LANES threads per
// query (lane-major in a warp: one warp is one tile row), thread `lane`
// taking value levels lane, lane + LANES, ... with all HD channels. Thread 0
// issues every staged band of the tile at once, each into its own region of
// shared memory (bt.offset, from a 1024-aligned base), behind one mbarrier;
// a thread waits for it when it reaches its first staged level, and gathers
// GATHER levels from device memory meanwhile. The lanes' partial sums meet
// by a reduce-scatter of shuffles, each lane keeping its 8 output channels.
// (Two blocks per SM: at hd 32 ptxas takes 108 registers; capped at 80 for
// three blocks, or at 64 with no block count, it spills.)
template <int LANES>
__global__ void __launch_bounds__(THREADS, 2)
msda_band_kernel(const __nv_bfloat16* __restrict__ value,  // (B, S, nh, hd)
                 const float* __restrict__ loc,            // (B, S, nh, L, P, 2) (x, y)
                 const float* __restrict__ attn,           // (B, S, nh, L, P)
                 __nv_bfloat16* __restrict__ out,          // (B, S, nh * hd)
                 const __grid_constant__ LevelTable lv, const __grid_constant__ PairTable pt,
                 const __grid_constant__ BandTable bt, int S, int nh, int L, int P) {
  constexpr int HD = LANES * 8;
  constexpr int QPW = 32 / LANES;  // queries per warp: the tile's width
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar = base + (uint32_t)bt.bar_offset;

  // this block's tile, and this thread's query and lane
  int lq = 0;
  while (lq + 1 < L && (int)blockIdx.x >= bt.tile0[lq + 1]) ++lq;
  const int tile = (int)blockIdx.x - bt.tile0[lq];
  const int ty0 = (tile / bt.tiles_x[lq]) * TILE_ROWS, tx0 = (tile % bt.tiles_x[lq]) * QPW;
  const int head = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x & 31;
  const int lane = r / QPW;
  const int yq = ty0 + (int)(threadIdx.x >> 5), xq = tx0 + r % QPW;
  const bool active = yq < lv.h[lq] && xq < lv.w[lq];
  const long long group = ((long long)b * S + lv.start[lq] + (long long)yq * lv.w[lq] + xq) * nh + head;
  const long long row_stride = (long long)nh * HD;
  const __nv_bfloat16* vb = value + ((long long)b * S * nh + head) * HD;
  const float* lp = loc + group * L * P * 2;
  const float* ap = attn + group * L * P;

  const int staged_bytes = bt.tx_bytes[lq];
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (staged_bytes > 0) {
      mbar_expect_tx(bar, (uint32_t)staged_bytes);
      for (int l = 0; l < L; ++l) {
        const int stage = bt.stage[lq][l];
        if (stage == GATHER) continue;
        int oy, ox;
        band_origin(pt, stage, lq, l, ty0, tx0, oy, ox);
        tma_load_4d(base + (uint32_t)bt.offset[lq][l], &bt.map[lq][l], bar, head * HD, ox, oy, b);
      }
    }
  }
  for (int l = lane; l < L && active; l += LANES) {  // this thread's points into L1 while the bands land
    asm volatile("prefetch.global.L1 [%0];" ::"l"(ap + l * P));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(lp + l * P * 2));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(lp + (l + 1) * P * 2 - 1));
  }
  __syncthreads();

  float acc[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = 0.f;
  bool waited = false;
  for (int l = lane; l < L && active; l += LANES) {
    const int stage = bt.stage[lq][l];
    if (stage == GATHER) {
      gather_level<HD / 8>(acc, vb + (long long)lv.start[l] * row_stride, row_stride, lv.h[l], lv.w[l],
                           reinterpret_cast<const float2*>(lp) + l * P, ap + l * P, P, pt.mode[lq][l],
                           pt.scale[lq][l], pt.radius[lq][l], (float)yq, (float)xq);
      continue;
    }
    if (!waited) {
      mbar_wait(bar, 0);
      waited = true;
    }
    int oy, ox;
    band_origin(pt, stage, lq, l, ty0, tx0, oy, ox);
    const int h = lv.h[l], w = lv.w[l];
    float ylo = -1.f, yhi = (float)h, xlo = -1.f, xhi = (float)w;
    if (stage == BAND) {
      window(COARSE, pt.scale[lq][l], pt.radius[lq][l], (float)yq, ylo, yhi);
      window(COARSE, pt.scale[lq][l], pt.radius[lq][l], (float)xq, xlo, xhi);
    }
    band_level<HD>(acc, base + (uint32_t)bt.offset[lq][l], bt.cols[lq][l], oy, ox, h, w, lp + l * P * 2, ap + l * P, P,
                   stage == WHOLE, ylo, yhi, xlo, xhi);
  }
  // no thread leaves while a band is still landing in this block's shared memory
  if (staged_bytes > 0 && !waited) mbar_wait(bar, 0);

  float o[8];
  if (LANES == 4) {  // reduce-scatter over the 4 lanes (warp lanes QPW and 2 QPW apart)
    const bool hi16 = lane & 2, hi8 = lane & 1;
    float half[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float keep = hi16 ? acc[16 + i] : acc[i], send = hi16 ? acc[i] : acc[16 + i];
      half[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * QPW);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float keep = hi8 ? half[8 + i] : half[i], send = hi8 ? half[i] : half[8 + i];
      o[i] = keep + __shfl_xor_sync(0xffffffffu, send, QPW);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = acc[i];
  }
  if (active) store_row(out + group * HD + lane * 8, o);
}

// cuTensorMapEncodeTiled for the band of pair (lq, lv): value level lv, from
// its first pixel, as (nh hd, W, H, B) bf16 with a batch stride of S pixels,
// in (hd, cols, rows, 1) boxes; out-of-map coordinates read as zeros. hd 32
// (64-byte rows): 64B swizzle.
bool band_map(CUtensorMap* map, EncodeTiled encode, const void* value, long long start, int S, int nh, int hd,
              int h, int w, int B, int rows, int cols) {
  const cuuint64_t row = (cuuint64_t)nh * hd * 2;  // bytes from one pixel to the next
  const cuuint64_t dims[4] = {(cuuint64_t)nh * hd, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * w, row * S};
  const cuuint32_t box[4] = {(cuuint32_t)hd, (cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  void* ptr = const_cast<char*>(reinterpret_cast<const char*>(value) + start * (long long)row);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, hd == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int LANES>
int launch_band(const void* value, const void* loc, const void* attn, void* out, const LevelTable& lv,
                const PairTable& pt, const int* bands, int B, int S, int nh, int L, int P, cudaStream_t stream) {
  constexpr int HD = LANES * 8, QPW = 32 / LANES;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  BandTable bt = {};
  int tiles = 0;
  for (int q = 0; q < L; ++q) {
    bt.tile0[q] = tiles;
    bt.tiles_x[q] = (lv.w[q] + QPW - 1) / QPW;
    tiles += bt.tiles_x[q] * ((lv.h[q] + TILE_ROWS - 1) / TILE_ROWS);
    int offset = 0;
    for (int v = 0; v < L; ++v) {
      const int* e = bands + 3 * (q * L + v);
      const int stage = e[0], rows = e[1], cols = e[2];
      if (stage == GATHER) continue;
      const bool ok = (stage == BAND && pt.mode[q][v] == COARSE) ||
                      (stage == WHOLE && pt.mode[q][v] == EXACT && rows == lv.h[v] && cols == lv.w[v]);
      const int bytes = rows * cols * HD * 2;
      if (!ok || rows < 1 || cols < 1 || rows > 256 || cols > 256 || bytes > MAX_BAND_BYTES)
        return (int)cudaErrorInvalidValue;
      if (!band_map(&bt.map[q][v], encode, value, lv.start[v], S, nh, HD, lv.h[v], lv.w[v], B, rows, cols))
        return (int)cudaErrorInvalidValue;
      bt.stage[q][v] = stage;
      bt.cols[q][v] = cols;
      bt.offset[q][v] = offset;
      bt.tx_bytes[q] += bytes;
      offset += (bytes + 1023) / 1024 * 1024;
    }
    if (offset > bt.bar_offset) bt.bar_offset = offset;
  }
  bt.tile0[L] = tiles;
  const int smem = 1024 + bt.bar_offset + 8;
  cudaError_t err = cudaFuncSetAttribute(msda_band_kernel<LANES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tiles, (unsigned)nh, (unsigned)B);
  msda_band_kernel<LANES><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(value), reinterpret_cast<const float*>(loc),
      reinterpret_cast<const float*>(attn), reinterpret_cast<__nv_bfloat16*>(out), lv, pt, bt, S, nh, L, P);
  return (int)cudaGetLastError();
}

template <int LANES>
void launch_exact(const void* value, const void* loc, const void* attn, void* out, const LevelTable& lv, int S, int Q,
                  int nh, int L, int P, long long n_groups, cudaStream_t stream) {
  const long long threads = n_groups * LANES;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  msda_forward_kernel<LANES><<<grid, THREADS, 0, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(value), reinterpret_cast<const float*>(loc),
      reinterpret_cast<const float*>(attn), reinterpret_cast<__nv_bfloat16*>(out), lv, S, Q, nh, L, P, n_groups);
}

}  // namespace

// C interface (loaded with ctypes). level_hw is a host array of L (H, W)
// pairs. clip selects the clipped mode, which takes encoder queries only
// (Q == S) and reads pairs, a host array of L x L (mode, ratio, radius)
// triples, and bands, one of L x L (stage, rows, cols) triples (both query
// level major; null otherwise). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue without launching when the arguments are
// outside what the kernels take.
extern "C" int mqdet_ms_deform_attn_forward(const void* value, const void* loc, const void* attn,
                                            void* out, const int* level_hw, const int* pairs, const int* bands,
                                            int B, int S, int Q, int nh, int hd, int L, int P, int clip,
                                            void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 0 || Q < 0 || nh < 1 || P < 1 || (hd != 8 && hd != 32))
    return (int)cudaErrorInvalidValue;
  LevelTable lv = {};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S || (clip && Q != S)) return (int)cudaErrorInvalidValue;
  const long long n_groups = (long long)B * Q * nh;
  if (n_groups == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!clip) {
    if (hd == 8)
      launch_exact<1>(value, loc, attn, out, lv, S, Q, nh, L, P, n_groups, st);
    else
      launch_exact<4>(value, loc, attn, out, lv, S, Q, nh, L, P, n_groups, st);
    return (int)cudaGetLastError();
  }
  if (pairs == nullptr || bands == nullptr || B > 65535 || nh > 65535) return (int)cudaErrorInvalidValue;
  PairTable pt = {};
  for (int q = 0; q < L; ++q)
    for (int v = 0; v < L; ++v) {
      const int* e = pairs + 3 * (q * L + v);
      // a COARSE ratio must be a power of two: 1 / k is then exact
      if (e[0] < EXACT || e[0] > FINER || (e[0] == COARSE && (e[1] < 1 || (e[1] & (e[1] - 1)))))
        return (int)cudaErrorInvalidValue;
      pt.mode[q][v] = e[0];
      pt.scale[q][v] = e[0] == COARSE ? 1.f / (float)e[1] : (float)e[1];
      pt.radius[q][v] = (float)e[2];
    }
  return hd == 8 ? launch_band<1>(value, loc, attn, out, lv, pt, bands, B, S, nh, L, P, st)
                 : launch_band<4>(value, loc, attn, out, lv, pt, bands, B, S, nh, L, P, st);
}
