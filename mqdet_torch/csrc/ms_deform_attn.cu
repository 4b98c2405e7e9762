// Multi-scale deformable attention (MSDA) sampling, forward, as a direct
// deformable im2col gather on Hopper, in two modes of one kernel.
//
//   out[b, q, h, :] = sum_{l, p} attn[b, q, h, l, p] *
//                     bilinear(value level l of head h, (x, y))
//   (x, y) = loc[b, q, h, l, p] * (W_l, H_l) - 0.5
//
// with zero padding corner by corner (grid_sample, align_corners=False).
//
// Exact mode (CLIP false): the gather composite
// mqdet_tpu/ops/ms_deform_attn.py::ms_deform_attn_sample at any level shapes
// and for any queries: the decoder (900 queries), MQDET_MSDA_IMPL=gather.
//
// Clipped mode (CLIP true): the function of the TPU's encoder kernel K5,
// mqdet_tpu/ops/pallas/msda_pallas.py::ms_deform_attn_encoder (`_kernel`,
// launched through pallas_call), which it replaces on the encoder path
// (queries are the pyramid's pixels, Q = S). The TPU kernel resamples each
// coarser level onto the query grid and decomposes finer levels into phase
// planes, which bounds every sample to a window around its query; here the
// thread finds its query's level lq and pixel (yq, xq) and clamps x and y
// before the bilinear sample, by the (lq, lv) pair's entry of PairTable,
// which the host fills from mqdet_torch/ops/ms_deform_attn.py::clip_pairs:
//   COARSE (lv >= lq at an exact ratio k): y in [b0 - R, b0 + R + 1],
//     b0 = floor((yq + 0.5) / k - 0.5);
//   FINER (lv < lq at an exact ratio f): y in [c - R, c + R + 1],
//     c = f (yq + 0.5) - 0.5;
//   EXACT: no clamp (non-exact ratios, f = 8, the TPU launcher's gather part);
// x likewise with xq.
//
// Threads: hd / 8 lanes per (b, q, head); each lane owns 8 channels and reads
// each bilinear corner as one 16-byte load, so a (q, head) group reads one
// contiguous hd * 2 byte row of value[b, s, h, :] per corner (64 bytes at
// hd = 32). It takes the head widths of the configs that run it, 32
// (MQ-GroundingDINO-T) and 8 (the tiny test config), and up to 4 levels. The
// lanes of a group compute the same sample coordinates from the same fp32
// location and weight (a broadcast load). Accumulation is fp32 in registers;
// the output row is written once in bf16.
//
// What bounds it on the H100: the gathers. Per (q, head) it reads L * P * 4
// corner rows of hd * 2 bytes (16 * 4 * 64 B = 4 KB at GroundingDINO's
// shapes) and does 2 flops per byte read, so it is bound by gather latency and
// L2 bandwidth; encoder queries sample near their own pixel, so most corner
// rows hit in L2. The clip bounds the window a block of encoder queries can
// reach, so a later redesign can stage that band of each level in shared
// memory (the locality the TPU kernel exploits).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int THREADS = 256;

struct LevelTable {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];  // first row of the level in the flattened S axis
};

enum PairMode { EXACT = 0, COARSE = 1, FINER = 2 };

// The clipped mode's rule per (query level, value level) pair.
struct PairTable {
  int mode[MAX_LEVELS][MAX_LEVELS];
  float ratio[MAX_LEVELS][MAX_LEVELS];   // k (COARSE) or f (FINER)
  float radius[MAX_LEVELS][MAX_LEVELS];  // R (COARSE) or FINER_RV (FINER)
};

// The clamp range of one axis of a sample at value level lv for query coordinate qc.
__device__ __forceinline__ void window(int mode, float ratio, float radius, float qc, float& lo, float& hi) {
  const float c = mode == COARSE ? floorf((qc + 0.5f) / ratio - 0.5f) : ratio * (qc + 0.5f) - 0.5f;
  lo = c - radius;
  hi = c + radius + 1.f;
}

template <int LANES, bool CLIP>
__global__ void __launch_bounds__(THREADS)
msda_forward_kernel(const __nv_bfloat16* __restrict__ value,  // (B, S, nh, hd)
                    const float* __restrict__ loc,            // (B, Q, nh, L, P, 2) (x, y)
                    const float* __restrict__ attn,           // (B, Q, nh, L, P)
                    __nv_bfloat16* __restrict__ out,          // (B, Q, nh * hd)
                    const __grid_constant__ LevelTable lv, const __grid_constant__ PairTable pt, int S,
                    int Q, int nh, int L, int P,
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
  int lq = 0;
  float yq = 0.f, xq = 0.f;
  if (CLIP) {  // the query's level and pixel
    const int q = (int)((group / nh) % Q);
    while (lq + 1 < L && q >= lv.start[lq + 1]) ++lq;
    const int r = q - lv.start[lq];
    yq = (float)(r / lv.w[lq]);
    xq = (float)(r % lv.w[lq]);
  }

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    const __nv_bfloat16* vl = vb + (long long)lv.start[l] * row_stride;
    const int mode = CLIP ? pt.mode[lq][l] : EXACT;
    float ylo = 0.f, yhi = 0.f, xlo = 0.f, xhi = 0.f;
    if (mode != EXACT) {
      window(mode, pt.ratio[lq][l], pt.radius[lq][l], yq, ylo, yhi);
      window(mode, pt.ratio[lq][l], pt.radius[lq][l], xq, xlo, xhi);
    }
    for (int p = 0; p < P; ++p) {
      const float2 xy = lp[l * P + p];
      const float a = ap[l * P + p];
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
      const float cw[4] = {(1.f - ly) * (1.f - lx) * a, (1.f - ly) * lx * a, ly * (1.f - lx) * a,
                           ly * lx * a};
      const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
      const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (cy[k] >= 0 && cy[k] < h && cx[k] >= 0 && cx[k] < w) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(vl + ((long long)cy[k] * w + cx[k]) * row_stride);
          const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(v2[j]);
            acc[2 * j] += cw[k] * f.x;
            acc[2 * j + 1] += cw[k] * f.y;
          }
        }
      }
    }
  }

  __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) packed[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
  *reinterpret_cast<uint4*>(out + group * HD + lane * 8) = *reinterpret_cast<const uint4*>(packed);
}

template <int LANES, bool CLIP>
void launch(const void* value, const void* loc, const void* attn, void* out, const LevelTable& lv,
            const PairTable& pt, int S, int Q, int nh, int L, int P, long long n_groups, cudaStream_t stream) {
  const long long threads = n_groups * LANES;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  msda_forward_kernel<LANES, CLIP><<<grid, THREADS, 0, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(value), reinterpret_cast<const float*>(loc),
      reinterpret_cast<const float*>(attn), reinterpret_cast<__nv_bfloat16*>(out), lv, pt, S, Q, nh, L,
      P, n_groups);
}

}  // namespace

// C interface (loaded with ctypes). level_hw is a host array of L (H, W)
// pairs; clip selects the clipped mode, which takes encoder queries only
// (Q == S) and reads pairs, a host array of L x L (mode, ratio, radius)
// triples (query level major), null otherwise. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue without launching when the
// arguments are outside what the kernel takes.
extern "C" int mqdet_ms_deform_attn_forward(const void* value, const void* loc, const void* attn,
                                            void* out, const int* level_hw, const int* pairs, int B,
                                            int S, int Q, int nh, int hd, int L, int P, int clip,
                                            void* stream) {
  if (L < 1 || L > MAX_LEVELS || B < 0 || Q < 0 || nh < 1 || P < 1)
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
  PairTable pt = {};
  if (clip) {
    if (pairs == nullptr) return (int)cudaErrorInvalidValue;
    for (int q = 0; q < L; ++q)
      for (int v = 0; v < L; ++v) {
        const int* e = pairs + 3 * (q * L + v);
        if (e[0] < EXACT || e[0] > FINER) return (int)cudaErrorInvalidValue;
        pt.mode[q][v] = e[0];
        pt.ratio[q][v] = (float)e[1];
        pt.radius[q][v] = (float)e[2];
      }
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (hd * 2 + (clip ? 1 : 0)) {
    case 16: launch<1, false>(value, loc, attn, out, lv, pt, S, Q, nh, L, P, n_groups, st); break;
    case 17: launch<1, true>(value, loc, attn, out, lv, pt, S, Q, nh, L, P, n_groups, st); break;
    case 64: launch<4, false>(value, loc, attn, out, lv, pt, S, Q, nh, L, P, n_groups, st); break;
    case 65: launch<4, true>(value, loc, attn, out, lv, pt, S, Q, nh, L, P, n_groups, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
