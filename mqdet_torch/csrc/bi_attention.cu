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
// K4 (mqdet_bi_attention_carry_forward): one call per FPN level, the same
// two kernels. The levels are one attention over their concatenation: the v
// blocks of a level cover its rows against all T as in K3; its l blocks
// split the level's rows into l_splits ranges whose partials go to scratch,
// and the combine merges them with the carried fp32 state (m, den, acc of
// shapes (B, H, T), (B, H, T), (B, H, T, D)) as one more partial, weight
// e^(m_carry - M). It writes the merged state back in place, unnormalised,
// on every level but the last, and out_l = acc / den in bf16 on the last.
// The first level reads no carry. What bounds K4 is K3's bound over the
// concatenated rows; the tile is K3's, so it inherits K3's design.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int D = 256;        // head width (E / heads); the only width compiled
constexpr float NEG = -1e30f;

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

// Rows [t0, t0 + 16) of head h, batch row b, from the S partials and,
// where carry_in, the carried state as one more partial:
//   M = max(m_carry, max_s m_s), w = e^(m - M) for the carry and each partial,
//   den = w_c den_c + sum_s w_s den_s, acc = w_c acc_c + sum_s w_s acc_s.
// With out_l it writes out_l = acc / den (bf16); without, the merged state
// (M, den, acc) back into the carry, unnormalised, in place (each thread
// reads and writes only its own elements). 256 threads: 64 groups of 4
// columns x 4 rows at a time.
constexpr int COMBINE_ROWS = 16;

struct Carry {
  float* acc;  // (B, H, T, D)
  float* den;  // (B, H, T)
  float* m;    // (B, H, T)
  int in;      // read it as a partial (0: the first level, or K3's call)
};

__global__ void __launch_bounds__(256)
bi_attn_combine_kernel(const float* __restrict__ acc, const float* __restrict__ den,
                       const float* __restrict__ m, const Carry carry,
                       __nv_bfloat16* __restrict__ out_l, int B, int T, int E, int heads, int splits) {
  __shared__ float w[MAX_SPLITS][COMBINE_ROWS];
  __shared__ float wc[COMBINE_ROWS];
  __shared__ float inv[COMBINE_ROWS];
  const int t0 = blockIdx.x * COMBINE_ROWS, h = blockIdx.y, b = blockIdx.z;
  const long long plane = (long long)B * heads * T;  // rows of one split
  const long long row0 = ((long long)b * heads + h) * T + t0;
  const int rows = min(COMBINE_ROWS, T - t0);
  if (threadIdx.x < rows) {
    const long long r = row0 + threadIdx.x;
    const float mc = carry.in ? carry.m[r] : NEG;
    float mx = mc;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s * plane + r]);
    float sum = 0.f;
    if (carry.in) {
      const float c = exp2f((mc - mx) * LOG2E);
      wc[threadIdx.x] = c;
      sum = c * carry.den[r];
    }
    for (int s = 0; s < splits; ++s) {
      const float ws = exp2f((m[s * plane + r] - mx) * LOG2E);
      w[s][threadIdx.x] = ws;
      sum += ws * den[s * plane + r];
    }
    if (out_l != nullptr) {
      inv[threadIdx.x] = 1.f / sum;
    } else {
      carry.m[r] = mx;
      carry.den[r] = sum;
    }
  }
  __syncthreads();
  const int c = 4 * (threadIdx.x & 63);
  for (int r = threadIdx.x >> 6; r < rows; r += 4) {
    const long long off = (row0 + r) * D + c;  // this row's columns in the carry
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (carry.in) {
      const float ws = wc[r];
      const float4 x = *reinterpret_cast<const float4*>(carry.acc + off);
      a = make_float4(ws * x.x, ws * x.y, ws * x.z, ws * x.w);
    }
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float ws = w[s][r];
      const float4 x = __ldg(reinterpret_cast<const float4*>(acc + (s * plane + row0 + r) * D + c));
      a.x += ws * x.x;
      a.y += ws * x.y;
      a.z += ws * x.z;
      a.w += ws * x.w;
    }
    if (out_l == nullptr) {
      *reinterpret_cast<float4*>(carry.acc + off) = a;
      continue;
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
  cudaError_t err =
      cudaFuncSetAttribute(bi_attn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FA_SMEM);
  if (err != cudaSuccess) return err;
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

// The wgmma kernel (both roles) over N rows of q / vv, then the combine: K3
// and K3b with no carry, one level of K4 with one. out_l null: the merged
// state stays in the carry.
int flash_forward(const void* q, const void* k, const void* vv, const void* vl, const void* bias,
                  void* out_v, void* out_l, void* part_acc, void* part_den, void* part_m,
                  const Carry& carry, int B, int N, int T, int E, int heads, int splits, void* stream) {
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
  bi_attn_combine_kernel<<<grid, 256, 0, s>>>(args.part_acc, args.part_den, args.part_m, carry,
                                            reinterpret_cast<__nv_bfloat16*>(out_l), B, T, E,
                                            heads, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). Each requires E / heads == 256,
// T % 64 == 0, T <= 256, N >= 1; the Python wrapper checks. Each returns
// cudaGetLastError() after its launches, and takes the l side's scratch
// (part_acc (S, B, H, T, D), part_den and part_m (S, B, H, T), fp32) and
// S = splits, 1 <= S <= 64.

// K3: out_v and out_l.
extern "C" int mqdet_bi_attention_forward(const void* q, const void* k, const void* vv,
                                          const void* vl, const void* bias, void* out_v,
                                          void* out_l, void* part_acc, void* part_den,
                                          void* part_m, int B, int N, int T, int E, int heads,
                                          int splits, void* stream) {
  return flash_forward(q, k, vv, vl, bias, out_v, out_l, part_acc, part_den, part_m, Carry{}, B, N, T,
                       E, heads, splits, stream);
}

// K3b: the dual-score form, the same kernels (the port's l side always
// makes its own score product).
extern "C" int mqdet_bi_attention_dual_forward(const void* q, const void* k, const void* vv,
                                               const void* vl, const void* bias, void* out_v,
                                               void* out_l, void* part_acc, void* part_den,
                                               void* part_m, int B, int N, int T, int E,
                                               int heads, int splits, void* stream) {
  return flash_forward(q, k, vv, vl, bias, out_v, out_l, part_acc, part_den, part_m, Carry{}, B, N, T,
                       E, heads, splits, stream);
}

// K4, one FPN level of N rows: its out_v, and the carried l-side state (acc
// (B, H, T, D), den and m (B, H, T), fp32) merged with this level's S
// partials. `first`: the carry holds nothing yet and is only written. out_l
// non-null (the last level): out_l = acc / den is written and the carry is
// left as it was; null: the merged state is written back into the carry.
extern "C" int mqdet_bi_attention_carry_forward(const void* q, const void* k, const void* vv,
                                                const void* vl, const void* bias, void* out_v,
                                                void* part_acc, void* part_den, void* part_m,
                                                void* carry_acc, void* carry_den, void* carry_m,
                                                void* out_l, int B, int N, int T, int E, int heads,
                                                int splits, int first, void* stream) {
  const Carry carry{reinterpret_cast<float*>(carry_acc), reinterpret_cast<float*>(carry_den),
                    reinterpret_cast<float*>(carry_m), first ? 0 : 1};
  return flash_forward(q, k, vv, vl, bias, out_v, out_l, part_acc, part_den, part_m, carry, B, N, T, E,
                       heads, splits, stream);
}
