// Blockwise int8 wire kernels (compressor lanes 4/5) for Hopper.
//
// Replace the Pallas TPU kernels of accl_tpu/ops/pallas_kernels.py:
//   quantize_kernel           quantize_pallas (_quantize_kernel)
//   dequantize_kernel         dequantize_pallas (_dequantize_kernel)
//   dequant_combine_kernel    fused_dequant_combine_pallas
//                             (_fused_dq_combine_kernel, requant=False)
//   dequant_combine_kernel    fused_dequant_combine_quant_pallas
//     <REQUANT=true>          (_fused_dq_combine_kernel, requant=True)
//   quant_ring_kernel         the int8-wire ring allreduce of one card:
//                             every fused_dequant_combine_quant_pallas
//                             step of the ring (and its quantize,
//                             fused_dequant_combine and dequantize
//                             steps) in closed form
//
// The four step kernels take a stacked (rows, n) operand with row strides
// (one virtual rank per row) and compute per row. A row's n elements are
// cut into 256-element scale blocks (the last one ragged); codes keep the
// row's length, scales are ceil(n/256) per row.
//
// Numerics (the plain versions in accl_tpu_torch/ops/compression.py are
// the contract, bitwise):
//   - subnormals flush: each fp32 input (payload, scale, local operand)
//     and each fp32 result below FLT_MIN in magnitude becomes a zero of
//     its own sign, written out in code (flush()), as XLA on the CPU and
//     a TPU do; the source is built without -ftz so nothing else flushes;
//   - scale = flush(amax * fp32(1/127)), amax NaN-propagating (fmaxf
//     alone would drop a NaN); q = rint(x / scale) with a correctly
//     rounded divide, clamped to +-127; a block whose scale is not > 0
//     encodes as zeros; a NaN quotient (Inf / Inf) encodes as 0 (a C++
//     cast of NaN to an integer is undefined);
//   - decode is one multiply, (float)q * scale;
//   - SUM decode+combine rounds once: fmaf(q, scale, local), the fused
//     multiply-add XLA contracts the JAX reference into under jit;
//   - MAX is the IEEE maximum of the decoded value and the local operand:
//     NaN propagates, +0 is above -0 (jnp.maximum).
//
// Design of quantize_kernel and dequantize_kernel (a walk). The TPU
// kernels held 256 blocks per grid step in VMEM; here a warp takes one
// 256-element block at a time (WarpBlock) and strides over its row's
// blocks by the grid, issuing the next block's loads before the current
// block's shuffle max, divides and stores, so each SM keeps bytes in
// flight through the divide chain. The grid is sized from the block count
// and capped at one wave of resident CTAs, so a warp walks several blocks
// at the path's large shapes. Rows go on grid.y; the wrapper
// folds rows that lie back to back, n a multiple of 256, into one row
// (the blocking restarts at each row's start).
//   - Lanes. A lane of quantize's vector instantiation holds two float4
//     of its block (lane*4 + 128k) and their eight codes as two 32-bit
//     words, so a warp's fp32 access is 512 and its code access 128
//     contiguous bytes; the scalar lanes hold elements lane + 32k (4-byte
//     and 1-byte accesses). Quantize takes the vector lanes where it can:
//     they need n a multiple of 4 (a ragged block is whole float4s), a
//     16-byte fp32 base and row stride and a 4-byte code base and row
//     stride, and its entry point refuses a vector request otherwise.
//     Dequantize has only the scalar lanes: on an H100 its vector lanes
//     (fp32 stores of 512 bytes a warp access) ran slower than these, so
//     it needs no alignment of its operands.
//   - The divide. Quantize divides by a multiply with the block's
//     reciprocal wherever that cannot change the code (encode_rcp), and
//     by a correctly rounded divide elsewhere.
//   - The wire message. The scales are addressed by a byte pointer and a
//     byte row stride, so one kernel writes (reads) either a fp32 scale
//     tensor or the scale bytes of the int8 wire message, a row of n
//     codes then the 4*nb raw scale bytes: a scale moves as one 32-bit
//     word when the scale base and row stride are 4-byte multiples, else
//     byte by byte.
//   - Indices inside a row are 32-bit when n + 256 fits an int, else
//     64-bit; a row's base is computed once, in 64 bits.
//
// Design of dequant_combine_kernel. One warp per scale block: each lane
// holds 8 of the block's 256 elements (lane + 32k), the block's max-abs
// is a 5-step shuffle reduction, and lane 0 writes the scale. A 256-thread
// CTA holds 8 blocks and there are ceil(rows*nb/8) CTAs. The fused ring
// step keeps the decoded, combined block in registers between the combine
// and the re-encode: one read of each input, one write of each output.
//
// Bound of the step kernels: bytes. Per row, quantize reads 4n and writes
// n + 4*nb bytes; dequantize reads n + 4*nb and writes 4n; the fused
// combine reads n + 4*nb + 4n and writes 4n; the fused requantize reads
// n + 4*nb + 4n and writes n + 4*nb. At (8, 131072) each moves 5-9 MB, a
// few microseconds at 3.35 TB/s, so a launch there is dominated by its
// fixed cost; the int8 collectives' mover hops launch quantize and
// dequantize at (1, 6 553 600) and (8, 819 200), 32.9 MB each.
//
// Design of quant_ring_kernel. On one card every rank's rows lie in one
// memory, and the ring's order alone fixes chunk c's result: rank c+1
// encodes its copy of chunk c, ranks c+2 .. c+W-1 each decode, combine
// their copy and re-encode (the interior step), rank c decodes and
// combines its copy to fp32 (the terminal step), and the allgather
// encodes that once and every rank decodes the same codes. A segment of
// the ring (seg_len columns, zero-padded to W chunks of m) is cut into
// 256-element scale blocks from each chunk's start, as the ring blocks
// each chunk; one warp takes one (segment, chunk, block) and runs the
// whole chain in registers: it loads the block from the W rank rows in
// ring order, issuing the next row's load before the current step's
// arithmetic, keeps codes and scale as register values (they never reach
// memory), and stores the decoded result to all W output rows. The steps
// are the step kernels' own device functions, so the chain is bitwise
// the ring's. Columns of the padded segment past seg_len read as 0.0 and
// are never stored (a zero does not move a block's max, and a block whose
// scale is not finite decodes to NaN everywhere either way). One launch
// covers any number of equal segments (the segment index is on the grid);
// a ragged last segment takes a second launch. A lane of the vector
// instantiation holds two float4 of its block (lane*4 + 128k), so every
// row access is 16 bytes; it needs seg_len, m, both row strides and both
// bases to be 4-element multiples (16 bytes), and the entry point refuses
// a vector request otherwise. Bound: bytes, 2*W*seg_len*4 a segment (each
// rank row read once, each output row written once), the exact ring
// kernel's; the W correctly rounded divides an element costs are ~10x
// below it on the card's fp32 rate.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBlock = 256;           // QUANT_BLOCK_ELEMS
constexpr int kPerLane = kBlock / 32;  // elements of a block per lane
constexpr int kWarps = 8;             // scale blocks per CTA
constexpr int kThreads = 32 * kWarps;
constexpr float kQmax = 127.0f;
constexpr float kInvQmax = 0x1.020408p-7f;  // fp32(1) / fp32(127)
constexpr float kFltMin = 0x1.0p-126f;
constexpr unsigned kFull = 0xffffffffu;

enum : int { kSum = 0, kMax = 1 };

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kFltMin ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float max_ieee(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == 0.0f && b == 0.0f) return __fadd_rn(a, b);  // -0 only if both
  return a > b ? a : b;
}

// The block's scale from every lane's values (padding lanes hold 0).
__device__ __forceinline__ float block_scale(const float (&v)[kPerLane]) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) m = nan_max(m, fabsf(v[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  return flush(__fmul_rn(m, kInvQmax));
}

__device__ __forceinline__ int8_t encode(float v, float scale) {
  if (!(scale > 0.0f)) return 0;  // zero or NaN scale
  float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  r = fminf(fmaxf(r, -kQmax), kQmax);
  return static_cast<int8_t>(static_cast<int>(r));
}

// encode() with the divide taken, where that cannot change the code, as a
// multiply by the block's correctly rounded reciprocal rcp = RN(1/scale):
// q0 = RN(v * rcp) is within 2^-23 |v / scale| of v / scale and the
// correctly rounded quotient within 2^-24 |v / scale|, and a block's own
// elements give |v / scale| <= 127.01, so the two lie within 2.3e-5 of
// each other. Where q0 is more than 1e-4 from a half-integer both round
// to the same integer; elsewhere (near a tie, or q0 NaN: an Inf element
// over an Inf scale, whose rcp is 0) the correctly rounded divide
// decides. So the code is encode()'s, bit for bit, and the ~10-operation
// divide runs for about one element in 5000.
__device__ __forceinline__ int8_t encode_rcp(float v, float scale,
                                             float rcp) {
  if (!(scale > 0.0f)) return 0;  // zero or NaN scale
  const float q0 = __fmul_rn(v, rcp);
  float r = rintf(q0);
  if (!(fabsf(q0 - r) < 0.4999f)) r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  r = fminf(fmaxf(r, -kQmax), kQmax);
  return static_cast<int8_t>(static_cast<int>(r));
}

// Where a warp of dequant_combine_kernel's grid works (one block per
// warp): its row, its block, and whether it has one (trailing warps of the
// last CTA do not).
struct Block {
  long long row, base;
  bool live;
};

__device__ __forceinline__ Block my_block(long long rows, long long nb) {
  const long long g = static_cast<long long>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  Block b;
  b.live = g < rows * nb;
  b.row = b.live ? g / nb : 0;
  b.base = b.live ? (g - b.row * nb) * kBlock : 0;
  return b;
}

// Decode the arriving (codes, scales), combine with the local operand;
// REQUANT re-encodes the combined block (the interior ring step), else
// the fp32 result is stored (the terminal hop).
template <int OP, bool REQUANT>
__global__ void __launch_bounds__(kThreads)
    dequant_combine_kernel(const int8_t* __restrict__ q, long long ld_q,
                           const float* __restrict__ s, long long ld_s,
                           const float* __restrict__ local, long long ld_l,
                           float* __restrict__ out, long long ld_out,
                           int8_t* __restrict__ q_out, long long ld_qo,
                           float* __restrict__ s_out, long long ld_so,
                           long long rows, long long n, long long nb) {
  const Block b = my_block(rows, nb);
  if (!b.live) return;
  const int lane = threadIdx.x & 31;
  const float scale = flush(s[b.row * ld_s + b.base / kBlock]);
  float v[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const long long j = b.base + k * 32 + lane;
    v[k] = 0.0f;
    if (j < n) {
      const float code = static_cast<float>(q[b.row * ld_q + j]);
      const float loc = flush(local[b.row * ld_l + j]);
      if constexpr (OP == kSum) {
        v[k] = flush(__fmaf_rn(code, scale, loc));
      } else {
        v[k] = max_ieee(__fmul_rn(code, scale), loc);
      }
    }
  }
  if constexpr (!REQUANT) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const long long j = b.base + k * 32 + lane;
      if (j < n) out[b.row * ld_out + j] = v[k];
    }
  } else {
    const float scale_out = block_scale(v);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const long long j = b.base + k * 32 + lane;
      if (j < n) q_out[b.row * ld_qo + j] = encode(v[k], scale_out);
    }
    if (lane == 0) s_out[b.row * ld_so + b.base / kBlock] = scale_out;
  }
}

// One 256-element block of a row as a warp holds it: where it starts,
// how many of its columns hold real elements, and each lane's elements.
// The scalar lane holds elements lane + 32k of the block, the vector lane
// the float4s at lane*4 + 128k, and their codes as one 32-bit word each.
// The walk kernels and the closed-form ring share it; codes are read only
// by dequantize, on the scalar lanes.
template <bool VEC, typename I = long long>
struct WarpBlock {
  static constexpr int kGroups = VEC ? 2 : kPerLane;  // a lane's accesses a row
  I col;     // the block's first column in a row
  int live;  // columns of the block that hold real elements

  // Block b of a row of n elements.
  __device__ __forceinline__ static WarpBlock at(I b, I n) {
    WarpBlock w;
    w.col = b * kBlock;
    const I left = n - w.col;
    w.live = left < kBlock ? static_cast<int>(left) : kBlock;
    return w;
  }
  __device__ __forceinline__ int offset(int g, int lane) const {
    return VEC ? g * 128 + lane * 4 : g * 32 + lane;
  }
  // Row `row`'s block into v; columns past `live` read as 0.0.
  __device__ __forceinline__ void load(const float* row, int lane,
                                       float (&v)[kPerLane]) const {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = offset(g, lane);
      if constexpr (VEC) {
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (j < live) f = __ldg(reinterpret_cast<const float4*>(row + col + j));
        v[4 * g] = f.x;
        v[4 * g + 1] = f.y;
        v[4 * g + 2] = f.z;
        v[4 * g + 3] = f.w;
      } else {
        v[g] = j < live ? __ldg(row + col + j) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void store(float* row, int lane,
                                        const float (&v)[kPerLane]) const {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = offset(g, lane);
      if (j >= live) continue;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(row + col + j) =
            make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
      } else {
        row[col + j] = v[g];
      }
    }
  }
  // The block's codes of code row `row`; columns past `live` read as 0.
  __device__ __forceinline__ void load_codes(const int8_t* row, int lane,
                                             int8_t (&c)[kPerLane]) const {
    static_assert(!VEC, "codes are read on the scalar lanes only");
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = offset(g, lane);
      c[g] = j < live ? __ldg(row + col + j) : int8_t{0};
    }
  }
  __device__ __forceinline__ void store_codes(
      int8_t* row, int lane, const int8_t (&c)[kPerLane]) const {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = offset(g, lane);
      if (j >= live) continue;
      if constexpr (VEC) {
        unsigned w = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w |= static_cast<unsigned>(static_cast<uint8_t>(c[4 * g + i]))
               << (8 * i);
        *reinterpret_cast<unsigned*>(row + col + j) = w;
      } else {
        row[col + j] = c[g];
      }
    }
  }
};

// A block's fp32 scale at byte address p: one 32-bit access when the
// scales are word-aligned, else four byte accesses (the scale region of a
// wire message row starts at byte n).
__device__ __forceinline__ float load_scale(const uint8_t* p, bool word) {
  if (word) return __ldg(reinterpret_cast<const float*>(p));
  unsigned u = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) u |= static_cast<unsigned>(__ldg(p + i)) << (8 * i);
  return __uint_as_float(u);
}

__device__ __forceinline__ void store_scale(uint8_t* p, bool word,
                                            float scale) {
  if (word) {
    *reinterpret_cast<float*>(p) = scale;
    return;
  }
  const unsigned u = __float_as_uint(scale);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = static_cast<uint8_t>(u >> (8 * i));
}

// Blockwise encode of `rows` rows of n fp32 (x, ld_x elements apart) into
// codes (q, ld_q bytes apart) and scales (s, ld_s bytes apart; block b of
// a row at byte 4b, a 32-bit word when s_word). A warp walks its row's
// blocks b = first, first + step, ..., loading block b + step before it
// encodes block b.
template <bool VEC, typename I>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, long long ld_x,
                    int8_t* __restrict__ q, long long ld_q,
                    uint8_t* __restrict__ s, long long ld_s, bool s_word,
                    long long rows, I n) {
  const int lane = threadIdx.x & 31;
  const I nb = (n + kBlock - 1) / kBlock;
  const I first =
      static_cast<I>(blockIdx.x) * kWarps + static_cast<I>(threadIdx.x / 32);
  const I step = static_cast<I>(gridDim.x) * kWarps;
  if (first >= nb) return;  // whole warps leave together
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* xr = x + r * ld_x;
    int8_t* qr = q + r * ld_q;
    uint8_t* sr = s + r * ld_s;
    WarpBlock<VEC, I> blk = WarpBlock<VEC, I>::at(first, n);
    float next[kPerLane];
    blk.load(xr, lane, next);
    for (I b = first; b < nb; b += step) {
      const WarpBlock<VEC, I> cur = blk;
      float v[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) v[k] = flush(next[k]);
      if (b + step < nb) {
        blk = WarpBlock<VEC, I>::at(b + step, n);
        blk.load(xr, lane, next);
      }
      const float scale = block_scale(v);
      const float rcp = __frcp_rn(scale);
      int8_t c[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) c[k] = encode_rcp(v[k], scale, rcp);
      cur.store_codes(qr, lane, c);
      if (lane == 0) store_scale(sr + 4 * b, s_word, scale);
    }
  }
}

// Blockwise decode, the same walk: codes (q, ld_q bytes apart) and scales
// (s, ld_s bytes apart) into `rows` rows of n fp32 (out, ld_out elements
// apart); block b + step's codes and scale are loaded before block b is
// decoded and stored. A lane holds elements lane + 32k of its block.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q, long long ld_q,
                      const uint8_t* __restrict__ s, long long ld_s,
                      bool s_word, float* __restrict__ out, long long ld_out,
                      long long rows, I n) {
  const int lane = threadIdx.x & 31;
  const I nb = (n + kBlock - 1) / kBlock;
  const I first =
      static_cast<I>(blockIdx.x) * kWarps + static_cast<I>(threadIdx.x / 32);
  const I step = static_cast<I>(gridDim.x) * kWarps;
  if (first >= nb) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const int8_t* qr = q + r * ld_q;
    const uint8_t* sr = s + r * ld_s;
    float* outr = out + r * ld_out;
    WarpBlock<false, I> blk = WarpBlock<false, I>::at(first, n);
    int8_t next[kPerLane];
    blk.load_codes(qr, lane, next);
    float next_scale = load_scale(sr + 4 * first, s_word);
    for (I b = first; b < nb; b += step) {
      const WarpBlock<false, I> cur = blk;
      const float scale = flush(next_scale);
      float v[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) v[k] = static_cast<float>(next[k]);
      if (b + step < nb) {
        blk = WarpBlock<false, I>::at(b + step, n);
        blk.load_codes(qr, lane, next);
        next_scale = load_scale(sr + 4 * (b + step), s_word);
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) v[k] = __fmul_rn(v[k], scale);
      cur.store(outr, lane, v);
    }
  }
}

// The int8-wire ring allreduce of `segs` segments of seg_len columns
// each, over `world` rank rows: x (world rows, ld_x apart) -> out (world
// rows, ld_out apart), every output row the same. A warp per (segment,
// chunk c, 256-element block of the chunk).
template <int OP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    quant_ring_kernel(const float* __restrict__ x, long long ld_x,
                      float* __restrict__ out, long long ld_out, int world,
                      long long segs, long long seg_len, long long m,
                      long long nb) {
  const long long g = static_cast<long long>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  if (g >= segs * world * nb) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long seg = g / (world * nb);
  const int c = static_cast<int>(g / nb % world);
  const long long b = g % nb;
  WarpBlock<VEC> blk;
  const long long in_seg = c * m + b * kBlock;  // the block's first column
  blk.col = seg * seg_len + in_seg;
  long long live = m - b * kBlock;  // the chunk's end
  if (seg_len - in_seg < live) live = seg_len - in_seg;  // the count's end
  if (live <= 0) return;  // a block wholly in the padding: nothing to store
  blk.live = live < kBlock ? static_cast<int>(live) : kBlock;

  float v[kPerLane], next[kPerLane];
  blk.load(x + ((c + 1) % world) * ld_x, lane, v);
  if (world > 1) {
    blk.load(x + ((c + 2) % world) * ld_x, lane, next);
    // rank c+1 encodes its copy of chunk c
    float code[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) v[k] = flush(v[k]);
    float scale = block_scale(v);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) code[k] = encode(v[k], scale);
    // ranks c+2 .. c+W-1 decode, combine and re-encode; rank c (r == W)
    // decodes and combines to fp32
    for (int r = 2; r <= world; ++r) {
      float loc[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) loc[k] = flush(next[k]);
      if (r < world) blk.load(x + ((c + r + 1) % world) * ld_x, lane, next);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if constexpr (OP == kSum) {
          v[k] = flush(__fmaf_rn(code[k], scale, loc[k]));
        } else {
          v[k] = max_ieee(__fmul_rn(code[k], scale), loc[k]);
        }
      }
      if (r < world) {
        scale = block_scale(v);
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) code[k] = encode(v[k], scale);
      }
    }
  }
  // the allgather: one encode of the fp32 chunk, decoded by every rank
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) v[k] = flush(v[k]);
  const float scale = block_scale(v);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    v[k] = __fmul_rn(static_cast<float>(encode(v[k], scale)), scale);
  for (int r = 0; r < world; ++r) blk.store(out + r * ld_out, lane, v);
}

inline unsigned grid_for(long long rows, long long nb) {
  return static_cast<unsigned>((rows * nb + kWarps - 1) / kWarps);
}

inline long long blocks_of(long long n) { return (n + kBlock - 1) / kBlock; }

// One wave of `kernel`'s CTAs on the current device: the walk's grid cap.
template <typename K>
long long resident_ctas(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long ctas = static_cast<long long>(sms) * per_sm;
  return ctas > 0 ? ctas : 1;
}

// The walk's grid: rows over grid.y (at most 65535, then the loop
// strides), a row's blocks over grid.x, a warp a block, at most `cap`
// CTAs in all (beyond it each warp walks several blocks of its row).
inline dim3 walk_grid(long long rows, long long n, long long cap) {
  const long long y = rows < 65535 ? rows : 65535;
  long long x = (blocks_of(n) + kWarps - 1) / kWarps;
  long long per_row = cap / y;
  if (per_row < 1) per_row = 1;
  if (x > per_row) x = per_row;
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(y));
}

// Whether every index inside a row of n elements fits an int: the last
// element's block end and, with it, every block index plus a grid step.
inline bool fits_int(long long n) { return n + kBlock <= INT_MAX; }

// What the walk's vector instantiation needs: n a multiple of 4, a
// 16-byte fp32 base and row stride, a 4-byte code base and row stride
// (the strides only when there is more than one row).
inline bool vector_ok(const void* f, long long ld_f, const void* q,
                      long long ld_q, long long rows, long long n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
         (rows == 1 || (ld_f % 4 == 0 && ld_q % 4 == 0));
}

// Whether the scales move as 32-bit words.
inline bool scale_words(const void* s, long long ld_s, long long rows) {
  return reinterpret_cast<uintptr_t>(s) % 4 == 0 && (rows == 1 || ld_s % 4 == 0);
}

template <bool VEC, typename I>
cudaError_t quantize_as(const float* x, long long ld_x, int8_t* q,
                        long long ld_q, uint8_t* s, long long ld_s,
                        long long rows, long long n, cudaStream_t st) {
  static const long long cap = resident_ctas(quantize_kernel<VEC, I>);
  quantize_kernel<VEC, I><<<walk_grid(rows, n, cap), kThreads, 0, st>>>(
      x, ld_x, q, ld_q, s, ld_s, scale_words(s, ld_s, rows), rows,
      static_cast<I>(n));
  return cudaGetLastError();
}

template <typename I>
cudaError_t dequantize_as(const int8_t* q, long long ld_q, const uint8_t* s,
                          long long ld_s, float* out, long long ld_out,
                          long long rows, long long n, cudaStream_t st) {
  static const long long cap = resident_ctas(dequantize_kernel<I>);
  dequantize_kernel<I><<<walk_grid(rows, n, cap), kThreads, 0, st>>>(
      q, ld_q, s, ld_s, scale_words(s, ld_s, rows), out, ld_out, rows,
      static_cast<I>(n));
  return cudaGetLastError();
}

template <int OP, bool REQUANT>
cudaError_t launch_combine(const int8_t* q, long long ld_q, const float* s,
                           long long ld_s, const float* local, long long ld_l,
                           float* out, long long ld_out, int8_t* q_out,
                           long long ld_qo, float* s_out, long long ld_so,
                           long long rows, long long n, cudaStream_t stream) {
  const long long nb = blocks_of(n);
  dequant_combine_kernel<OP, REQUANT><<<grid_for(rows, nb), kThreads, 0,
                                        stream>>>(
      q, ld_q, s, ld_s, local, ld_l, out, ld_out, q_out, ld_qo, s_out, ld_so,
      rows, n, nb);
  return cudaGetLastError();
}

template <bool REQUANT>
cudaError_t dispatch_combine(int op, const int8_t* q, long long ld_q,
                             const float* s, long long ld_s,
                             const float* local, long long ld_l, float* out,
                             long long ld_out, int8_t* q_out, long long ld_qo,
                             float* s_out, long long ld_so, long long rows,
                             long long n, cudaStream_t stream) {
  if (op == kSum)
    return launch_combine<kSum, REQUANT>(q, ld_q, s, ld_s, local, ld_l, out,
                                         ld_out, q_out, ld_qo, s_out, ld_so,
                                         rows, n, stream);
  if (op == kMax)
    return launch_combine<kMax, REQUANT>(q, ld_q, s, ld_s, local, ld_l, out,
                                         ld_out, q_out, ld_qo, s_out, ld_so,
                                         rows, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The walk's entry points. ld_x / ld_out count fp32 elements, ld_q and
// ld_s bytes: s addresses either a fp32 scale tensor (ld_s = 4 * its row
// stride) or the scale bytes of a wire message (s = message + n, ld_s =
// ld_q). For quantize, vec != 0 takes the vector instantiation (the
// wrapper chooses it when the operands allow it; a misaligned request is
// refused), 0 the scalar one.
extern "C" int accl_quantize(const void* x, long long ld_x, void* q,
                             long long ld_q, void* s, long long ld_s,
                             long long rows, long long n, int vec,
                             void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  if (vec && !vector_ok(x, ld_x, q, ld_q, rows, n))
    return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  uint8_t* sp = static_cast<uint8_t*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fits_int(n))
    return vec ? quantize_as<true, int>(xp, ld_x, qp, ld_q, sp, ld_s, rows, n, st)
               : quantize_as<false, int>(xp, ld_x, qp, ld_q, sp, ld_s, rows, n, st);
  return vec ? quantize_as<true, long long>(xp, ld_x, qp, ld_q, sp, ld_s, rows, n, st)
             : quantize_as<false, long long>(xp, ld_x, qp, ld_q, sp, ld_s, rows, n, st);
}

extern "C" int accl_dequantize(const void* q, long long ld_q, const void* s,
                               long long ld_s, void* out, long long ld_out,
                               long long rows, long long n, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const uint8_t* sp = static_cast<const uint8_t*>(s);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fits_int(n))
    return dequantize_as<int>(qp, ld_q, sp, ld_s, op, ld_out, rows, n, st);
  return dequantize_as<long long>(qp, ld_q, sp, ld_s, op, ld_out, rows, n, st);
}

extern "C" int accl_dequant_combine(int op, const void* q, long long ld_q,
                                    const void* s, long long ld_s,
                                    const void* local, long long ld_l,
                                    void* out, long long ld_out,
                                    long long rows, long long n,
                                    void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  return dispatch_combine<false>(
      op, static_cast<const int8_t*>(q), ld_q, static_cast<const float*>(s),
      ld_s, static_cast<const float*>(local), ld_l, static_cast<float*>(out),
      ld_out, nullptr, 0, nullptr, 0, rows, n,
      static_cast<cudaStream_t>(stream));
}

extern "C" int accl_dequant_combine_requant(
    int op, const void* q, long long ld_q, const void* s, long long ld_s,
    const void* local, long long ld_l, void* q_out, long long ld_qo,
    void* s_out, long long ld_so, long long rows, long long n, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  return dispatch_combine<true>(
      op, static_cast<const int8_t*>(q), ld_q, static_cast<const float*>(s),
      ld_s, static_cast<const float*>(local), ld_l, nullptr, 0,
      static_cast<int8_t*>(q_out), ld_qo, static_cast<float*>(s_out), ld_so,
      rows, n, static_cast<cudaStream_t>(stream));
}

extern "C" int accl_quant_ring(int op, const void* x, long long ld_x,
                               void* out, long long ld_out, int world,
                               long long segs, long long seg_len, int vec,
                               void* stream) {
  if (world < 1 || segs < 1 || seg_len < 1) return cudaErrorInvalidValue;
  const long long m = (seg_len + world - 1) / world;
  const long long nb = blocks_of(m);
  if (vec && !(reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
               (world == 1 || (ld_x % 4 == 0 && ld_out % 4 == 0)) &&
               seg_len % 4 == 0 && m % 4 == 0))
    return cudaErrorInvalidValue;
  const long long warps = segs * world * nb;
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op_ = static_cast<float*>(out);
#define ACCL_RING(OP, V)                                                   \
  quant_ring_kernel<OP, V><<<grid, kThreads, 0, s>>>(xp, ld_x, op_, ld_out, \
                                                     world, segs, seg_len, \
                                                     m, nb)
  if (op == kSum && vec)
    ACCL_RING(kSum, true);
  else if (op == kSum)
    ACCL_RING(kSum, false);
  else if (op == kMax && vec)
    ACCL_RING(kMax, true);
  else if (op == kMax)
    ACCL_RING(kMax, false);
  else
    return cudaErrorInvalidValue;
#undef ACCL_RING
  return cudaGetLastError();
}

extern "C" const char* accl_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
