// K4: one block of the slow-fast LM's fast depth decoder over a batch of
// short sequences, bf16 weights and activations, float32 sums. The block is
// Qwen2's (models/transformer.py `Block`): x1 = x + o_proj(attn(rope(qkv(
// rmsnorm(x))))), out = x1 + down(silu(gate(rmsnorm(x1))) * up(rmsnorm(x1))),
// causal attention over the S positions of each sequence (S <= 16; the
// depth decoder's S is 1 + 10 codebooks), GQA, RoPE at positions 0..S-1.
//
// It replaces no Pallas kernel: the JAX package leaves this block to XLA,
// which fuses it. The port ran it as ~57 PyTorch kernels a block step
// (`ChatMusicLM.forward_generate_audio_fixed`, 120 block steps a frame), and
// at the serving batch (B = 16, 176 rows) each of them does almost nothing:
// a block step reads 9.4 MB of weights (2.8 us at 3.35 TB/s) and does 1.65
// GFLOP (1.7 us at the bf16 peak), where its ~54 launches took ~123 us on an
// H100 (probes/fast_block_times.py; K4 takes ~33 us). So what bounds it on
// this card is launches and latency, and the design is four launches a block
// step with no grid-wide sync inside any of them:
//
//   K4a fb_qkv_kernel     input RMSNorm, the q / k / v projections with
//                          their biases, RoPE; a block per head and 64 rows
//   K4b fb_attn_kernel    causal attention of every head of one sequence,
//                          o_proj, the residual; a block per sequence and
//                          48 output columns (each recomputes the sequence's
//                          attention: 12 products a head)
//   K4c fb_mlp_in_kernel  post-attention RMSNorm, gate and up, SiLU * up; a
//                          block per 24 columns and up to 192 rows
//   K4d fb_mlp_out_kernel down and the residual: a cluster of KS (6) blocks
//                          per 32 output columns splits the 2,880 inputs, and
//                          the cluster's blocks sum the KS partials in rank
//                          order through distributed shared memory (the
//                          same bits from run to run)
//
// Each launch copies its weight tile into shared memory (cp.async) before it
// waits on its predecessor (programmatic dependent launch: the weights are
// parameters that no launch writes), then signals its own dependents, so a
// launch's weight bytes move while the one before it finishes. After the
// wait each warp copies its own rows of the activations into shared memory
// in three groups along k, all in flight at once, and its products start
// as the first group lands: a warp waits on L2 about once, not once per
// k-block. Products run on mma.sync.m16n8k16 (bf16 operands, float32 sums),
// the norm's weight beside the weight tile in shared memory. An RMSNorm's
// statistics are summed in float32 from the rows the product reads anyway,
// and its row scale multiplies the sums afterwards: A = bf16(w_norm * x) and
// y = rsqrt(mean(x^2) + eps) * (A W) + b, where the module rounds
// bf16(w_norm * x * rsqrt(..)) before the product. RoPE, the softmax and
// SiLU run in float32; bf16 rounding happens where a launch stores (q, k, v;
// x1; the MLP's hidden; the output) and on the products' operands (P and
// the attention's output, as the module rounds them).
//
// Fragments with a permuted depth: within a 32-wide k-block, thread t = lane
// % 4 reads the 8 contiguous values [8t, 8t + 8) of its row as one 16-byte
// load, and they serve as m16n8k16's k slots {2t, 2t + 1, 2t + 8, 2t + 9}
// of step 0 (values 8t .. 8t + 3) and of step 1 (8t + 4 .. 8t + 7). A and
// B take the same permutation, so each product is exact up to the order of
// its sum. Rows of a weight tile in shared memory are 64 mod 128 bytes apart,
// so the 16-byte reads of a quarter warp (two rows) hit 32 banks once.
//
// Activations are read only after griddepcontrol.wait, by cp.async or
// ld.global.cg (through L2, not L1), and nothing is written before it: a
// launch may start before its predecessor ends. Before the wait a launch
// reads only parameters, which no launch writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"  // cp.async, mma.sync, pack_bf16; hopper.cuh: cluster barrier and peer reads

namespace {

using bf16 = __nv_bfloat16;
using dmel_flash::cp_async16;
using dmel_flash::cp_async_commit;
using dmel_flash::cp_async_wait_all;
using dmel_flash::mma_16816;
using dmel_flash::pack_bf16;

constexpr int KB = 32;         // a k-block: 32 inputs, two m16n8k16 steps
constexpr int MAX_S = 16;      // positions a sequence: one m16 row tile
constexpr int QKV_WARPS = 4;   // m16 row tiles of a K4a block
constexpr int MLP_WARPS = 12;  // m16 row tiles of a K4c / K4d block, at most
constexpr int MAX_KS = 8;      // blocks of a K4d cluster (the portable limit)
constexpr int MAX_NH = 16;     // query heads: K4b's warps
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int BN_D = 32;       // down columns of a K4d block
constexpr int NCH = 3;         // commit groups of a warp's rows along k: products start as the first arrives

struct Dims {
  int R;     // rows, B * S
  int S;     // positions a sequence
  int H;     // hidden
  int NH;    // query heads
  int KVH;   // key / value heads
  int I;     // the MLP's hidden
  int NQKV;  // (NH + 2 KVH) * HD: a row of the q | k | v buffer
  int KS;    // K4d's cluster size
  float eps;
  float scale;  // 1 / sqrt(HD)
};

struct Weights {
  const bf16 *norm_in, *wq, *bq, *wk, *bk, *wv, *bv, *wo, *norm_post, *wg, *wu, *wd;
};

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Loads of what an earlier launch wrote: through L2, never L1.
__device__ __forceinline__ uint2 ld_cg8(const void* p) {
  uint2 v;
  asm volatile("ld.global.cg.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned ld_cg2(const void* p) {
  unsigned short v;
  asm volatile("ld.global.cg.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned lds4(const bf16* p) { return *reinterpret_cast<const unsigned*>(p); }
__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }

// Row stride (bf16) of a k-wide tile whose fragments are read 16 bytes at a
// time: 64 mod 128 bytes.
__host__ __device__ __forceinline__ int frag_ld(int k) { return k + ((64 - (2 * k) % 128 + 128) % 128) / 2; }

// Row stride of K4b's o_proj tile, read 4 bytes at a time (B fragments of
// the attention's output): 4 mod 8 words, so rows g = 0..7 and t = 0..3 hit
// 32 banks.
__host__ __device__ __forceinline__ int word_ld(int k) { return k % 16 == 0 ? k + 8 : k; }

// Rows [0, n) x columns [0, k) of a row-major bf16 matrix with row stride
// ld into shared rows of stride sw, by 16-byte cp.async (k a multiple of 8,
// src 16-byte aligned). The caller commits and waits.
__device__ __forceinline__ void stage_rows(bf16* dst, int sw, const bf16* src, long long ld, int n, int k) {
  const int ch = k / 8;
  for (int i = threadIdx.x; i < n * ch; i += blockDim.x) {
    const int r = i / ch, c = i % ch;
    cp_async16(dst + r * sw + 8 * c, src + r * ld + 8 * c, true);
  }
}

// k-block range [kb0, kb1) of chunk c of NCH.
__device__ __forceinline__ int chunk_kb(int c, int kblocks) { return c * kblocks / NCH; }

// This warp's rows [row0, row0 + 16) of a row-major bf16 matrix (row stride
// lda; rows at or beyond `rows` zero) into shared rows of stride sa, the
// first 32 kblocks columns, by the warp's own cp.async in NCH commit groups
// of consecutive k-blocks (a warp with no rows commits NCH groups of zeros).
__device__ __forceinline__ void stage_warp_rows(bf16* dst, int sa, const bf16* src, long long lda, int row0,
                                                int rows, int kblocks) {
  const int lane = threadIdx.x % 32;
  for (int c = 0; c < NCH; ++c) {
    const int k0 = chunk_kb(c, kblocks) * KB, ch = (chunk_kb(c + 1, kblocks) * KB - k0) / 8;
    for (int i = lane; i < 16 * ch; i += 32) {
      const int r = i / ch, col = k0 + 8 * (i % ch);
      const bool valid = row0 + r < rows;
      cp_async16(dst + r * sa + col, src + (valid ? row0 + r : 0) * lda + col, valid);
    }
    cp_async_commit();
  }
}

// Until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// acc[j] += A[:, 32 kb0 .. 32 kb1) . W[8 j .. 8 j + 8, 32 kb0 .. 32 kb1)^T for
// this warp's 16 rows: A (row stride sa) and W (row stride sw) shared
// tiles. NORM: A is bf16(nw * a) (nw in shared memory too), and ss[0], ss[1] gather this lane's part
// of the sums of a^2 of rows g and g + 8 (`row_sums` completes them).
template <int NT, bool NORM>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], float (&ss)[2], const bf16* at, int sa,
                                         const bf16* nw, const bf16* wt, int sw, int kb0, int kb1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16* pa = at + g * sa + 8 * t;
  const bf16* pb = pa + 8 * sa;
  const bf16* pw = wt + g * sw + 8 * t;
#pragma unroll 5
  for (int kb = kb0; kb < kb1; ++kb) {
    const uint4 xa = *reinterpret_cast<const uint4*>(pa + kb * KB);
    const uint4 xb = *reinterpret_cast<const uint4*>(pb + kb * KB);
    unsigned ra[4] = {xa.x, xa.y, xa.z, xa.w}, rb[4] = {xb.x, xb.y, xb.z, xb.w};
    if constexpr (NORM) {
      const uint4 wn = *reinterpret_cast<const uint4*>(nw + kb * KB + 8 * t);
      const unsigned rw[4] = {wn.x, wn.y, wn.z, wn.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a0 = bf_lo(ra[i]), a1 = bf_hi(ra[i]), b0 = bf_lo(rb[i]), b1 = bf_hi(rb[i]);
        const float w0 = bf_lo(rw[i]), w1 = bf_hi(rw[i]);
        ss[0] = fmaf(a0, a0, fmaf(a1, a1, ss[0]));
        ss[1] = fmaf(b0, b0, fmaf(b1, b1, ss[1]));
        ra[i] = pack_bf16(w0 * a0, w1 * a1);
        rb[i] = pack_bf16(w0 * b0, w1 * b1);
      }
    }
    const unsigned s0[4] = {ra[0], rb[0], ra[1], rb[1]};
    const unsigned s1[4] = {ra[2], rb[2], ra[3], rb[3]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint4 w = *reinterpret_cast<const uint4*>(pw + j * 8 * sw + kb * KB);
      mma_16816(acc[j], s0, w.x, w.y);
      mma_16816(acc[j], s1, w.z, w.w);
    }
  }
}

// ss over the row's four lanes.
__device__ __forceinline__ void row_sums(float (&ss)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 1);
    ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 2);
  }
}

// The warp's product over K = 32 kblocks as its A chunks arrive: first the
// block's weight tile (the oldest group, staged by every thread), then chunk
// by chunk of the warp's own rows. Warps without rows pass the barrier only.
template <int NT, bool NORM>
__device__ __forceinline__ void staged_mma(float (&acc)[NT][4], float (&ss)[2], bool busy, const bf16* at, int sa,
                                           const bf16* nw, const bf16* wt, int sw, int kblocks) {
  cp_async_wait_upto(NCH);
  __syncthreads();
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait_upto(NCH - 1 - c);
    __syncwarp();
    if (busy) tile_mma<NT, NORM>(acc, ss, at, sa, nw, wt, sw, chunk_kb(c, kblocks), chunk_kb(c + 1, kblocks));
  }
}

// ---- K4a: input RMSNorm, q / k / v with biases, RoPE ----------------------
// grid (NH + 2 KVH head tiles: q heads, k heads, v heads; ceil(R / 64)),
// 32 QKV_WARPS threads; warp w owns rows 16 w of its block and the head's
// HD columns, so RoPE pairs n8 tiles j and j + HD / 16 in registers.
template <int HD>
__global__ void __launch_bounds__(32 * QKV_WARPS) fb_qkv_kernel(const bf16* x, Weights w, const float* cosv,
                                                                const float* sinv, bf16* qkv, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = HD / 8, HALF = HD / 2;
  const int sw = frag_ld(d.H);
  bf16* wt = reinterpret_cast<bf16*>(smem);  // [HD][sw]
  const int tile = blockIdx.x;
  const bf16 *wsrc, *bsrc;
  bool rope = true;
  if (tile < d.NH) {
    wsrc = w.wq + static_cast<long long>(tile) * HD * d.H;
    bsrc = w.bq + tile * HD;
  } else if (tile < d.NH + d.KVH) {
    wsrc = w.wk + static_cast<long long>(tile - d.NH) * HD * d.H;
    bsrc = w.bk + (tile - d.NH) * HD;
  } else {
    wsrc = w.wv + static_cast<long long>(tile - d.NH - d.KVH) * HD * d.H;
    bsrc = w.bv + (tile - d.NH - d.KVH) * HD;
    rope = false;
  }
  bf16* nt = wt + (HD + 16 * QKV_WARPS) * sw;  // [H]: the norm's weight
  stage_rows(wt, sw, wsrc, d.H, HD, d.H);
  stage_rows(nt, 0, w.norm_in, 0, 1, d.H);
  cp_async_commit();
  pdl_wait();
  pdl_launch_dependents();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = (blockIdx.y * QKV_WARPS + warp) * 16;
  bf16* at = wt + (HD + warp * 16) * sw;  // [16][sw]: the warp's rows of x
  stage_warp_rows(at, sw, x, d.H, row0, d.R, d.H / KB);
  float acc[NT][4] = {};
  float ss[2] = {0.f, 0.f};
  staged_mma<NT, true>(acc, ss, row0 < d.R, at, sw, nt, wt, sw, d.H / KB);
  if (row0 >= d.R) return;
  row_sums(ss);
  const float r[2] = {rsqrtf(ss[0] / d.H + d.eps), rsqrtf(ss[1] / d.H + d.eps)};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], r[e / 2], bf(bsrc[j * 8 + 2 * t + e % 2]));
  }
  if (rope) {  // HF's half-duplicated layout: c < HALF takes -v[c + HALF] sin, c >= HALF takes v[c - HALF] sin
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = (row0 + g + 8 * half) % d.S;
      const float* cp = cosv + p * HD;
      const float* sp = sinv + p * HD;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + 2 * t + e, i = 2 * half + e;
          const float lo = acc[j][i], hi = acc[j + NT / 2][i];
          acc[j][i] = lo * cp[c] - hi * sp[c];
          acc[j + NT / 2][i] = hi * cp[c + HALF] + lo * sp[c + HALF];
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= d.R) continue;
    bf16* o = qkv + static_cast<long long>(row) * d.NQKV + tile * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<unsigned*>(o + j * 8) = pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// ---- K4b: attention, o_proj, the residual --------------------------------
// grid (H / BN_O, B), 32 NH threads: warp h is query head h of sequence
// blockIdx.y; each block recomputes the sequence's attention and writes
// BN_O columns of x1 = x + o_proj(attn). The sequence's S rows of the
// q | k | v buffer (contiguous) come to shared memory in one cp.async burst,
// beside the residuals' loads: the fragments read them there.
template <int HD, int BN_O>
__global__ void __launch_bounds__(32 * MAX_NH) fb_attn_kernel(const bf16* x, const bf16* qkv, Weights w, bf16* x1, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ND = HD / 8, KS16 = HD / 16, NO = BN_O / 8, RP = 2;
  const int so = word_ld(d.H);
  bf16* wt = reinterpret_cast<bf16*>(smem);                    // [BN_O][so]: o_proj rows n0 ..
  float* red = reinterpret_cast<float*>(smem + 2 * BN_O * so);  // [NH][16][BN_O]
  bf16* qs = reinterpret_cast<bf16*>(red + d.NH * 16 * BN_O);   // [S][NQKV]: the sequence's q | k | v
  const int n0 = blockIdx.x * BN_O;
  stage_rows(wt, so, w.wo + static_cast<long long>(n0) * d.H, d.H, BN_O, d.H);
  cp_async_commit();
  pdl_wait();
  pdl_launch_dependents();

  const int h = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int S = d.S, kh = h / (d.NH / d.KVH), ld = d.NQKV;
  const long long rb = static_cast<long long>(blockIdx.y) * S;
  for (int i = threadIdx.x; i < S * ld / 8; i += blockDim.x) cp_async16(qs + 8 * i, qkv + rb * ld + 8 * i, true);
  cp_async_commit();
  const bf16* q = qs + h * HD;
  const bf16* k = qs + (d.NH + kh) * HD;
  const bf16* v = qs + (d.NH + d.KVH + kh) * HD;

  unsigned xr[RP];
#pragma unroll
  for (int m = 0; m < RP; ++m) {
    const int i = threadIdx.x + m * blockDim.x;
    xr[m] = i < S * BN_O ? ld_cg2(x + (rb + i / BN_O) * d.H + n0 + i % BN_O) : 0u;
  }
  cp_async_wait_all();
  __syncthreads();
  // Q and K fragments, V's values
  unsigned qa[KS16][4], kf[KS16][2][2], vf[ND][4];
#pragma unroll
  for (int s = 0; s < KS16; ++s) {
    const int c0 = 16 * s + 2 * t;
    qa[s][0] = g < S ? lds4(q + g * ld + c0) : 0u;
    qa[s][1] = g + 8 < S ? lds4(q + (g + 8) * ld + c0) : 0u;
    qa[s][2] = g < S ? lds4(q + g * ld + c0 + 8) : 0u;
    qa[s][3] = g + 8 < S ? lds4(q + (g + 8) * ld + c0 + 8) : 0u;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int key = 8 * jn + g;
      kf[s][jn][0] = key < S ? lds4(k + key * ld + c0) : 0u;
      kf[s][jn][1] = key < S ? lds4(k + key * ld + c0 + 8) : 0u;
    }
  }
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 2 * t + (i & 1) + 8 * (i >> 1);  // B rows 2t, 2t + 1, 2t + 8, 2t + 9
      vf[jd][i] = key < S ? *reinterpret_cast<const unsigned short*>(v + key * ld + 8 * jd + g) : 0u;
    }
  }

  // scores of the 16 query rows against 16 keys (rows / keys >= S are zero)
  float sc[2][4] = {};
#pragma unroll
  for (int s = 0; s < KS16; ++s) {
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) mma_16816(sc[jn], qa[s], kf[s][jn][0], kf[s][jn][1]);
  }
  // causal softmax over each row's keys, float32
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e / 2), key = 8 * jn + 2 * t + e % 2;
      const float s = key <= row && key < S ? sc[jn][e] * d.scale : -INFINITY;
      sc[jn][e] = s;
      mx[e / 2] = fmaxf(mx[e / 2], s);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = sc[jn][e] == -INFINITY ? 0.f : expf(sc[jn][e] - mx[e / 2]);
      sc[jn][e] = p;
      sum[e / 2] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
  const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
  const unsigned pa[4] = {pack_bf16(sc[0][0] * inv0, sc[0][1] * inv0), pack_bf16(sc[0][2] * inv1, sc[0][3] * inv1),
                          pack_bf16(sc[1][0] * inv0, sc[1][1] * inv0), pack_bf16(sc[1][2] * inv1, sc[1][3] * inv1)};
  // P V
  float o[ND][4] = {};
#pragma unroll
  for (int jd = 0; jd < ND; ++jd) mma_16816(o[jd], pa, vf[jd][0] | (vf[jd][1] << 16), vf[jd][2] | (vf[jd][3] << 16));
  // the head's output as bf16 A fragments of o_proj (the module rounds it)
  unsigned oa[KS16][4];
#pragma unroll
  for (int s = 0; s < KS16; ++s) {
    oa[s][0] = pack_bf16(o[2 * s][0], o[2 * s][1]);
    oa[s][1] = pack_bf16(o[2 * s][2], o[2 * s][3]);
    oa[s][2] = pack_bf16(o[2 * s + 1][0], o[2 * s + 1][1]);
    oa[s][3] = pack_bf16(o[2 * s + 1][2], o[2 * s + 1][3]);
  }
  // this head's share of o_proj: out[:, n0 + n] += O_h . Wo[n0 + n, h HD : (h + 1) HD]^T
  float part[NO][4] = {};
#pragma unroll
  for (int jn = 0; jn < NO; ++jn) {
#pragma unroll
    for (int s = 0; s < KS16; ++s) {
      const bf16* pw = wt + (jn * 8 + g) * so + h * HD + 16 * s + 2 * t;
      mma_16816(part[jn], oa[s], *reinterpret_cast<const unsigned*>(pw), *reinterpret_cast<const unsigned*>(pw + 8));
    }
  }
  float* mine = red + h * 16 * BN_O;
#pragma unroll
  for (int jn = 0; jn < NO; ++jn) {
    const int col = jn * 8 + 2 * t;
    mine[g * BN_O + col] = part[jn][0];
    mine[g * BN_O + col + 1] = part[jn][1];
    mine[(g + 8) * BN_O + col] = part[jn][2];
    mine[(g + 8) * BN_O + col + 1] = part[jn][3];
  }
  __syncthreads();
  // the heads' shares in head order, then the residual
  for (int m = 0;; ++m) {
    const int i = threadIdx.x + m * blockDim.x;
    if (i >= S * BN_O) break;
    const int row = i / BN_O, col = i % BN_O;
    const long long at = (rb + row) * d.H + n0 + col;
    float acc = 0.f;
    for (int hh = 0; hh < d.NH; ++hh) acc += red[(hh * 16 + row) * BN_O + col];
    unsigned xv = 0;
#pragma unroll
    for (int r = 0; r < RP; ++r) xv = m == r ? xr[r] : xv;
    if (m >= RP) xv = ld_cg2(x + at);
    x1[at] = __float2bfloat16(acc + __uint_as_float(xv << 16));
  }
}

// ---- K4c: post-attention RMSNorm, gate and up, SiLU(gate) * up -----------
// grid (I / BN, ceil(R / (16 W))), 32 W threads (`mlp_warps`): warp w owns rows
// 16 w of its block and all BN columns of gate and up (the weight tile's
// first BN rows are gate's, the next BN up's).
template <int BN>
__global__ void __launch_bounds__(32 * MLP_WARPS) fb_mlp_in_kernel(const bf16* x1, Weights w, bf16* hid, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = 2 * BN / 8;
  const int sw = frag_ld(d.H);
  bf16* wt = reinterpret_cast<bf16*>(smem);  // [2 BN][sw]
  const int n0 = blockIdx.x * BN;
  stage_rows(wt, sw, w.wg + static_cast<long long>(n0) * d.H, d.H, BN, d.H);
  stage_rows(wt + BN * sw, sw, w.wu + static_cast<long long>(n0) * d.H, d.H, BN, d.H);
  bf16* nt = wt + (2 * BN + 16 * (blockDim.x / 32)) * sw;  // [H]: the norm's weight
  stage_rows(nt, 0, w.norm_post, 0, 1, d.H);
  cp_async_commit();
  pdl_wait();
  pdl_launch_dependents();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = (blockIdx.y * (blockDim.x / 32) + warp) * 16;
  bf16* at = wt + (2 * BN + warp * 16) * sw;  // [16][sw]: the warp's rows of x1
  stage_warp_rows(at, sw, x1, d.H, row0, d.R, d.H / KB);
  float acc[NT][4] = {};
  float ss[2] = {0.f, 0.f};
  staged_mma<NT, true>(acc, ss, row0 < d.R, at, sw, nt, wt, sw, d.H / KB);
  if (row0 >= d.R) return;
  row_sums(ss);
  const float r[2] = {rsqrtf(ss[0] / d.H + d.eps), rsqrtf(ss[1] / d.H + d.eps)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= d.R) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gv = acc[j][2 * half + e] * r[half], uv = acc[BN / 8 + j][2 * half + e] * r[half];
        y[e] = gv / (1.f + expf(-gv)) * uv;
      }
      *reinterpret_cast<unsigned*>(hid + static_cast<long long>(row) * d.I + n0 + j * 8 + 2 * t) =
          pack_bf16(y[0], y[1]);
    }
  }
}

// ---- K4d: down and the residual -------------------------------------------
// grid (H / BN_D * KS, ceil(R / (16 W))), cluster (KS, 1, 1), 32 W threads:
// the cluster's block of rank q multiplies inputs [q I / KS, (q + 1) I / KS)
// for BN_D output columns, and sums rows q, q + KS, .. of the KS partials
// in rank order, adds x1 and stores.
__global__ void __launch_bounds__(32 * MLP_WARPS) fb_mlp_out_kernel(const bf16* hid, const bf16* x1, Weights w,
                                                                    bf16* out, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = BN_D / 8, RED_LD = BN_D + 4;  // a partial row: 16-byte aligned
  const int ks = d.KS, q = blockIdx.x % ks, n0 = blockIdx.x / ks * BN_D;
  const int kslice = d.I / ks, k0 = q * kslice, sw = frag_ld(kslice);
  bf16* wt = reinterpret_cast<bf16*>(smem);  // [BN_D][sw]
  stage_rows(wt, sw, w.wd + static_cast<long long>(n0) * d.I + k0, d.I, BN_D, kslice);
  cp_async_commit();
  pdl_wait();
  pdl_launch_dependents();

  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int base = blockIdx.y * nw * 16, row0 = base + warp * 16;
  bf16* at = wt + (BN_D + warp * 16) * sw;  // [16][sw]: the warp's rows of the slice of hid
  stage_warp_rows(at, sw, hid + k0, d.I, row0, d.R, kslice / KB);
  float acc[NT][4] = {};
  float unused[2];
  staged_mma<NT, false>(acc, unused, row0 < d.R, at, sw, nullptr, wt, sw, kslice / KB);
  __syncthreads();  // every warp is done with its rows: the partials take their place
  float* red = reinterpret_cast<float*>(wt + BN_D * sw);  // [16 W][RED_LD]
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* p = red + (warp * 16 + g) * RED_LD + j * 8 + 2 * t;
    p[0] = acc[j][0];
    p[1] = acc[j][1];
    p[8 * RED_LD] = acc[j][2];
    p[8 * RED_LD + 1] = acc[j][3];
  }
  dmel::cluster_sync();
  const int rows = nw * 16, mine = (rows - q + ks - 1) / ks;
  for (int i = threadIdx.x; i < mine * (BN_D / 4); i += blockDim.x) {
    const int lr = q + ks * (i / (BN_D / 4)), c4 = i % (BN_D / 4), row = base + lr;
    if (row >= d.R) continue;
    const long long o = static_cast<long long>(row) * d.H + n0 + 4 * c4;
    const uint2 xr = ld_cg8(x1 + o);
    const uint32_t at_red = static_cast<uint32_t>(__cvta_generic_to_shared(red + lr * RED_LD + 4 * c4));
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < ks; ++p) {
      const uint4 v = dmel::ld_peer(at_red, static_cast<uint32_t>(p));
      s[0] += __uint_as_float(v.x);
      s[1] += __uint_as_float(v.y);
      s[2] += __uint_as_float(v.z);
      s[3] += __uint_as_float(v.w);
    }
    uint2 y;
    y.x = pack_bf16(s[0] + bf_lo(xr.x), s[1] + bf_hi(xr.x));
    y.y = pack_bf16(s[2] + bf_lo(xr.y), s[3] + bf_hi(xr.y));
    *reinterpret_cast<uint2*>(out + o) = y;
  }
  dmel::cluster_sync();  // no block leaves while a peer reads its partials
}

// ---- the launches ---------------------------------------------------------

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads, int smem, int cluster, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // may start before its predecessor ends
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  int n = 1;
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Warps of a K4c / K4d block: the row tiles spread evenly over the fewest
// blocks of at most MLP_WARPS warps whose shared memory (fixed bytes and
// per_warp bytes a warp) fits; 0 if none does.
int mlp_warps(int tiles, int fixed, int per_warp) {
  for (int groups = (tiles + MLP_WARPS - 1) / MLP_WARPS; groups <= tiles; ++groups) {
    const int nw = (tiles + groups - 1) / groups;
    if (fixed + nw * per_warp <= SMEM_LIMIT) return nw;
  }
  return 0;
}

template <int HD>
int launch_block(const bf16* x, bf16* out, bf16* qkv, bf16* x1, bf16* hid, const Weights& w, const float* cosv,
                 const float* sinv, int B, Dims d, cudaStream_t stream) {
  const int tiles = (d.R + 15) / 16;
  int ks = 1;  // K4d's cluster: the most blocks of at most MAX_KS that split I into whole k-blocks
  for (int c = MAX_KS; c > 1 && ks == 1; --c) ks = (d.I / KB) % c == 0 ? c : 1;
  d.KS = ks;
  // columns of a K4b block: 48 where they divide H (fewer blocks recomputing a sequence's attention);
  // of a K4c block: 24 where they divide I (120 blocks at I = 2,880; 48 read fewer rows again but
  // hold twice the weight tile and were slower on the card)
  const int bo = d.H % 48 == 0 ? 48 : 32, bn = d.I % 24 == 0 ? 24 : 32, bd = BN_D;
  const int sh = frag_ld(d.H), sk = frag_ld(d.I / ks);
  const int smem_a = 2 * (HD + 16 * QKV_WARPS) * sh + 2 * d.H;
  const int smem_b = 2 * bo * word_ld(d.H) + 4 * d.NH * 16 * bo + 2 * d.S * d.NQKV;
  const int nw_c = mlp_warps(tiles, 2 * 2 * bn * sh + 2 * d.H, 2 * 16 * sh);
  const int red = 4 * 16 * (bd + 4), a_d = 2 * 16 * sk;
  const int nw_d = mlp_warps(tiles, 2 * bd * sk, a_d > red ? a_d : red);
  if (smem_a > SMEM_LIMIT || smem_b > SMEM_LIMIT || nw_c == 0 || nw_d == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_c = 2 * 2 * bn * sh + nw_c * 2 * 16 * sh + 2 * d.H;
  const int smem_d = 2 * bd * sk + nw_d * (a_d > red ? a_d : red);
  cudaError_t err = cudaSuccess;
  err = launch(fb_qkv_kernel<HD>, dim3(d.NH + 2 * d.KVH, (tiles + QKV_WARPS - 1) / QKV_WARPS), 32 * QKV_WARPS,
                 smem_a, 1, stream, x, w, cosv, sinv, qkv, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16 *xc = x, *qkvc = qkv, *x1c = x1, *hidc = hid;
  err = bo == 48 ? launch(fb_attn_kernel<HD, 48>, dim3(d.H / 48, B), 32 * d.NH, smem_b, 1, stream, xc, qkvc, w, x1, d)
                   : launch(fb_attn_kernel<HD, 32>, dim3(d.H / 32, B), 32 * d.NH, smem_b, 1, stream, xc, qkvc, w, x1, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_c(d.I / bn, (tiles + nw_c - 1) / nw_c);
  err = bn == 24 ? launch(fb_mlp_in_kernel<24>, grid_c, 32 * nw_c, smem_c, 1, stream, x1c, w, hid, d)
                 : launch(fb_mlp_in_kernel<32>, grid_c, 32 * nw_c, smem_c, 1, stream, x1c, w, hid, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_d(d.H / bd * ks, (tiles + nw_d - 1) / nw_d);
  err = launch(fb_mlp_out_kernel, grid_d, 32 * nw_d, smem_d, ks, stream, hidc, x1c, w, out, d);
  return static_cast<int>(err);
}

}  // namespace

// One block step, four launches. x, out: [B, S, H] bf16, contiguous; qkv
// [B S, (NH + 2 KVH) HD], x1 [B S, H], hid [B S, I]: bf16 scratch. The
// weights as the module holds them (bf16, contiguous, 16-byte aligned):
// norm_in, norm_post [H]; wq [NH HD, H], bq [NH HD]; wk, wv [KVH HD, H],
// bk, bv [KVH HD]; wo [H, NH HD]; wg, wu [I, H]; wd [H, I]. cos, sin: [S,
// HD] float32, RoPE at positions 0..S-1. Takes HD in {32, 48, 64, 128}, NH
// HD = H, NH a multiple of KVH up to 16, S <= 16, H and I multiples of 32.
// Returns cudaGetLastError() after the last launch (or the first failure).
extern "C" int dmel_fast_block(const void* x, void* out, void* qkv, void* x1, void* hid, const void* norm_in,
                               const void* wq, const void* bq, const void* wk, const void* bk, const void* wv,
                               const void* bv, const void* wo, const void* norm_post, const void* wg, const void* wu,
                               const void* wd, const float* cosv, const float* sinv, int B, int S, int H, int NH,
                               int KVH, int HD, int I, float eps, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || S > MAX_S || H < KB || H % KB || I < KB || I % KB || KVH < 1 || NH < KVH ||
      NH % KVH || NH > MAX_NH || NH * HD != H || static_cast<long long>(B) * S > (1 << 24)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Weights w = {static_cast<const bf16*>(norm_in), static_cast<const bf16*>(wq), static_cast<const bf16*>(bq),
                     static_cast<const bf16*>(wk),      static_cast<const bf16*>(bk), static_cast<const bf16*>(wv),
                     static_cast<const bf16*>(bv),      static_cast<const bf16*>(wo),
                     static_cast<const bf16*>(norm_post), static_cast<const bf16*>(wg),
                     static_cast<const bf16*>(wu),      static_cast<const bf16*>(wd)};
  Dims d;
  d.R = B * S;
  d.S = S;
  d.H = H;
  d.NH = NH;
  d.KVH = KVH;
  d.I = I;
  d.NQKV = (NH + 2 * KVH) * HD;
  d.KS = 1;
  d.eps = eps;
  d.scale = 1.f / sqrtf(static_cast<float>(HD));
  const bf16* xi = static_cast<const bf16*>(x);
  bf16 *o = static_cast<bf16*>(out), *q = static_cast<bf16*>(qkv), *y = static_cast<bf16*>(x1),
       *h = static_cast<bf16*>(hid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32: return launch_block<32>(xi, o, q, y, h, w, cosv, sinv, B, d, s);
    case 48: return launch_block<48>(xi, o, q, y, h, w, cosv, sinv, B, d, s);
    case 64: return launch_block<64>(xi, o, q, y, h, w, cosv, sinv, B, d, s);
    case 128: return launch_block<128>(xi, o, q, y, h, w, cosv, sinv, B, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
