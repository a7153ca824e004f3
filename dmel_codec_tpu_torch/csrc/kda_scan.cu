// K6: Kimi Delta Attention's chunked core (models/kimi_linear.py
// `KimiDeltaAttention`, the prefill), from the projections' outputs to o,
// float32 from the convolutions on. For row b, head h (d = 128 keys and
// values) and position t, the bf16 projections' outputs x_q, x_k, x_v, the
// forget gate's pre-activation f and b_proj's output p:
//
//   q~, k~, v~ = SiLU(4-tap causal depthwise conv of x_q, x_k, x_v), the
//       inputs before position 0 the carried ones (`conv`) or zeros;
//   q = q~ rsqrt(|q~|^2 + 1e-6) d^-1/2, k = k~ rsqrt(|k~|^2 + 1e-6), v = v~;
//   a = -exp(A_log[h]) softplus(f + dt_bias) (a gate a channel), beta = sigmoid(p);
//   S_t = diag(e^a_t) S_{t-1} + beta_t k_t (v_t - S^T k_t)^T, o_t = S_t^T q_t
//
// from the state before the call (`state`, or zeros). Writes o float32 [B,
// S, H, 128] (what the gated norm reads), and, given a cache, the last
// state and the convolutions' last 3 inputs. The plain PyTorch version is
// ops/kda_scan.py `kda_scan_reference` (the model's plain chunked path:
// models/kimi_linear.py `_chunked` with `scan_chunks`).
//
// It replaces no Pallas kernel: the JAX package has no KDA. The port ran
// the chunked WY form in plain PyTorch, ~20 float32 passes of ~0.8 GB over
// chunk-major copies a head group, ~200 ms a layer at the long-dialog
// prefill (16 x 12,343 positions, 32 heads).
// Bound on the H100: the products. Per chunk of C = 64 positions and head,
// the pair matrices (2 C^2 d / 2), the triangular solve against [C, 2d]
// (C^2 d), u = U - W S (C d^2), o = (e^G Q) S + Aq u (C d^2 + C^2 d / 2) and
// the next state (C d^2) are ~5 M multiply-adds, ~1 TFLOP a layer of the
// long-dialog prefill; the bytes (bf16 inputs once, float32 o once) take
// ~1.5 ms a layer at 3.35 TB/s. The benchmark's bound (`scan_work`) is 2.9
// ms a layer; K6 takes 28.2 on an H100 at 700 W.
//
// Design: one block (8 warps) a (row, head), walking its chunks in order
// with the float32 state [128 x 128] in shared memory; one launch a call,
// no intermediate in device memory. Per chunk of 64 positions, each stage
// between two block barriers:
//   * load: each thread 8 channels x 4 positions of x_q, x_k, f, every
//     load in flight before the first use, the 3-position halo read again
//     (the carried inputs at position 0); the convolution, SiLU, softplus
//     and sigmoid in float32, branch-free (a branch around each element
//     kept the elements' dependent chains from overlapping: 2.4x slower);
//     rows past S zero (gates 0, beta 0: they leave the state as it was);
//   * the l2 norms (a warp four rows at a time), the gates' running sums G
//     within the chunk (a thread a channel), e^a kept for the pairs;
//   * pairs A[r, i] = sum_c k_r k_i e^(G_r - G_i) (i < r) and Aq (q_r, i <=
//     r), every exponential of a non-positive sum of gates (`_pairs`'
//     rule). Inside each block of 8 positions (a warp a block), on the CUDA
//     cores: for column i the factor k_i e^(G_r - G_i) is carried down the
//     rows r as the product of the single steps e^a_r (lanes: the column
//     pairs (i, 7 - i), so every lane runs 7 rows, x 8 channel groups,
//     summed by shuffles). Across blocks of 8, on the tensor cores, against
//     R = G at the last row of the columns' block: (k_r e^(G_r - R)) .
//     (k_i e^(R - G_i)), both factors <= 1; a warp a tile: the six 16 x 16
//     tiles between blocks of 16, and two tiles each holding the rows 8-15
//     x columns 0-7 of two blocks of 16 (their cross terms dropped);
//   * T = (I + diag(beta) A)^-1 by blocks of doubling size (`tril_inverse`):
//     levels 1-8 a warp a block of 16 and level 16 two warps a block of 32
//     (named barriers), while the other four warps form e^G q, beta e^G k,
//     e^(G_end - G) k and every warp beta v; then level 32. W = T (beta e^G
//     k) and U = T (beta v) on the tensor cores;
//   * u = U - W S and P = (e^G q) S in one pass over S; then o = P + Aq u
//     straight to device memory, and S = e^G_end S + (e^(G_end - G) k)^T u
//     in place.
// Every product is split-TF32 on mma.sync.m16n8k8: each float32 operand
// x = hi + lo, three products (lo hi, hi lo, hi hi), float32 sums, each
// operand split as its fragment is read (`split`). The state products
// (u, P, o, S: three quarters of the mma.syncs) run near mma.sync's TF32 rate; the
// rest of a chunk is latency with 8 warps, whose shared memory (228.6 KB)
// leaves room for no second block: the state, q, k, G (then e^(G_end - G)
// k), v (e^a during the pairs; then U, u), the pair matrix (T below the
// diagonal, Aq^T on and above it), the inverse's scratch. Rows of tiles read
// as A fragments are 132 floats (banks 4g + t), of those read as B
// fragments 136 (8t + g).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using dmel_flash::mma_1688_tf32;

constexpr int D = 128;  // key and value head size
constexpr int C = 64;   // chunk
constexpr int TAPS = 4;
constexpr int HALO = TAPS - 1;
constexpr int NT = 256;
constexpr int LQ = D + 4;  // q, k, G, e^a: rows read as A fragments
constexpr int LV = D + 8;  // the state and v / U / u: rows read as B fragments
constexpr int LP = C + 4;  // the pair matrix
constexpr float L2NORM_EPS = 1e-6f;

constexpr int OFF_S = 0;
constexpr int OFF_Q = OFF_S + D * LV;
constexpr int OFF_K = OFF_Q + C * LQ;
constexpr int OFF_G = OFF_K + C * LQ;
constexpr int OFF_V = OFF_G + C * LQ;
constexpr int OFF_P = OFF_V + C * LV;
constexpr int OFF_X = OFF_P + C * LP;  // the inverse's products: 1024 floats at level 32
constexpr int OFF_BETA = OFF_X + 1024;
constexpr int OFF_GEND = OFF_BETA + C;
constexpr int OFF_DEC = OFF_GEND + D;
constexpr int SMEM_FLOATS = OFF_DEC + D;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "K6's shared memory exceeds a block's 227 KB");

struct Args {
  const __nv_bfloat16* x[4];  // the q, k, v projections and the gate's pre-activation: [B, S, H * D] rows
  long long sb[4], ss[4];     // their batch and position strides (elements)
  const __nv_bfloat16* beta;  // b_proj's output [B, S, H], heads contiguous
  long long beta_sb, beta_ss;
  const __nv_bfloat16* w[3];  // the q, k, v convolutions' weights [H * D][TAPS]
  const float* a_log;         // [H]
  const float* dt_bias;       // [H * D]
  const __nv_bfloat16* conv_in;  // [B, HALO, 3 H D] or null (zeros)
  __nv_bfloat16* conv_out;       // or null
  const float* state_in;         // [B, H, D, D] or null (zeros)
  float* state_out;              // or null
  float* o;                      // [B, S, H, D]
  int S, H;
  float scale;
};

__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __low2float(p[i]);
    f[2 * i + 1] = __high2float(p[i]);
  }
}

// x sigmoid(x) and sigmoid(x) to a few ulp; __fdividef has no slow path, and
// at x < -88 its divisor is inf and the result the limit, 0
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + expf(-x)); }
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + expf(-x)); }

// softplus(x) = max(x, 0) + log1p(e^-|x|) without branches, to a few ulp:
// log1p(u) = 2 atanh(s), s = u / (2 + u) in [0, 1/3], by its series to s^17
// (the next term is under 2^-26 of the sum). At x > 20 it rounds to x, as
// PyTorch's threshold gives.
__device__ __forceinline__ float softplus(float x) {
  const float u = expf(-fabsf(x)), s = __fdividef(u, 2.f + u), s2 = s * s;
  float p = 1.f / 17.f;
#pragma unroll
  for (int k = 15; k >= 1; k -= 2) p = fmaf(p, s2, 1.f / k);
  return fmaxf(x, 0.f) + 2.f * s * p;
}

// x = hi + lo: hi its top 19 bits (a TF32 value), lo = x - hi exactly, of
// which the tensor core reads the top 19 bits, so x - hi - tf32(lo) is under
// 2^-20 |x|. Two instructions: sm_90 has no cvt.rna.tf32 of its own, and
// dmel::split_tf32's emulated rounding (~11 instructions a value) left the
// state products waiting on their own instruction count.
__device__ __forceinline__ void split(float x, unsigned& h, unsigned& l) {
  h = __float_as_uint(x) & 0xFFFFE000u;
  l = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void split_a(const float (&x)[4], unsigned (&h)[4], unsigned (&l)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], h[i], l[i]);
}

__device__ __forceinline__ void split_b(float x0, float x1, unsigned (&h)[2], unsigned (&l)[2]) {
  split(x0, h[0], l[0]);
  split(x1, h[1], l[1]);
}

// acc[n] += A B[n] as three TF32 products, each pass over every column
// tile before the next (independent accumulators back to back)
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N][4], const unsigned (&ah)[4], const unsigned (&al)[4],
                                     const unsigned (&bh)[N][2], const unsigned (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(acc[n], ah, bh[n][0], bh[n][1]);
}

// acc += A B for one column tile, as mma3
__device__ __forceinline__ void mma3(float (&acc)[4], const unsigned (&ah)[4], const unsigned (&al)[4],
                                     const unsigned (&bh)[2], const unsigned (&bl)[2]) {
  mma_1688_tf32(acc, al, bh[0], bh[1]);
  mma_1688_tf32(acc, ah, bl[0], bl[1]);
  mma_1688_tf32(acc, ah, bh[0], bh[1]);
}

// The thread's 8 channels (8 cg ..) of tensor j at positions t0 + 4 pg -
// HALO .. t0 + 4 pg + 3 (the convolutions' window; the gate's tensor, j =
// 3, needs only the last 4): raw bf16, every load in flight before any is
// used. Positions before 0 come from the carried inputs (or zeros), those
// at or past S are zeros.
template <int N>
__device__ __forceinline__ void load_rows(const Args& a, int j, uint4 (&raw)[N], int b, int h, int t0, int cg, int pg) {
  const int S = a.S, width = a.H * D, ch = h * D + 8 * cg;
  const __nv_bfloat16* const x = a.x[j] + b * a.sb[j] + ch;
  const long long ss = a.ss[j];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int pos = t0 + 4 * pg - N + 4 + i;
    raw[i] = make_uint4(0u, 0u, 0u, 0u);
    if (pos >= 0 && pos < S) raw[i] = __ldg(reinterpret_cast<const uint4*>(x + pos * ss));
  }
  if (t0 == 0 && a.conv_in != nullptr) {  // the first chunk's halo: the carried inputs
    const __nv_bfloat16* const carried = a.conv_in + static_cast<long long>(b) * HALO * 3 * width + j * width + ch;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int pos = 4 * pg - N + 4 + i;
      if (pos < 0) raw[i] = __ldg(reinterpret_cast<const uint4*>(carried + (pos + HALO) * 3 * width));
    }
  }
}

// Tensor j (0 q, 1 k, 2 v) through the causal convolution and SiLU from
// its window `raw` (load_rows): positions t0 + 4 pg .. + 3 of the thread's
// 8 channels into dst[r * ld + c] times mul[r] (null: 1); rows at or past
// S zero.
__device__ __forceinline__ void conv_rows(const Args& a, int j, const uint4 (&raw)[4 + HALO], float* dst, int ld,
                                          const float* mul, int h, int t0, int cg, int pg) {
  const int ch = h * D + 8 * cg;
  float w[8][TAPS];
  {
    const uint4* wp = reinterpret_cast<const uint4*>(a.w[j] + static_cast<long long>(ch) * TAPS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // channels 2i, 2i + 1: 8 taps
      float f[8];
      unpack8(__ldg(wp + i), f);
#pragma unroll
      for (int m = 0; m < TAPS; ++m) {
        w[2 * i][m] = f[m];
        w[2 * i + 1][m] = f[TAPS + m];
      }
    }
  }
  float x[4 + HALO][8];
#pragma unroll
  for (int i = 0; i < 4 + HALO; ++i) unpack8(raw[i], x[i]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * pg + r;
    // a factor, not a branch: a branch around each element's chain would keep the chains apart
    const float m = t0 + row < a.S ? (mul == nullptr ? 1.f : mul[row]) : 0.f;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) s = fmaf(w[e][k], x[r + k][e], s);
      y[e] = silu(s) * m;
    }
    float4* out = reinterpret_cast<float4*>(dst + row * ld + 8 * cg);
    out[0] = make_float4(y[0], y[1], y[2], y[3]);
    out[1] = make_float4(y[4], y[5], y[6], y[7]);
  }
}

// Levels BS = 1, 2, 4, 8 of the inverse below (the blocks inside one block
// of 16 positions at `base`) by one warp, the products in Xw (64 floats).
template <int BS>
__device__ __forceinline__ void inverse_level_warp(float* Ps, float* Xw, int lane, int base) {
  constexpr int N = 8 * BS;  // (8 / BS) blocks of BS x BS
  for (int idx = lane; idx < N; idx += 32) {
    const int blk = idx / (BS * BS), rem = idx % (BS * BS), r = rem / BS, c = rem % BS, o = base + 2 * BS * blk;
    const float* a21 = Ps + (o + BS + r) * LP + o;
    float x = a21[c];
#pragma unroll
    for (int k = 1; k < BS; ++k)
      if (k > c) x = fmaf(a21[k], Ps[(o + k) * LP + o + c], x);
    Xw[idx] = x;
  }
  __syncwarp();
  for (int idx = lane; idx < N; idx += 32) {
    const int blk = idx / (BS * BS), rem = idx % (BS * BS), r = rem / BS, c = rem % BS, o = base + 2 * BS * blk;
    const float* t22 = Ps + (o + BS + r) * LP + o + BS;
    const float* xb = Xw + blk * BS * BS;
    float x = xb[r * BS + c];
#pragma unroll
    for (int k = 0; k < BS - 1; ++k)
      if (k < r) x = fmaf(t22[k], xb[k * BS + c], x);
    Ps[(o + BS + r) * LP + o + c] = -x;
  }
  __syncwarp();
}

// Level 16 of the inverse below inside the block of 32 at `base`, by the two
// warps (64 threads, ptid their index) that did its blocks of 16, meeting at
// named barrier `bar`; the products in Xp (256 floats).
__device__ __forceinline__ void inverse_level16_pair(float* Ps, float* Xp, int ptid, int base, int bar) {
  constexpr int BS = 16;
  asm volatile("bar.sync %0, 64;\n" ::"r"(bar) : "memory");  // both blocks of 16 inverted
  for (int idx = ptid; idx < BS * BS; idx += 64) {
    const int r = idx / BS, c = idx % BS;
    const float* a21 = Ps + (base + BS + r) * LP + base;
    float x = a21[c];
#pragma unroll
    for (int k = 1; k < BS; ++k)
      if (k > c) x = fmaf(a21[k], Ps[(base + k) * LP + base + c], x);
    Xp[idx] = x;
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(bar) : "memory");
  for (int idx = ptid; idx < BS * BS; idx += 64) {
    const int r = idx / BS, c = idx % BS;
    const float* t22 = Ps + (base + BS + r) * LP + base + BS;
    float x = Xp[r * BS + c];
#pragma unroll
    for (int k = 0; k < BS - 1; ++k)
      if (k < r) x = fmaf(t22[k], Xp[k * BS + c], x);
    Ps[(base + BS + r) * LP + base + c] = -x;
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(bar) : "memory");
}

// One level of T = (I + beta A)^-1 by blocks of doubling size BS, in place
// below the diagonal of Ps: T21 = -T22 (A21 T11) in each block of 2 BS.
template <int BS>
__device__ __forceinline__ void inverse_level(float* Ps, float* Xs, int tid) {
  constexpr int N = (C / 2) * BS;  // (C / 2 BS) blocks of BS x BS
  for (int idx = tid; idx < N; idx += NT) {
    const int blk = idx / (BS * BS), rem = idx % (BS * BS), r = rem / BS, c = rem % BS, o = 2 * BS * blk;
    const float* a21 = Ps + (o + BS + r) * LP + o;
    float x0 = a21[c], x1 = 0.f;  // T11's diagonal is 1
#pragma unroll
    for (int k = 1; k < BS; ++k)
      if (k > c) {
        const float term = a21[k] * Ps[(o + k) * LP + o + c];
        if (k & 1) x1 += term; else x0 += term;
      }
    Xs[idx] = x0 + x1;
  }
  __syncthreads();
  for (int idx = tid; idx < N; idx += NT) {
    const int blk = idx / (BS * BS), rem = idx % (BS * BS), r = rem / BS, c = rem % BS, o = 2 * BS * blk;
    const float* t22 = Ps + (o + BS + r) * LP + o + BS;
    const float* xb = Xs + blk * BS * BS;
    float x0 = xb[r * BS + c], x1 = 0.f;  // T22's diagonal is 1
#pragma unroll
    for (int k = 0; k < BS - 1; ++k)
      if (k < r) {
        const float term = t22[k] * xb[k * BS + c];
        if (k & 1) x1 += term; else x0 += term;
      }
    Ps[(o + BS + r) * LP + o + c] = -(x0 + x1);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1) kda_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  float* const Ss = sm + OFF_S;
  float* const Qs = sm + OFF_Q;
  float* const Ks = sm + OFF_K;
  float* const Gs = sm + OFF_G;   // G [C][LQ]; then e^(G_end - G) k
  float* const Vs = sm + OFF_V;   // e^a [C][LQ] during the pairs; then beta v, U, u [C][LV]
  float* const Ps = sm + OFF_P;
  float* const Xs = sm + OFF_X;
  float* const beta_s = sm + OFF_BETA;
  float* const gend = sm + OFF_GEND;
  float* const dec = sm + OFF_DEC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int H = a.H, S = a.S, b = blockIdx.x / H, h = blockIdx.x % H;
  const int cg = tid & 15, pg = tid >> 4;  // the loads' 8 channels and 4 positions
  const float neg_a = -expf(a.a_log[h]);
  const long long head = static_cast<long long>(b) * H + h;

  for (int i = tid; i < D * D / 4; i += NT) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    const float4 v = a.state_in == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                           : __ldg(reinterpret_cast<const float4*>(a.state_in + (head * D + r) * D) + c4);
    *reinterpret_cast<float4*>(Ss + r * LV + 4 * c4) = v;
  }

  const int chunks = (S + C - 1) / C;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int t0 = chunk * C;
    __syncthreads();  // the last chunk's readers of every buffer are done

    // ---- load: q, k, the gates and e^a, beta ----
    {
      uint4 rq[4 + HALO], rk[4 + HALO], rf[4];
      load_rows(a, 0, rq, b, h, t0, cg, pg);
      load_rows(a, 1, rk, b, h, t0, cg, pg);
      load_rows(a, 3, rf, b, h, t0, cg, pg);
      conv_rows(a, 0, rq, Qs, LQ, nullptr, h, t0, cg, pg);
      conv_rows(a, 1, rk, Ks, LQ, nullptr, h, t0, cg, pg);
      const int ch = h * D + 8 * cg;
      float bias[8];
      const float4* bp = reinterpret_cast<const float4*>(a.dt_bias + ch);
      const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
      bias[0] = b0.x, bias[1] = b0.y, bias[2] = b0.z, bias[3] = b0.w;
      bias[4] = b1.x, bias[5] = b1.y, bias[6] = b1.z, bias[7] = b1.w;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * pg + r, pos = t0 + row;
        float f[8];
        unpack8(rf[r], f);
        float gv[8], ev[8];
        const float scale = pos < S ? neg_a : 0.f;  // a factor, not a branch (conv_rows)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          gv[e] = scale * softplus(f[e] + bias[e]);
          ev[e] = expf(gv[e]);
        }
        float4* go = reinterpret_cast<float4*>(Gs + row * LQ + 8 * cg);
        float4* eo = reinterpret_cast<float4*>(Vs + row * LQ + 8 * cg);
        go[0] = make_float4(gv[0], gv[1], gv[2], gv[3]);
        go[1] = make_float4(gv[4], gv[5], gv[6], gv[7]);
        eo[0] = make_float4(ev[0], ev[1], ev[2], ev[3]);
        eo[1] = make_float4(ev[4], ev[5], ev[6], ev[7]);
      }
    }
    if (tid < C) {
      const int pos = t0 + tid;
      beta_s[tid] = pos < S ? sigmoid(__bfloat162float(a.beta[b * a.beta_sb + pos * a.beta_ss + h])) : 0.f;
    }
    __syncthreads();

    // ---- the l2 norms and the gates' running sums (warps 4-7) ----
    {
      // groups of 4 rows of q then k: 6 a warp on warps 0-3, 2 on warps 4-7 (which also sum the gates)
      const int q0 = warp < 4 ? 6 * warp : 24 + 2 * (warp - 4), q1 = warp < 4 ? q0 + 6 : q0 + 2;
      for (int q4 = q0; q4 < q1; ++q4) {
        float* row[4];
        float4 v[4];
        float s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = 4 * q4 + i;
          row[i] = (rr < C ? Qs : Ks) + (rr % C) * LQ + 4 * lane;
          v[i] = *reinterpret_cast<float4*>(row[i]);
          s[i] = v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float inv = rsqrtf(s[i] + L2NORM_EPS) * (4 * q4 < C ? a.scale : 1.f);
          v[i].x *= inv, v[i].y *= inv, v[i].z *= inv, v[i].w *= inv;
          *reinterpret_cast<float4*>(row[i]) = v[i];
        }
      }
    }
    if (warp >= 4) {
      const int c = tid - 128;
      float run[C];
#pragma unroll
      for (int r = 0; r < C; ++r) run[r] = Gs[r * LQ + c];
#pragma unroll
      for (int r = 1; r < C; ++r) run[r] += run[r - 1];
#pragma unroll
      for (int r = 0; r < C; ++r) Gs[r * LQ + c] = run[r];
      gend[c] = run[C - 1];
    }
    __syncthreads();

    // ---- the pair matrices: T's source beta_r A[r][i] at Ps[r][i] (i < r), Aq[r][i] at Ps[i][r] (i <= r) ----
    {
      // inside the block of 8 positions o = 8 warp ..: lanes (p, cq), columns p and 7 - p, channels
      // 4 cq + 32 j; the factor k_col e^(G_r - G_col) carried down the rows as the product of e^a_r
      const int o = 8 * warp, p = lane >> 3, cq = lane & 7;
#pragma unroll
      for (int which = 0; which < 2; ++which) {  // Aq's diagonal: q_r . k_r
        const int rr = o + (which ? 7 - p : p);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + rr * LQ + 4 * cq + 32 * j);
          const float4 kv = *reinterpret_cast<const float4*>(Ks + rr * LQ + 4 * cq + 32 * j);
          s += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
#pragma unroll
        for (int m = 1; m < 8; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
        if (cq == 0) Ps[rr * LP + rr] = s;
      }
      int col = o + p, r = col;
      float ke[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + col * LQ + 4 * cq + 32 * j);
        ke[j][0] = kv.x, ke[j][1] = kv.y, ke[j][2] = kv.z, ke[j][3] = kv.w;
      }
      for (int s = 0; s < 7; ++s) {
        if (s == 7 - p) {  // the second column: 7 - p, rows 8 - p .. 7
          col = o + 7 - p;
          r = col;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 kv = *reinterpret_cast<const float4*>(Ks + col * LQ + 4 * cq + 32 * j);
            ke[j][0] = kv.x, ke[j][1] = kv.y, ke[j][2] = kv.z, ke[j][3] = kv.w;
          }
        }
        ++r;
        float sa2[2] = {0.f, 0.f}, sq2[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * cq + 32 * j;
          const float4 ev = *reinterpret_cast<const float4*>(Vs + r * LQ + c);
          const float4 kv = *reinterpret_cast<const float4*>(Ks + r * LQ + c);
          const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LQ + c);
          ke[j][0] *= ev.x, ke[j][1] *= ev.y, ke[j][2] *= ev.z, ke[j][3] *= ev.w;
          sa2[j & 1] += kv.x * ke[j][0] + kv.y * ke[j][1] + kv.z * ke[j][2] + kv.w * ke[j][3];
          sq2[j & 1] += qv.x * ke[j][0] + qv.y * ke[j][1] + qv.z * ke[j][2] + qv.w * ke[j][3];
        }
        float sa = sa2[0] + sa2[1], sq = sq2[0] + sq2[1];
#pragma unroll
        for (int m = 1; m < 8; m <<= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, m);
          sq += __shfl_xor_sync(0xffffffffu, sq, m);
        }
        if (cq == 0) {
          Ps[r * LP + col] = beta_s[r] * sa;
          Ps[col * LP + r] = sq;
        }
      }
    }
    {
      // across blocks of 8, on the tensor cores: rows (k_r, q_r) e^(G_r - R) against columns
      // k_i e^(R - G_i), R = G at the last row of the columns' block. Warps 0-5 a tile of 16 x 16
      // between blocks of 16: (I, J) = (1, 0), (2, 0), (3, 0), (2, 1), (3, 1), (3, 2). Warps 6, 7 the
      // rows 8-15 x columns 0-7 of two blocks of 16 (0, 1 and 2, 3) in one tile: its row halves and
      // its column tiles each of one block (the cross terms are finite and dropped).
      const bool inner = warp >= 6;
      const int I = warp < 3 ? warp + 1 : (warp == 3 ? 2 : 3), J = warp < 3 ? 0 : (warp < 5 ? 1 : 2);
      const int b0 = 4 * (warp - 6), b1 = b0 + 2;  // inner: the two blocks of 16, as 8-blocks 2 b + 1
      const int row[2] = {inner ? 8 * b0 + 8 : 16 * I, inner ? 8 * b1 + 8 : 16 * I + 8};
      const int ref[2] = {inner ? 8 * b0 + 7 : 16 * J + 15, inner ? 8 * b1 + 7 : 16 * J + 15};
      const int colb[2] = {inner ? 8 * b0 : 16 * J, inner ? 8 * b1 : 16 * J + 8};
      float acc_a[2][4] = {}, acc_q[2][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8) {
        const int c0 = k0 + t, c1 = k0 + t + 4;
        const float Ra0 = Gs[ref[0] * LQ + c0], Ra1 = Gs[ref[1] * LQ + c0];
        const float Rb0 = Gs[ref[0] * LQ + c1], Rb1 = Gs[ref[1] * LQ + c1];
        const int ra = row[0] + g, rb = row[1] + g;
        float e[4];
        e[0] = expf(Gs[ra * LQ + c0] - Ra0);
        e[1] = expf(Gs[rb * LQ + c0] - Ra1);
        e[2] = expf(Gs[ra * LQ + c1] - Rb0);
        e[3] = expf(Gs[rb * LQ + c1] - Rb1);
        const float xk[4] = {Ks[ra * LQ + c0] * e[0], Ks[rb * LQ + c0] * e[1], Ks[ra * LQ + c1] * e[2],
                             Ks[rb * LQ + c1] * e[3]};
        const float xq[4] = {Qs[ra * LQ + c0] * e[0], Qs[rb * LQ + c0] * e[1], Qs[ra * LQ + c1] * e[2],
                             Qs[rb * LQ + c1] * e[3]};
        unsigned akh[4], akl[4], aqh[4], aql[4];
        split_a(xk, akh, akl);
        split_a(xq, aqh, aql);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int i = colb[n] + g;
          const float R0 = n ? Ra1 : Ra0, R1 = n ? Rb1 : Rb0;
          unsigned bh[2], bl[2];
          split_b(Ks[i * LQ + c0] * expf(R0 - Gs[i * LQ + c0]), Ks[i * LQ + c1] * expf(R1 - Gs[i * LQ + c1]), bh, bl);
          mma3(acc_a[n], akh, akl, bh, bl);
          mma3(acc_q[n], aqh, aql, bh, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          if (inner && h != n) continue;  // a cross term
          const int r = row[h] + g, i = colb[n] + 2 * t + (e & 1);
          Ps[r * LP + i] = beta_s[r] * acc_a[n][e];
          Ps[i * LP + r] = acc_q[n][e];
        }
    }
    __syncthreads();

    // ---- T's levels inside each block of 32 (warps 0-3: a warp a block of 16, then two a block of
    //      32); e^G q, beta e^G k, e^(G_end - G) k in place of G (warps 4-7); beta v ----
    {
      uint4 rv[4 + HALO];
      load_rows(a, 2, rv, b, h, t0, cg, pg);  // in flight meanwhile
      if (warp < 4) {
        float* const Xw = Xs + 64 * warp;
        inverse_level_warp<1>(Ps, Xw, lane, 16 * warp);
        inverse_level_warp<2>(Ps, Xw, lane, 16 * warp);
        inverse_level_warp<4>(Ps, Xw, lane, 16 * warp);
        inverse_level_warp<8>(Ps, Xw, lane, 16 * warp);
        inverse_level16_pair(Ps, Xs + 256 + 256 * (warp >> 1), tid & 63, 32 * (warp >> 1), 1 + (warp >> 1));
      } else {
        const int c = tid - 128;
        const float ge = gend[c];
#pragma unroll 1
        for (int r0 = 0; r0 < C; r0 += 8) {  // 8 rows' loads in flight, then their stores
          float gv[8], kv[8], qv[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int row = r0 + r;
            gv[r] = Gs[row * LQ + c], kv[r] = Ks[row * LQ + c], qv[r] = Qs[row * LQ + c];
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int row = r0 + r;
            const float eg = expf(gv[r]);
            Qs[row * LQ + c] = qv[r] * eg;
            Ks[row * LQ + c] = beta_s[row] * kv[r] * eg;
            Gs[row * LQ + c] = kv[r] * expf(ge - gv[r]);
          }
        }
        dec[c] = expf(ge);
      }
      conv_rows(a, 2, rv, Vs, LV, beta_s, h, t0, cg, pg);
    }
    __syncthreads();

    // ---- T = (I + beta A)^-1 in place below the diagonal: the level across the blocks of 32 ----
    inverse_level<32>(Ps, Xs, tid);

    // ---- W = T (beta e^G k) into Ks, U = T (beta v) into Vs: a warp 32 columns, all 64 rows ----
    {
      float* const Bm = warp < 4 ? Ks : Vs;
      const int ldb = warp < 4 ? LQ : LV, n0 = 32 * (warp & 3);
      float acc[4][4][4] = {};
#pragma unroll 2
      for (int ks = 0; ks < C / 8; ++ks) {
        const int k0 = 8 * ks;
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          split_b(Bm[(k0 + t) * ldb + n0 + 8 * n + g], Bm[(k0 + t + 4) * ldb + n0 + 8 * n + g], bh[n], bl[n]);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m < (ks >> 1)) continue;  // T is lower triangular
          const int ra = 16 * m + g, rb = ra + 8, ka = k0 + t, kb = ka + 4;
          const float x[4] = {ka < ra ? Ps[ra * LP + ka] : (ka == ra ? 1.f : 0.f),
                              ka < rb ? Ps[rb * LP + ka] : (ka == rb ? 1.f : 0.f),
                              kb < ra ? Ps[ra * LP + kb] : (kb == ra ? 1.f : 0.f),
                              kb < rb ? Ps[rb * LP + kb] : (kb == rb ? 1.f : 0.f)};
          unsigned ah[4], al[4];
          split_a(x, ah, al);
          mma3(acc[m], ah, al, bh, bl);
        }
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int r = 16 * m + g, c = n0 + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(Bm + r * ldb + c) = make_float2(acc[m][n][0], acc[m][n][1]);
          *reinterpret_cast<float2*>(Bm + (r + 8) * ldb + c) = make_float2(acc[m][n][2], acc[m][n][3]);
        }
    }
    __syncthreads();

    // ---- u = U - W S into Vs, P = (e^G q) S kept: a warp 32 rows x 32 columns ----
    // warps w and w + 4 share a scheduler: one of each row half, as the o product's triangle is
    // 2.3 times heavier in the lower half
    const int rh = warp >> 2, cq = warp & 3;
    float acc_p[2][4][4] = {};
    {
      if (chunk + 1 < chunks) {  // the next chunk's inputs toward L2
        const int pos = t0 + C + (tid & 63), j = tid >> 6;
        if (pos < S) {
          const __nv_bfloat16* p = a.x[j] + b * a.sb[j] + pos * a.ss[j] + h * D;
          asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(p + 64));
        }
      }
      float acc_u[2][4][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8) {
        unsigned bh[4][2], bl[4][2], wh[2][4], wl[2][4], qh[2][4], ql[2][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 32 * cq + 8 * n + g;
          split_b(Ss[(k0 + t) * LV + c], Ss[(k0 + t + 4) * LV + c], bh[n], bl[n]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int ra = 32 * rh + 16 * m + g, rb = ra + 8, ka = k0 + t, kb = ka + 4;
          const float xw[4] = {Ks[ra * LQ + ka], Ks[rb * LQ + ka], Ks[ra * LQ + kb], Ks[rb * LQ + kb]};
          const float xq[4] = {Qs[ra * LQ + ka], Qs[rb * LQ + ka], Qs[ra * LQ + kb], Qs[rb * LQ + kb]};
          split_a(xw, wh[m], wl[m]);
          split_a(xq, qh[m], ql[m]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma3(acc_u[m], wh[m], wl[m], bh, bl);
          mma3(acc_p[m], qh[m], ql[m], bh, bl);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int r = 32 * rh + 16 * m + g, c = 32 * cq + 8 * n + 2 * t;
          float2* lo = reinterpret_cast<float2*>(Vs + r * LV + c);
          float2* hi = reinterpret_cast<float2*>(Vs + (r + 8) * LV + c);
          const float2 ul = *lo, uh = *hi;
          *lo = make_float2(ul.x - acc_u[m][n][0], ul.y - acc_u[m][n][1]);
          *hi = make_float2(uh.x - acc_u[m][n][2], uh.y - acc_u[m][n][3]);
        }
    }
    __syncthreads();

    // ---- o = P + Aq u, stored ----
    {
#pragma unroll 1
      for (int ks = 0; ks < 4 * rh + 4; ++ks) {  // Aq is lower triangular: rows < 32 rh + 32
        const int k0 = 8 * ks;
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 32 * cq + 8 * n + g;
          split_b(Vs[(k0 + t) * LV + c], Vs[(k0 + t + 4) * LV + c], bh[n], bl[n]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (ks > 4 * rh + 2 * m + 1) continue;
          const int ra = 32 * rh + 16 * m + g, rb = ra + 8, ka = k0 + t, kb = ka + 4;
          const float x[4] = {ka <= ra ? Ps[ka * LP + ra] : 0.f, ka <= rb ? Ps[ka * LP + rb] : 0.f,
                              kb <= ra ? Ps[kb * LP + ra] : 0.f, kb <= rb ? Ps[kb * LP + rb] : 0.f};
          unsigned ah[4], al[4];
          split_a(x, ah, al);
          mma3(acc_p[m], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 32 * rh + 16 * m + g + 8 * half, pos = t0 + r;
          if (pos >= S) continue;
          float* orow = a.o + ((static_cast<long long>(b) * S + pos) * H + h) * D + 32 * cq + 2 * t;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(acc_p[m][n][2 * half], acc_p[m][n][2 * half + 1]);
        }
    }

    // ---- S = e^G_end S + (e^(G_end - G) k)^T u: a warp 32 key rows x 64 value columns ----
    {
      const int m0 = 32 * (warp & 3), n0 = 64 * (warp >> 2);
      float acc[2][8][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 8) {
        unsigned ah[2][4], al[2][4], bh[8][2], bl[8][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int ra = m0 + 16 * m + g, rb = ra + 8, ka = k0 + t, kb = ka + 4;
          const float x[4] = {Gs[ka * LQ + ra], Gs[ka * LQ + rb], Gs[kb * LQ + ra], Gs[kb * LQ + rb]};
          split_a(x, ah[m], al[m]);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = n0 + 8 * n + g;
          split_b(Vs[(k0 + t) * LV + c], Vs[(k0 + t + 4) * LV + c], bh[n], bl[n]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) mma3(acc[m], ah[m], al[m], bh, bl);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + 16 * m + g + 8 * half;
          const float d = dec[r];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            float2* s = reinterpret_cast<float2*>(Ss + r * LV + n0 + 8 * n + 2 * t);
            const float2 old = *s;
            *s = make_float2(fmaf(d, old.x, acc[m][n][2 * half]), fmaf(d, old.y, acc[m][n][2 * half + 1]));
          }
        }
    }
  }
  __syncthreads();

  if (a.state_out != nullptr) {
    for (int i = tid; i < D * D / 4; i += NT) {
      const int r = i / (D / 4), c4 = i % (D / 4);
      reinterpret_cast<float4*>(a.state_out + (head * D + r) * D)[c4] =
          *reinterpret_cast<const float4*>(Ss + r * LV + 4 * c4);
    }
  }
  if (a.conv_out != nullptr) {  // the last HALO inputs of q, k, v: positions S - 3 .. S - 1, the carried ones before 0
    const int width = H * D;
    __nv_bfloat16 keep[(3 * HALO * D + NT - 1) / NT];
#pragma unroll
    for (int n = 0; n < (3 * HALO * D + NT - 1) / NT; ++n) {
      const int i = tid + n * NT;
      if (i >= 3 * HALO * D) break;
      const int j = i / (HALO * D), row = (i / D) % HALO, c = i % D, pos = S - HALO + row;
      keep[n] = pos >= 0 ? a.x[j][b * a.sb[j] + pos * a.ss[j] + h * D + c]
                         : (a.conv_in == nullptr ? __float2bfloat16(0.f)
                                                 : a.conv_in[(static_cast<long long>(b) * HALO + pos + HALO) * 3 * width +
                                                             j * width + h * D + c]);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < (3 * HALO * D + NT - 1) / NT; ++n) {
      const int i = tid + n * NT;
      if (i >= 3 * HALO * D) break;
      const int j = i / (HALO * D), row = (i / D) % HALO, c = i % D;
      a.conv_out[(static_cast<long long>(b) * HALO + row) * 3 * width + j * width + h * D + c] = keep[n];
    }
  }
}

}  // namespace

// q, k, v, f: bf16 [B, S, H * 128] with unit channel stride, 16-byte aligned rows (batch and position
// strides in `strides` 0..7, each a multiple of 8); beta: bf16 [B, S, H], unit head stride (strides 8, 9);
// wq, wk, wv: bf16 [H * 128][4] contiguous; a_log: float32 [H]; dt_bias: float32 [H * 128], 16-byte
// aligned; conv_in / conv_out: bf16 [B, 3, 3 H 128] contiguous, 16-byte aligned, or null (in: zeros; out:
// not written; they may alias); state_in / state_out: float32 [B, H, 128, 128] contiguous, or null (may
// alias); o: float32 [B, S, H, 128] contiguous. d, taps and chunk must be 128, 4 and 64. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for sizes it was not built for).
extern "C" int dmel_kda_scan(const void* q, const void* k, const void* v, const void* f, const void* beta,
                             const long long* strides, const void* wq, const void* wk, const void* wv,
                             const void* a_log, const void* dt_bias, const void* conv_in, void* conv_out,
                             const void* state_in, void* state_out, void* o, int B, int S, int H, int d, int taps,
                             int chunk, float scale, void* stream) {
  if (d != D || taps != TAPS || chunk != C || B < 1 || S < 1 || H < 1 || static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  const void* xs[4] = {q, k, v, f};
  const void* ws[3] = {wq, wk, wv};
  for (int i = 0; i < 4; ++i) {
    a.x[i] = static_cast<const __nv_bfloat16*>(xs[i]);
    a.sb[i] = strides[2 * i];
    a.ss[i] = strides[2 * i + 1];
  }
  for (int i = 0; i < 3; ++i) a.w[i] = static_cast<const __nv_bfloat16*>(ws[i]);
  a.beta = static_cast<const __nv_bfloat16*>(beta);
  a.beta_sb = strides[8];
  a.beta_ss = strides[9];
  a.a_log = static_cast<const float*>(a_log);
  a.dt_bias = static_cast<const float*>(dt_bias);
  a.conv_in = static_cast<const __nv_bfloat16*>(conv_in);
  a.conv_out = static_cast<__nv_bfloat16*>(conv_out);
  a.state_in = static_cast<const float*>(state_in);
  a.state_out = static_cast<float*>(state_out);
  a.o = static_cast<float*>(o);
  a.S = S;
  a.H = H;
  a.scale = scale;
  const cudaError_t e =
      cudaFuncSetAttribute(kda_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  kda_scan_kernel<<<static_cast<unsigned>(B * H), NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
