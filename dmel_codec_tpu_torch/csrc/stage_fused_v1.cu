// K2-v1: a whole BigVGAN AMP resblock stage in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `fused_amp_stage`
// (dmel_codec_tpu/ops/stage_fused.py, `use_v2=False`): for k in (3, 7, 11):
// xb = x; for d in (1, 3, 5): xb += conv_{k,1}(act(conv_{k,d}(act(xb))));
// out = mean of the three xb. What sets it apart from K2 (one launch per
// act -> conv pair, planes through device memory) is that the whole chain
// of a time tile stays in shared memory in float32 and is rounded once, at
// the store. ops/stage_fused.py amp_stage_v1 launches it once per stage;
// stage_reference_v1 is the plain PyTorch version. Two kernels, picked by
// dtype as the JAX kernel runs bf16 convs on the matrix unit and float32 at
// HIGHEST:
//
// bf16, stage_v1_tc_kernel (the vocoder's path). Bound on the H100: by
// operations, the C x C x k convs at the bf16 tensor-core rate beside the
// 36 activations on the CUDA cores (two 6-tap up FIRs, two sinf and a
// 12-tap down FIR per sample), with R = 96 columns per side of receptive
// field that a tile must either recompute or fetch. The earlier design
// (one CTA per tile, float32 FMA convs) recomputed 2.55x the stored columns
// at C = 48 and ran at 1 % of its bound. Design:
//  * A thread-block cluster of G = 8 CTAs owns 8 adjacent tiles of W
//    columns (256 at C = 48, 512 at C <= 32: what fits 227 KB). After each
//    of the 36 operations the CTAs pull their neighbours' edge columns
//    through distributed shared memory (mapa + ld.shared::cluster, one
//    barrier.cluster each): only the cluster window's two ends compute what
//    is not stored, 1.10x the stored columns at C = 48, 1.05x at C = 24.
//  * The conv input is a bf16 plane in wgmma's no-swizzle K-major layout
//    [KP / 8][rows][8] (as stage_fused_tc.cu), so tap j's operand is the
//    same plane shifted by j d rows (the descriptor's start address). Each
//    warpgroup runs wgmma m64nNk16 (N = C rounded up to 24, 32 or 48) over
//    (tap, 16 input channels) for its 64-row tiles; the conv's weights come
//    by one bulk copy (TMA) into shared memory while the activation before
//    the conv runs.
//  * The activation: a warp per (channel, 128 columns), lanes in odd runs
//    over register windows of its input, both snake phases into the warp's
//    scratch, then the down FIR, written to the bf16 plane.
//  * The running sum of the three resblocks goes to a float32 scratch in
//    device memory (it would cost shared memory that W needs).
// Each stored output goes through the same operations wherever its tile
// lies, so a run on a slice gives the bits of the whole run beyond R
// samples from the cut. Numeric contract (stage_fused.py:145-149, 253-268,
// 297): input cast to float32; activations float32 with float32 taps and
// sinf; conv operands (the activation's output, the weights) rounded to
// bf16, summed in float32 by the tensor cores, bias float32; residual spine
// and running sum float32; one cast at the store.
//
// float32, stage_v1_kernel (the earlier design, kept for its bits):
// the convs on the float32 CUDA cores, one CTA per tile, its window the
// tile plus R columns per side clipped to [0, T). Per column a block holds
// three float32 planes (xb, the conv input a, the conv output t) and, for
// the W stored columns, the running sum: W = 124 of 316 columns at C = 48,
// 404 of 596 at C = 24; C = 96 does not fit, so the wrapper refuses C > 48
// (V1_MAX_CHANNELS) and the serving vocoder sends those stages to K2. The
// block treats its window as a signal of its own: activations replicate the
// window's first and last sample (and, as the reference chain does, the
// post-snake 2x signal), convs see zeros beyond it; the error that makes
// travels at most R columns and never reaches the stored tile. Activation:
// a warp takes (channel, segment of 122 outputs): both snake phases at the
// 128 half-rate indices the segment needs into the warp's scratch, then the
// down FIR. Conv: a warp takes (8 output channels, 64 columns), each thread
// 8 x 2 accumulators; input channels stream through shared memory in chunks
// (weights pre-transposed to [k][C_in][C_out8] by the wrapper). For float32
// input it is exactly the oracle.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 512;         // threads per block
constexpr int NW = NT / 32;     // warps
constexpr int SEG = 122;        // activation outputs per warp unit
constexpr int SEGV = SEG + 6;   // half-rate snake indices they need (128)
constexpr int SCR = NW * 2 * SEGV;  // scratch floats: activation phases / conv weights
constexpr int SMEM = 227 * 1024;  // dynamic shared memory one block may ask for on sm_90
constexpr int MAXB = 8;         // resblocks per stage
constexpr int MAXD = 8;         // dilations per resblock

struct V1Spec {
  int n_blk;
  int k[MAXB];
  int n_dil[MAXB];
  int dil[MAXB][MAXD];
};

// Up-FIR phases on a row of n samples with replicate edges.
__device__ __forceinline__ float up_even_c(const float* row, int s, int n, dmel::Taps tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i + 1] * row[dmel::clampi(s + 2 - i, 0, n - 1)];
  return 2.f * acc;
}

__device__ __forceinline__ float up_odd_c(const float* row, int s, int n, dmel::Taps tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i] * row[dmel::clampi(s + 3 - i, 0, n - 1)];
  return 2.f * acc;
}

// dst[c][j] = round(act_{nconv}(src[c][.])[j]) for j in [0, n), all channels.
__device__ void act_plane(const float* src, int src_stride, float* dst, int dst_stride,
                          int C, int n, const float* alpha, const float* inv_beta,
                          int n_convs, int nconv, float* scr, dmel::Taps tp) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ve = scr + warp * 2 * SEGV;
  float* vo = ve + SEGV;
  const int n_seg = (n + SEG - 1) / SEG;
  for (int u = warp; u < C * n_seg; u += NW) {
    const int c = u / n_seg;
    const int s0 = (u - c * n_seg) * SEG;
    const float a = alpha[c * n_convs + nconv];
    const float ib = inv_beta[c * n_convs + nconv];
    const float* row = src + c * src_stride;
#pragma unroll
    for (int q = 0; q < SEGV / 32; ++q) {
      const int i = lane + 32 * q;
      const int s = s0 - 3 + i;
      float e, o;
      if (s < 0) {
        e = o = dmel::snake(up_even_c(row, 0, n, tp), a, ib);
      } else if (s >= n) {
        e = o = dmel::snake(up_odd_c(row, n - 1, n, tp), a, ib);
      } else {
        e = dmel::snake(up_even_c(row, s, n, tp), a, ib);
        o = dmel::snake(up_odd_c(row, s, n, tp), a, ib);
      }
      ve[i] = e;
      vo[i] = o;
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < SEGV / 32; ++q) {
      const int i = lane + 32 * q;
      if (i < SEG && s0 + i < n) {
        dst[c * dst_stride + s0 + i] = dmel::down(ve + i, vo + i, tp);
      }
    }
    __syncwarp();
  }
}

// dst[co][j] (+)= bias[co] + sum_{ci, tap} w[tap][ci][co] * a[ci][j + (tap - half) * d]
// for j in [0, n). `a` points at column 0 of a plane whose rows have at
// least half * d zero columns on both sides of [0, n). wt: [k][C][CP]
// (tap, in, out padded to CP = 8 * ceil(C / 8)), float32 or bfloat16.
template <bool ADD>
__device__ void conv_plane(const float* a, int a_stride, float* dst, int dst_stride,
                           const float* wt, const float* bias, int n_convs,
                           int nconv, int C, int CP, int n, int k, int d, int ci_chunk,
                           float* ws) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = (k - 1) / 2;
  const int n_og = CP / 8;
  const int units = n_og * ((n + 63) / 64);
  for (int u0 = 0; u0 < units; u0 += NW) {
    const int u = u0 + warp;
    const bool active = u < units;
    const int og = active ? u % n_og : 0;
    const int col0 = (active ? u / n_og : 0) * 64 + lane;
    // masked columns read a valid one; they are never stored
    const int c0 = min(col0, n - 1), c1 = min(col0 + 32, n - 1);
    float acc[8][2];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c][0] = acc[c][1] = 0.f;

    for (int ci0 = 0; ci0 < C; ci0 += ci_chunk) {
      const int nci = min(ci_chunk, C - ci0);
      __syncthreads();  // the previous chunk's (or op's) readers are done
      // ws[tap][ci][co] = wt[tap][ci0 + ci][co]: nci * CP contiguous per tap
      for (int i = threadIdx.x; i < k * nci * CP; i += NT) {
        const int tap = i / (nci * CP);
        const int r = i - tap * nci * CP;
        ws[tap * ci_chunk * CP + r] =
            wt[static_cast<long long>(tap * C + ci0) * CP + r];
      }
      __syncthreads();
      if (active) {
        for (int ci = 0; ci < nci; ++ci) {
          const float* arow = a + (ci0 + ci) * a_stride;
          const float* wrow = ws + ci * CP + og * 8;
          for (int tap = 0; tap < k; ++tap) {
            const float4 w0 = *reinterpret_cast<const float4*>(wrow + tap * ci_chunk * CP);
            const float4 w1 = *reinterpret_cast<const float4*>(wrow + tap * ci_chunk * CP + 4);
            const int off = (tap - half) * d;
            const float x0 = arow[c0 + off], x1 = arow[c1 + off];
            acc[0][0] += w0.x * x0; acc[0][1] += w0.x * x1;
            acc[1][0] += w0.y * x0; acc[1][1] += w0.y * x1;
            acc[2][0] += w0.z * x0; acc[2][1] += w0.z * x1;
            acc[3][0] += w0.w * x0; acc[3][1] += w0.w * x1;
            acc[4][0] += w1.x * x0; acc[4][1] += w1.x * x1;
            acc[5][0] += w1.y * x0; acc[5][1] += w1.y * x1;
            acc[6][0] += w1.z * x0; acc[6][1] += w1.z * x1;
            acc[7][0] += w1.w * x0; acc[7][1] += w1.w * x1;
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int co = og * 8 + c;
        if (co >= C) continue;
        const float b = bias[co * n_convs + nconv];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = col0 + 32 * q;
          if (col >= n) continue;
          float* p = dst + co * dst_stride + col;
          *p = ADD ? *p + (acc[c][q] + b) : acc[c][q] + b;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
stage_v1_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ bias, const float* __restrict__ alpha,
                const float* __restrict__ inv_beta, float* __restrict__ out,
                int C, int T, int W, int R, int PAD, int ci_chunk, int parts, V1Spec spec,
                dmel::Taps taps) {
  extern __shared__ float4 smem4[];
  float* scr = reinterpret_cast<float*>(smem4);  // [SCR], 16-byte aligned
  const int Wf = W + 2 * R;
  const int Wa = Wf + 2 * PAD;
  const int CP = (C + 7) / 8 * 8;
  float* xb = scr + SCR;     // [C][Wf] residual spine
  float* tp = xb + C * Wf;   // [C][Wf] conv output
  float* ap = tp + C * Wf;   // [C][Wa] conv input, zero outside [PAD, PAD + n)
  float* acc = ap + C * Wa;  // [C][W]  running sum of the resblocks
  float* a0 = ap + PAD;      // column 0 of the window

  const int t0 = blockIdx.x * W;
  const int wlo = max(t0 - R, 0);
  const int n = min(t0 + W + R, T) - wlo;  // window columns, all inside the signal
  const int nc = min(W, T - t0);           // stored columns
  const int coff = t0 - wlo;               // first stored column in the window
  const long long plane = static_cast<long long>(blockIdx.y) * C * T;

  int n_convs = 0;
  for (int b = 0; b < spec.n_blk; ++b) n_convs += 2 * spec.n_dil[b];

  for (int i = threadIdx.x; i < C * Wa; i += NT) ap[i] = 0.f;

  int nconv = 0;
  long long woff = 0;  // this conv's weights in wt
  for (int b = 0; b < spec.n_blk; ++b) {
    const int k = spec.k[b];
    for (int i = threadIdx.x; i < C * n; i += NT) {
      const int c = i / n;
      const int j = i - c * n;
      xb[c * Wf + j] = x[plane + static_cast<long long>(c) * T + wlo + j];
    }
    __syncthreads();
    for (int p = 0; p < spec.n_dil[b]; ++p) {
      const long long wsz = static_cast<long long>(k) * C * CP;
      const float* w1 = wt + woff;
      const float* w2 = wt + woff + wsz;
      if (parts & 1) act_plane(xb, Wf, a0, Wa, C, n, alpha, inv_beta, n_convs, nconv, scr, taps);
      __syncthreads();
      if (parts & 2) conv_plane<false>(a0, Wa, tp, Wf, w1, bias, n_convs, nconv, C, CP, n, k, spec.dil[b][p], ci_chunk, scr);
      __syncthreads();
      if (parts & 1) act_plane(tp, Wf, a0, Wa, C, n, alpha, inv_beta, n_convs, nconv + 1, scr, taps);
      __syncthreads();
      if (parts & 2) conv_plane<true>(a0, Wa, xb, Wf, w2, bias, n_convs, nconv + 1, C, CP, n, k, 1, ci_chunk, scr);
      __syncthreads();
      nconv += 2;
      woff += 2 * wsz;
    }
    for (int i = threadIdx.x; i < C * nc; i += NT) {
      const int c = i / nc;
      const int j = i - c * nc;
      const float v = xb[c * Wf + coff + j];
      acc[c * W + j] = b == 0 ? v : acc[c * W + j] + v;
    }
    __syncthreads();  // xb is reloaded next
  }

  const float scale = 1.f / static_cast<float>(spec.n_blk);
  for (int i = threadIdx.x; i < C * nc; i += NT) {
    const int c = i / nc;
    const int j = i - c * nc;
    out[plane + static_cast<long long>(c) * T + t0 + j] = acc[c * W + j] * scale;
  }
}


// ---- bf16: the convs on the tensor cores, a cluster of tiles -------------

constexpr int TC_NT = 512;                            // 4 warpgroups
constexpr int TC_NW = TC_NT / 32;
constexpr int TC_XH = 8;                              // act-input halo columns per side (an act reaches 6)
constexpr int TC_PA = 32;                             // conv-input halo rows per side (a conv reaches <= 32)
constexpr int TC_SEG = 128;                           // activation outputs per warp unit
constexpr int TC_NS = TC_SEG + 6;                     // the half-rate positions they need
constexpr int TC_RUN_S = ((TC_NS + 31) / 32) | 1;     // a lane's run of positions (odd: distinct banks)
constexpr int TC_RUN_R = ((TC_SEG + 31) / 32) | 1;    // a lane's run of outputs
constexpr int TC_LV = 136;                            // scratch floats per phase and warp (>= 25 * 5 + 11)

__host__ __device__ constexpr uint32_t align128(uint32_t v) { return (v + 127u) & ~127u; }

// Shared memory of a block (ops/stage_fused.v1_tc_bytes mirrors it): the
// float32 residual spine xb and conv output t ([C][W + 2 XH] each), the bf16
// conv input a in wgmma's no-swizzle K-major layout ([KP / 8][W + 2 PA][8]),
// one conv's weights ([k][KP / 8][N][8] bf16), the activation scratch and
// the weights' mbarrier.
struct V1TcLayout {
  int lw, ra;
  uint32_t xb, tp, a, w, scr, bar, total;
};

__host__ __device__ inline V1TcLayout v1tc_layout(int C, int KP, int N, int W, int kmax) {
  V1TcLayout l;
  l.lw = W + 2 * TC_XH;
  l.ra = W + 2 * TC_PA;
  l.xb = 0;
  l.tp = l.xb + align128(4u * C * l.lw);
  l.a = l.tp + align128(4u * C * l.lw);
  l.w = l.a + align128(2u * KP * l.ra);
  l.scr = l.w + align128(2u * kmax * KP * N);
  l.bar = l.scr + 4u * TC_NW * 2 * TC_LV;
  l.total = l.bar + 16 + 128;  // + the alignment of the base to 128 bytes
  return l;
}

// a[c][j] = bf16(act(src[c][.])[j]) for this CTA's columns j in [0, W)
// that lie in the window [0, n) (window column gW + j); the rest of a is
// left as it is (zero). src rows hold local columns [-XH, W + XH); reads
// are clamped to the window, whose first and last samples the activation
// replicates, and the post-snake edge rule applies at its ends, as if the
// window were the whole signal. v1 contract: float32 taps and v, only the
// output rounded (the conv's operand).
__device__ void act_tc(const float* src, int lw, __nv_bfloat16* at, int ra, int C, int W, int gW, int n,
                       const float* alpha, const float* inv_beta, int n_convs, int nconv, float* scr,
                       const dmel::Taps& tp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ve = scr + warp * 2 * TC_LV;
  float* vo = ve + TC_LV;
  const int n_seg = W / TC_SEG;
  const int lo = max(-gW, -TC_XH), hi = min(n - 1 - gW, W + TC_XH - 1);
  for (int u = warp; u < C * n_seg; u += TC_NW) {
    const int c = u / n_seg;
    const int j0 = (u - c * n_seg) * TC_SEG;
    const int g0 = gW + j0;
    if (g0 >= n) continue;  // beyond the window: a stays zero
    const float a = alpha[c * n_convs + nconv];
    const float ib = inv_beta[c * n_convs + nconv];
    const float* row = src + c * lw + TC_XH;
    // positions p = 0 .. TC_NS - 1 are local columns j0 - 3 + p; a lane
    // takes p0 .. p0 + TC_RUN_S - 1 from a window of x at j0 - 6 + p0 + i
    const int p0 = lane * TC_RUN_S;
    float wx[TC_RUN_S + 6];
#pragma unroll
    for (int i = 0; i < TC_RUN_S + 6; ++i) wx[i] = row[dmel::clampi(j0 - 6 + p0 + i, lo, hi)];
#pragma unroll
    for (int q = 0; q < TC_RUN_S; ++q) {
      const int p = p0 + q;
      if (p < TC_NS) {
        ve[p] = dmel::snake(dmel::up_even_w(wx, q, tp), a, ib);
        vo[p] = dmel::snake(dmel::up_odd_w(wx, q, tp), a, ib);
      }
    }
    __syncwarp();
    const int r0 = lane * TC_RUN_R;
    if (r0 < TC_SEG) {
      // the post-snake edge rule: v_e = v_o = v_e at window column 0 before
      // it, v_o at column n - 1 after it
      const int pz = min(max(3 - g0, 0), TC_LV - 1), pl = min(max(n + 2 - g0, 0), TC_LV - 1);
      float ew[TC_RUN_R + 5], ow[TC_RUN_R + 5];
#pragma unroll
      for (int i = 0; i < TC_RUN_R + 5; ++i) {
        const int pe = r0 + 1 + i, po = r0 + i;
        const int ge = g0 - 3 + pe, go = g0 - 3 + po;
        ew[i] = ge < 0 ? ve[pz] : (ge >= n ? vo[pl] : ve[pe]);
        ow[i] = go < 0 ? ve[pz] : (go >= n ? vo[pl] : vo[po]);
      }
      __nv_bfloat16* ac = at + (c / 8) * ra * 8 + c % 8;
#pragma unroll
      for (int q = 0; q < TC_RUN_R; ++q) {
        const int r = r0 + q;
        if (r < TC_SEG) {
          const float v = g0 + r < n ? dmel::down_w(ew, ow, q, tp) : 0.f;
          ac[(TC_PA + j0 + r) * 8] = __float2bfloat16(v);
        }
      }
    }
    __syncwarp();
  }
}

// dst[c][j] (+)= conv(a)[c][j] + bias[c] for j in [0, W): each warpgroup
// takes 64-row tiles mt = g4, g4 + 4, .. and runs wgmma m64nNk16 over (tap,
// 16 input channels); tap j's operand is the tile shifted by j d - P rows
// (the descriptor's start address), its weights [KP / 8][N][8] in w.
template <int N, bool ADD>
__device__ void conv_tc(uint32_t a_sm, int ra, uint32_t w_sm, float* dst, int lw, const float* bias, int n_convs,
                        int nconv, int C, int KP, int W, int k, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g4 = warp / 4;
  const int P = d * (k - 1) / 2;
  const uint32_t lbo_a = static_cast<uint32_t>(ra) * 16;
  const int ksteps = KP / 16;
  for (int mt = g4; mt < W / 64; mt += 4) {
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    dmel::fence_operands(acc);
    dmel::wgmma_fence();
    for (int j = 0; j < k; ++j) {
      const uint32_t a0 = a_sm + static_cast<uint32_t>(TC_PA + mt * 64 + j * d - P) * 16;
      const uint32_t b0 = w_sm + static_cast<uint32_t>(j * (KP / 8)) * N * 16;
      for (int kk = 0; kk < ksteps; ++kk) {
        dmel::wgmma<N, 0>(acc, dmel::plain_desc(a0 + 2 * kk * lbo_a, lbo_a, 128),
                          dmel::plain_desc(b0 + 2 * kk * N * 16, N * 16, 128), (j | kk) != 0);
      }
    }
    dmel::wgmma_commit();
    dmel::wgmma_wait<0>();
    dmel::fence_operands(acc);
    // acc[4 jn + 2 h + e]: row 16 (warp % 4) + g + 8 h, column 8 jn + 2 tq + e
    const int g = lane / 4, tq = lane % 4;
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = 8 * jn + 2 * tq + e;
        if (co >= C) continue;
        const float b = bias[co * n_convs + nconv];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* p = dst + co * lw + TC_XH + mt * 64 + 16 * (warp % 4) + g + 8 * h;
          const float v = acc[4 * jn + 2 * h + e];
          *p = ADD ? *p + (v + b) : v + b;
        }
      }
    }
  }
}

// The halo columns [-XH, 0) and [W, W + XH) of a float32 plane from the
// neighbours' edge columns (none beyond the cluster's ends: the activation
// clamps its reads to the window there).
__device__ void pull_cols(float* plane, uint32_t plane_sa, int C, int lw, int W, int rank, int G) {
  for (int i = threadIdx.x; i < C * 4; i += TC_NT) {
    const int c = i >> 2, side = (i >> 1) & 1, h = i & 1;
    const int nb = side ? rank + 1 : rank - 1;
    if (nb < 0 || nb >= G) continue;
    const int from = side ? 4 * h : W - TC_XH + 4 * h;
    const int to = side ? W + 4 * h : -TC_XH + 4 * h;
    const uint4 v = dmel::ld_peer(plane_sa + 4u * (c * lw + TC_XH + from), nb);
    *reinterpret_cast<uint4*>(plane + c * lw + TC_XH + to) = v;
  }
}

// The halo rows [-PA, 0) and [W, W + PA) of the conv input from the
// neighbours' edge rows (zero beyond the cluster's ends, as the conv sees
// zeros beyond the window).
__device__ void pull_rows(unsigned char* at, uint32_t a_sm, int KP, int ra, int W, int rank, int G) {
  for (int i = threadIdx.x; i < (KP / 8) * 2 * TC_PA; i += TC_NT) {
    const int q = i / (2 * TC_PA), rr = i % (2 * TC_PA);
    const int side = rr >= TC_PA, r = rr % TC_PA;
    const int nb = side ? rank + 1 : rank - 1;
    if (nb < 0 || nb >= G) continue;
    const int from = side ? r : W - TC_PA + r;
    const int to = side ? W + r : -TC_PA + r;
    const uint4 v = dmel::ld_peer(a_sm + 16u * (q * ra + TC_PA + from), nb);
    *reinterpret_cast<uint4*>(at + 16 * (q * ra + TC_PA + to)) = v;
  }
}

// One bf16 stage, v1 contract. A cluster of G CTAs computes a window of
// G W columns (the S = G W - 2 R it stores and R more on each side, clipped
// to [0, T)); CTA `rank` owns window columns [rank W, rank W + W). After
// every operation the CTAs pull their neighbours' edge columns (the conv
// input's 32 rows, the activation input's 8 columns) through distributed
// shared memory, one cluster barrier each, so that only the window's ends
// compute what is not stored. Each stored output goes through the same
// operations wherever its tile lies.
template <int N>
__global__ void __launch_bounds__(TC_NT, 1)
stage_v1_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ alpha,
                   const float* __restrict__ inv_beta, __nv_bfloat16* __restrict__ out, float* __restrict__ acc_g,
                   int C, int T, int W, int R, int KP, int kmax, int parts, V1Spec spec, dmel::Taps taps) {
  extern __shared__ __align__(128) unsigned char v1_raw[];
  const V1TcLayout L = v1tc_layout(C, KP, N, W, kmax);
  const uint32_t raw_sa = static_cast<uint32_t>(__cvta_generic_to_shared(v1_raw));
  const uint32_t base = (raw_sa + 127) & ~127u;
  unsigned char* gbase = v1_raw + (base - raw_sa);
  float* xb = reinterpret_cast<float*>(gbase + L.xb);
  float* tp = reinterpret_cast<float*>(gbase + L.tp);
  unsigned char* at = gbase + L.a;
  float* scr = reinterpret_cast<float*>(gbase + L.scr);
  const uint32_t a_sm = base + L.a, w_sm = base + L.w, bar = base + L.bar;
  const int tid = threadIdx.x;

  const int rank = static_cast<int>(dmel::cluster_rank()), G = static_cast<int>(dmel::cluster_size());
  const int S = G * W - 2 * R;
  const int t0 = (blockIdx.x / G) * S;
  const int wlo = max(t0 - R, 0);
  const int n = min(t0 + S + R, T) - wlo;  // window columns
  const int gW = rank * W;                 // window column of local column 0
  const bool live = gW < n;
  const int coff = t0 - wlo, nc = min(S, T - t0);  // stored window columns [coff, coff + nc)
  const long long plane = static_cast<long long>(blockIdx.y) * C * T;

  int n_convs = 0;
  for (int b = 0; b < spec.n_blk; ++b) n_convs += 2 * spec.n_dil[b];

  for (int i = tid; i < (KP / 8) * L.ra; i += TC_NT) reinterpret_cast<uint4*>(at)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    dmel::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = 2u * spec.k[0] * KP * N;
    dmel::mbar_expect_tx(bar, bytes);
    dmel::bulk_load(w_sm, w, bytes, bar);
  }

  const float scale = 1.f / static_cast<float>(spec.n_blk);
  int nconv = 0;
  long long woff = 0;
  for (int b = 0; b < spec.n_blk; ++b) {
    const int k = spec.k[b];
    // xb = x on local columns [-XH, W + XH), clamped to the signal
    for (int i = tid; i < C * L.lw; i += TC_NT) {
      const int c = i / L.lw;
      const int col = dmel::clampi(wlo + gW + (i - c * L.lw) - TC_XH, 0, T - 1);
      xb[i] = __bfloat162float(x[plane + static_cast<long long>(c) * T + col]);
    }
    __syncthreads();
    for (int p = 0; p < spec.n_dil[b]; ++p) {
      for (int half = 0; half < 2; ++half) {
        float* src = half ? tp : xb;
        float* dst = half ? xb : tp;
        const int d = half ? 1 : spec.dil[b][p];
        if ((parts & 1) && live) {
          act_tc(src, L.lw, reinterpret_cast<__nv_bfloat16*>(at), L.ra, C, W, gW, n, alpha, inv_beta, n_convs,
                 nconv, scr, taps);
        }
        dmel::cluster_sync();  // every CTA's a is written
        pull_rows(at, a_sm, KP, L.ra, W, rank, G);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // a's stores, seen by wgmma
        __syncthreads();
        dmel::mbar_wait(bar, nconv & 1);  // this conv's weights
        if ((parts & 2) && live) {
          if (half) {
            conv_tc<N, true>(a_sm, L.ra, w_sm, dst, L.lw, bias, n_convs, nconv, C, KP, W, k, d);
          } else {
            conv_tc<N, false>(a_sm, L.ra, w_sm, dst, L.lw, bias, n_convs, nconv, C, KP, W, k, d);
          }
        }
        woff += static_cast<long long>(k) * KP * N;
        ++nconv;
        dmel::cluster_sync();  // every CTA's dst is written and its products are done
        if (tid == 0 && nconv < n_convs) {  // the next conv's weights, while its activation runs
          const int kn = half && p == spec.n_dil[b] - 1 ? spec.k[b + 1] : k;
          const uint32_t bytes = 2u * kn * KP * N;
          dmel::mbar_expect_tx(bar, bytes);
          dmel::bulk_load(w_sm, w + woff, bytes, bar);
        }
        // the next activation's input halo (xb after a block's last pair is reloaded instead)
        if (!half || p < spec.n_dil[b] - 1) pull_cols(dst, base + (half ? L.xb : L.tp), C, L.lw, W, rank, G);
        __syncthreads();
      }
    }
    // the running sum of the blocks over the stored columns (float32 in
    // acc_g), the mean into out at the last block
    for (int i = tid; i < C * W; i += TC_NT) {
      const int c = i / W, j = i - c * W;
      const int g = gW + j;
      if (g < coff || g >= coff + nc) continue;
      const long long idx = plane + static_cast<long long>(c) * T + wlo + g;
      const float v = xb[c * L.lw + TC_XH + j];
      if (b == spec.n_blk - 1) {
        out[idx] = __float2bfloat16((b == 0 ? v : acc_g[idx] + v) * scale);
      } else {
        acc_g[idx] = b == 0 ? v : acc_g[idx] + v;
      }
    }
    __syncthreads();
  }
  dmel::cluster_sync();  // no CTA leaves while a peer may still read its shared memory
}

template <int N>
int launch_v1_tc(const void* x, const void* w, const float* bias, const float* alpha, const float* inv_beta,
                 void* out, float* acc, int B, int C, int T, int W, int R, int KP, int G, int parts,
                 const V1Spec& spec, const dmel::Taps& tp, cudaStream_t stream, int* config) {
  int kmax = 0;
  for (int b = 0; b < spec.n_blk; ++b) kmax = spec.k[b] > kmax ? spec.k[b] : kmax;
  const V1TcLayout l = v1tc_layout(C, KP, N, W, kmax);
  const int S = G * W - 2 * R;
  if (l.total > static_cast<uint32_t>(SMEM) || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stage_v1_tc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((T + S - 1) / S * G), static_cast<unsigned>(B));
  cfg.blockDim = dim3(TC_NT);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(G);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (config != nullptr) {
    config[0] = static_cast<int>(cfg.gridDim.x);
    config[1] = static_cast<int>(cfg.gridDim.y);
    config[2] = TC_NT;
    config[3] = static_cast<int>(l.total);
    config[4] = G;
    config[5] = W;
  }
  err = cudaLaunchKernelEx(&cfg, stage_v1_tc_kernel<N>, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(w), bias, alpha, inv_beta,
                           static_cast<__nv_bfloat16*>(out), acc, C, T, W, R, KP, kmax, parts, spec, tp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int make_spec(V1Spec& spec, int n_blk, const int* ks, const int* n_dils, const int* dils, int max_d) {
  if (n_blk < 1 || n_blk > MAXB || max_d < 1 || max_d > MAXD) return 1;
  spec.n_blk = n_blk;
  for (int b = 0; b < n_blk; ++b) {
    if (n_dils[b] < 1 || n_dils[b] > max_d || ks[b] < 1 || ks[b] % 2 == 0) return 1;
    spec.k[b] = ks[b];
    spec.n_dil[b] = n_dils[b];
    for (int p = 0; p < n_dils[b]; ++p) spec.dil[b][p] = dils[b * max_d + p];
  }
  return 0;
}

}  // namespace

// Floats of shared memory a float32 block needs besides the planes.
extern "C" int dmel_stage_v1_scratch_floats() { return SCR; }

// Bytes of shared memory a block may use in all; the wrapper plans W from it.
extern "C" int dmel_stage_v1_smem_bytes() { return SMEM; }

// One whole float32 stage on [B, C, T] planes (contiguous) on the CUDA
// cores. wt: the stage's convs one after another, each [k][C_in][CP] (CP =
// C rounded up to 8, zero-filled). bias, alpha (exp'd), inv_beta: float32
// [C][n_convs]. ks / n_dils / dils (row stride max_d) describe the
// resblocks. W: columns stored per block; R: halo per side; PAD: the widest
// conv reach; ci_chunk: input channels per weight chunk (k_max * ci_chunk *
// CP floats must fit the scratch). parts: 3 the stage; the breakdown probe
// (probes/stage_parts.py) drops the activations (2), the convs (1) or both
// (0). Returns the first CUDA error (0 = launched).
extern "C" int dmel_stage_v1(const float* x, const float* wt, const float* bias, const float* alpha,
                             const float* inv_beta, float* out, int B, int C, int T, int W, int R, int PAD,
                             int ci_chunk, int n_blk, const int* ks, const int* n_dils, const int* dils, int max_d,
                             const float* taps, int parts, void* stream) {
  V1Spec spec;
  if (make_spec(spec, n_blk, ks, n_dils, dils, max_d) || W < 1 || ci_chunk < 1 || parts < 0 || parts > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const size_t floats = static_cast<size_t>(SCR) +
                        static_cast<size_t>(C) * (3 * (W + 2 * R) + 2 * PAD + W);
  const size_t bytes = floats * sizeof(float);
  if (bytes > static_cast<size_t>(SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stage_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + W - 1) / W, B);
  stage_v1_kernel<<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, wt, bias, alpha, inv_beta, out, C, T, W, R, PAD, ci_chunk, parts, spec, tp);
  return static_cast<int>(cudaGetLastError());
}

// One whole bf16 stage on [B, C, T] planes (contiguous) on the tensor
// cores, v1 contract. w: the stage's convs one after another in
// ops/stage_fused.tc_weights' layout ([k][KP / 8][N][8] bf16 each, one N
// block), N in {24, 32, 48} >= C, KP = C rounded up to 16. acc: a float32
// [B, C, T] scratch for the running sum. bias, alpha (exp'd), inv_beta:
// float32 [C][n_convs]; taps float32. W: columns a CTA owns (a multiple of
// 256 up to 1024); R: the stage's reach per side; G: CTAs per cluster (at
// most 8); every conv's reach at most 32. parts as dmel_stage_v1. config, if
// not null, receives 6 ints: grid x, grid y, threads, shared memory per
// block, cluster size, W. Returns the first CUDA error (0 = launched).
extern "C" int dmel_stage_v1_tc(const void* x, const void* w, const float* bias, const float* alpha,
                                const float* inv_beta, void* out, float* acc, int N, int KP, int B, int C, int T,
                                int W, int R, int G, int n_blk, const int* ks, const int* n_dils, const int* dils,
                                int max_d, const float* taps, int parts, int* config, void* stream) {
  V1Spec spec;
  if (make_spec(spec, n_blk, ks, n_dils, dils, max_d) || C < 1 || C > N || KP < C || KP % 16 || B < 1 ||
      B > 65535 || T < 1 || W < 256 || W % 256 || W > 1024 || G < 1 || G > 8 || R < 0 || parts < 0 || parts > 3 ||
      reinterpret_cast<uintptr_t>(w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int b = 0; b < n_blk; ++b) {
    for (int p = 0; p < spec.n_dil[b]; ++p) {
      if (spec.dil[b][p] * (spec.k[b] - 1) / 2 > TC_PA) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 24: return launch_v1_tc<24>(x, w, bias, alpha, inv_beta, out, acc, B, C, T, W, R, KP, G, parts, spec, tp, s, config);
    case 32: return launch_v1_tc<32>(x, w, bias, alpha, inv_beta, out, acc, B, C, T, W, R, KP, G, parts, spec, tp, s, config);
    case 48: return launch_v1_tc<48>(x, w, bias, alpha, inv_beta, out, acc, B, C, T, W, R, KP, G, parts, spec, tp, s, config);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
