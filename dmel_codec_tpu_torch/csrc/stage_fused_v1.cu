// K2-v1: a whole BigVGAN AMP resblock stage in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `fused_amp_stage`
// (dmel_codec_tpu/ops/stage_fused.py, `use_v2=False`): for k in (3, 7, 11):
// xb = x; for d in (1, 3, 5): xb += conv_{k,1}(act(conv_{k,d}(act(xb))));
// out = mean of the three xb. What sets it apart from K2 (stage_fused.cu,
// one launch per act -> conv pair, planes through device memory in the
// input dtype) is that the whole chain of one time tile stays in shared
// memory in float32 and is rounded once, at the store. ops/stage_fused.py
// amp_stage_v1 launches it once per stage; stage_reference_v1 is the plain
// PyTorch version.
//
// Bound on the H100: the C x C x k convs on the float32 CUDA cores, times
// the halo: a block that stores W columns computes W + 2 R of them
// (R = the stage's receptive field per side, 96 at the flagship spec), and
// shared memory decides W. Per column a block holds three float32 planes
// (xb, the conv input a, the conv output t) and, for the W stored columns,
// the running sum. At C = 48 that leaves W = 124 of 316 columns useful, at
// C = 24 W = 404 of 596; C = 96 does not fit, so the wrapper refuses
// C > 48 (V1_MAX_CHANNELS) and the serving vocoder sends those stages to K2.
//
// One block = one (time tile, batch row). Its window is the tile plus R
// columns per side, clipped to [0, T). The block treats the window as a
// signal of its own: activations replicate the window's first and last
// sample (and, as the reference chain does, the post-snake 2x signal),
// convs see zeros beyond it. Where the window ends at a true signal edge
// that is exactly the stage's edge rule; where it ends inside the signal
// the error it makes travels at most R columns and never reaches the
// stored tile. Every output goes through the same sequence of float
// operations wherever its tile lies, so a run on a slice of the signal
// gives the same bits as the full run beyond R samples from the cut.
//
// Activation: a warp takes (channel, segment of 122 outputs): both snake
// phases at the 128 half-rate indices the segment needs into the warp's
// scratch, then the down FIR; no block barrier inside an activation. Its
// output is rounded to the input dtype (the conv's operand rounding) and
// written into the zero-bordered plane a.
// Conv: a warp takes (8 output channels, 64 columns), each thread 8 x 2
// accumulators; input channels stream through shared memory in chunks
// (weights pre-transposed to [k][C_in][C_out8] by the wrapper, so a chunk
// is one contiguous copy and a thread's 8 weights are two float4
// broadcasts). The last conv of a pair adds into xb in place.
//
// Numeric contract (stage_fused.py:145-149, 253-268, 297): input cast to
// float32; activations float32 with sinf; conv operands (plane and weight)
// rounded to the input dtype, accumulated in float32, bias float32;
// residual spine and running sum float32; one cast at the store. For
// float32 input that is exactly the oracle.
#include "common.cuh"

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
                          int n_convs, int nconv, float* scr, dmel::Taps tp, int bf16) {
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
        dst[c * dst_stride + s0 + i] = dmel::round_to(dmel::down(ve + i, vo + i, tp), bf16);
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
                           const void* wt, int w_bf16, const float* bias, int n_convs,
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
            dmel::load_f(wt, static_cast<long long>(tap * C + ci0) * CP + r, w_bf16);
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
stage_v1_kernel(const void* __restrict__ x, const void* __restrict__ wt,
                const float* __restrict__ bias, const float* __restrict__ alpha,
                const float* __restrict__ inv_beta, void* __restrict__ out, int bf16,
                int C, int T, int W, int R, int PAD, int ci_chunk, V1Spec spec,
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
      xb[c * Wf + j] = dmel::load_f(x, plane + static_cast<long long>(c) * T + wlo + j, bf16);
    }
    __syncthreads();
    for (int p = 0; p < spec.n_dil[b]; ++p) {
      const long long wsz = static_cast<long long>(k) * C * CP;
      const void* w1 = bf16 ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(wt) + woff)
                            : static_cast<const void*>(static_cast<const float*>(wt) + woff);
      const void* w2 = bf16 ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(wt) + woff + wsz)
                            : static_cast<const void*>(static_cast<const float*>(wt) + woff + wsz);
      act_plane(xb, Wf, a0, Wa, C, n, alpha, inv_beta, n_convs, nconv, scr, taps, bf16);
      // (conv_plane starts with a block barrier)
      conv_plane<false>(a0, Wa, tp, Wf, w1, bf16, bias, n_convs, nconv, C, CP, n, k,
                        spec.dil[b][p], ci_chunk, scr);
      __syncthreads();
      act_plane(tp, Wf, a0, Wa, C, n, alpha, inv_beta, n_convs, nconv + 1, scr, taps, bf16);
      conv_plane<true>(a0, Wa, xb, Wf, w2, bf16, bias, n_convs, nconv + 1, C, CP, n, k, 1,
                       ci_chunk, scr);
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
    dmel::store_f(out, plane + static_cast<long long>(c) * T + t0 + j, acc[c * W + j] * scale, bf16);
  }
}

}  // namespace

// Floats of shared memory a block needs besides the planes.
extern "C" int dmel_stage_v1_scratch_floats() { return SCR; }

// Bytes of shared memory a block may use in all; the wrapper plans W from it.
extern "C" int dmel_stage_v1_smem_bytes() { return SMEM; }

// One whole stage on [B, C, T] planes (contiguous; float32 or bfloat16 by
// `bf16`, weights in the same type). wt: the stage's convs one after
// another, each [k][C_in][CP] (CP = C rounded up to 8, zero-filled). bias,
// alpha (exp'd), inv_beta: float32 [C][n_convs]. ks / n_dils / dils (row
// stride max_d) describe the resblocks. W: columns stored per block; R:
// halo per side; PAD: the widest conv reach; ci_chunk: input channels per
// weight chunk (k_max * ci_chunk * CP floats must fit the scratch).
// Returns the first CUDA error (0 = launched).
extern "C" int dmel_stage_v1(const void* x, const void* wt, const float* bias,
                             const float* alpha, const float* inv_beta, void* out, int bf16,
                             int B, int C, int T, int W, int R, int PAD, int ci_chunk,
                             int n_blk, const int* ks, const int* n_dils, const int* dils,
                             int max_d, const float* taps, void* stream) {
  if (n_blk < 1 || n_blk > MAXB || max_d > MAXD || W < 1 || ci_chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  V1Spec spec;
  spec.n_blk = n_blk;
  for (int b = 0; b < n_blk; ++b) {
    if (n_dils[b] < 1 || n_dils[b] > max_d) return static_cast<int>(cudaErrorInvalidValue);
    spec.k[b] = ks[b];
    spec.n_dil[b] = n_dils[b];
    for (int p = 0; p < n_dils[b]; ++p) spec.dil[b][p] = dils[b * max_d + p];
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
      x, wt, bias, alpha, inv_beta, out, bf16, C, T, W, R, PAD, ci_chunk, spec, tp);
  return static_cast<int>(cudaGetLastError());
}
