// K2, float32: one fused act -> conv step of a BigVGAN AMP resblock stage
// on the CUDA cores. The bf16 steps run on the tensor cores
// (stage_fused_tc.cu); ops/stage_fused.py picks the kernel by dtype, as the
// JAX kernel runs bf16 convs on the matrix unit and float32 at HIGHEST.
//
// Replaces the Pallas TPU kernel `_kernel_v2` / `fused_amp_stage_v2`
// (dmel_codec_tpu/ops/stage_fused.py), which runs a whole upsample stage —
// for k in (3, 7, 11): xb = x; for d in (1, 3, 5):
// xb += conv_{k,1}(act(conv_{k,d}(act(xb)))); out = mean of the three xb —
// in one pass. ops/stage_fused.py amp_stage drives this kernel 18 times per
// float32 stage (one launch per act -> conv pair); act_conv_reference is the
// plain PyTorch version of one launch, stage_reference of the 18.
//
// Bound on the H100: the C x C x k convs. At the flagship C = 192 a stage is
// ~1.8 TFLOP (18 convs, mean k = 7) against ~0.1 GB of plane traffic per
// launch, so it is compute-bound; float32 runs the conv on the CUDA cores
// (register-tiled FMA from shared memory).
//
// Why one launch per pair and not per stage: the stage's receptive field is
// 96 samples per side, so a whole-stage block holding a time tile of W with
// its halo needs (W + 192) * C * 4 bytes per plane — several planes do not
// fit the 227 KB of shared memory at C = 96 or 192. A pair reaches only
// d*(k-1)/2 + 5 <= 30 samples per side, so each launch tiles freely: the
// activation runs fused in the conv's prologue (the 2x signal and the
// activation output stay in shared memory), and the epilogue adds bias,
// the residual and the running mean. Between launches the planes go
// through device memory (mostly the 50 MB L2).
//
// Block: TT = 128 outputs x CO_T output channels, 8 * CO_T threads, each
// accumulating 4 channels x 4 samples (stride 32, so a warp's shared-memory
// reads are consecutive). Input channels stream through shared memory in
// chunks of CI = 16: input window -> both snake phases -> activation
// (zero outside [0, T), the conv's zero padding) -> FMA over (ci, tap).
//
// Float32 throughout: the v1 and v2 contracts are the same function here
// (they differ only in where bf16 planes are rounded).
#include "common.cuh"

namespace {

constexpr int TT = 128;  // outputs per block along time
constexpr int CI = 16;   // input channels per shared-memory chunk
constexpr int XH = 8;    // input halo beyond the activation window

template <int CO_T>
__global__ void __launch_bounds__(8 * CO_T)
act_conv_kernel(const float* __restrict__ src, const float* __restrict__ w,
                const float* __restrict__ bias, int bias_stride,
                const float* __restrict__ alpha, const float* __restrict__ inv_beta,
                int ab_stride, const float* res, const float* acc_in, float* out,
                float scale, int C, int T, int k, int d, dmel::Taps taps) {
  constexpr int NT = 8 * CO_T;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int P = d * (k - 1) / 2;  // conv reach per side
  const int LA = TT + 2 * P;      // activation window = conv input
  const int LV = LA + 6;          // half-rate snake window
  const int LX = LA + 2 * XH;     // input window
  float* xs = smem;               // [CI][LX]
  float* ve = xs + CI * LX;       // [CI][LV]
  float* vo = ve + CI * LV;       // [CI][LV]
  float* as = vo + CI * LV;       // [CI][LA]
  float* ws = as + CI * LA;       // [CI][k][CO_T]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;  // 4 output channels each
  const int t0 = blockIdx.x * TT;
  const int co0 = blockIdx.y * CO_T;
  const long long plane = static_cast<long long>(blockIdx.z) * C * T;
  const int abase = t0 - P;     // time of as[.][0]
  const int vbase = abase - 3;  // time of ve / vo[.][0]
  const int xbase = abase - XH; // time of xs[.][0]

  float acc[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[c][q] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += CI) {
    const int nci = min(CI, C - ci0);
    __syncthreads();  // the previous chunk's readers are done

    for (int i = tid; i < CI * LX; i += NT) {
      const int ci = i / LX;
      float v = 0.f;
      if (ci < nci) {
        const int t = dmel::clampi(xbase + i - ci * LX, 0, T - 1);
        v = src[plane + static_cast<long long>(ci0 + ci) * T + t];
      }
      xs[i] = v;
    }
    // ws[ci][j][co] = w[j][co0 + co][ci0 + ci]; w is [k][C_out][C_in]
    for (int i = tid; i < CI * k * CO_T; i += NT) {
      const int ci = i % CI;
      const int co = (i / CI) % CO_T;
      const int j = i / (CI * CO_T);
      float v = 0.f;
      if (ci < nci && co0 + co < C) {
        v = w[(static_cast<long long>(j) * C + co0 + co) * C + ci0 + ci];
      }
      ws[(ci * k + j) * CO_T + co] = v;
    }
    __syncthreads();

    for (int i = tid; i < CI * LV; i += NT) {
      const int ci = i / LV;
      float e = 0.f, o = 0.f;
      if (ci < nci) {
        const int c = ci0 + ci;
        dmel::snake_phases(xs + ci * LX, xbase, vbase + i - ci * LV, T, taps,
                           alpha[c * ab_stride], inv_beta[c * ab_stride], 0, e, o);
      }
      ve[i] = e;
      vo[i] = o;
    }
    __syncthreads();

    for (int i = tid; i < CI * LA; i += NT) {
      const int ci = i / LA;
      const int r = i - ci * LA;
      const int t = abase + r;
      float v = 0.f;
      if (ci < nci && t >= 0 && t < T) {
        v = dmel::down(ve + ci * LV + r, vo + ci * LV + r, taps);
      }
      as[i] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < nci; ++ci) {
      const float* arow = as + ci * LA + tx;
      const float* wrow = ws + ci * k * CO_T + ty * 4;
      for (int j = 0; j < k; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(wrow + j * CO_T);
        const float* ap = arow + j * d;
        const float a[4] = {ap[0], ap[32], ap[64], ap[96]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0][q] += wv.x * a[q];
          acc[1][q] += wv.y * a[q];
          acc[2][q] += wv.z * a[q];
          acc[3][q] += wv.w * a[q];
        }
      }
    }
  }

  // epilogue: out = scale * (conv + bias [+ res] [+ acc_in])
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int co = co0 + ty * 4 + c;
    if (co >= C) continue;
    const float b = bias[co * bias_stride];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = t0 + tx + 32 * q;
      if (t >= T) continue;
      const long long idx = plane + static_cast<long long>(co) * T + t;
      float v = acc[c][q] + b;
      if (res != nullptr) v += res[idx];
      if (acc_in != nullptr) v += acc_in[idx];
      out[idx] = v * scale;
    }
  }
}

template <int CO_T>
int launch(const float* src, const float* w, const float* bias, int bias_stride,
           const float* alpha, const float* inv_beta, int ab_stride, const float* res,
           const float* acc_in, float* out, float scale, int B, int C, int T, int k, int d,
           dmel::Taps tp, cudaStream_t stream) {
  const int P = d * (k - 1) / 2;
  const int LA = TT + 2 * P;
  const size_t floats =
      static_cast<size_t>(CI) * ((LA + 2 * XH) + 2 * (LA + 6) + LA) +
      static_cast<size_t>(CI) * k * CO_T;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      act_conv_kernel<CO_T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + TT - 1) / TT, (C + CO_T - 1) / CO_T, B);
  act_conv_kernel<CO_T><<<grid, 8 * CO_T, bytes, stream>>>(
      src, w, bias, bias_stride, alpha, inv_beta, ab_stride, res, acc_in, out, scale, C, T,
      k, d, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One float32 act -> conv step on [B, C, T] planes (all contiguous, same
// shape):  out = scale * (conv_{k,d}(act(src)) + bias [+ res] [+ acc_in])
// w: [k][C][C] (tap, out, in). bias, alpha (exp'd), inv_beta: columns read
// as p[c * stride]. res and acc_in may be null; out may alias res or acc_in
// (each element is read before it is written, by the same thread). co_tile
// in {24, 48, 64} picks the instantiation. Returns cudaGetLastError() after
// the launch.
extern "C" int dmel_act_conv(const float* src, const float* w, const float* bias,
                             int bias_stride, const float* alpha, const float* inv_beta,
                             int ab_stride, const float* res, const float* acc_in, float* out,
                             float scale, int B, int C, int T, int k, int d, int co_tile,
                             const float* taps, void* stream) {
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DMEL_LAUNCH(N)                                                                  \
  return launch<N>(src, w, bias, bias_stride, alpha, inv_beta, ab_stride, res, acc_in,  \
                   out, scale, B, C, T, k, d, tp, s)
  switch (co_tile) {
    case 24: DMEL_LAUNCH(24);
    case 48: DMEL_LAUNCH(48);
    case 64: DMEL_LAUNCH(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DMEL_LAUNCH
}
