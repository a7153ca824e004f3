// K1: fused anti-aliased snake / snakebeta activation, channels-first.
//
// Replaces the Pallas TPU kernel `_kernel` / `_fused_forward`
// (dmel_codec_tpu/ops/anti_alias.py, launched from
// fused_anti_alias_activation). Same function, exact at both edges; the
// plain PyTorch version is ops/anti_alias.py anti_alias_activation_reference.
//
// Bound on the H100: memory. Per sample it reads and writes one element
// (2 B each in bf16) and does ~40 flops plus two sinf, far below the card's
// flop/byte balance. The TPU kernel ran the FIRs as banded matmuls on the
// MXU and a fitted polynomial sin because the VPU's sin was slow; here the
// FIRs are 6-tap FMA chains and sin is the accurate sinf.
//
// Design: one block per (row = b*C + c, tile of TILE outputs); the row's
// time axis is contiguous, so loads and stores are coalesced. The block
// stages x[t0-8, t0+TILE+8) (replicate-clamped) in shared memory, computes
// both snake phases for half-rate indices [t0-3, t0+TILE+3) once each, then
// the down FIR. The 2x-rate signal never touches device memory and any T
// works without a tail patch. Arithmetic in float32, output in the input
// dtype (float32 or bfloat16); on bf16 input the taps come rounded to bf16
// from the wrapper and v is rounded to bf16 before the down FIR, the two
// rounding points of the JAX kernel's bf16 banded matmuls
// (ops/anti_alias.py:317-372). The snake's per-channel coefficients, alpha
// and 1 / (beta + eps) (exp'd under logscale), are computed in the
// parameters' dtype as the JAX op computes them before its kernel
// (ops/anti_alias.py:607-612): with bf16 parameters each step is rounded to
// bf16, so no launch before the kernel is needed to prepare them.
#include "common.cuh"

namespace {

constexpr int TILE = 512;
constexpr int THREADS = 256;
constexpr int XH = 8;  // input halo per side (the chain reaches 5)
constexpr int VH = 3;  // half-rate snake halo per side

// What the kernel computes: FULL is K1; the others are K1 with parts removed,
// for the ablation probe (probes/act_variants.py): COPY loads the tile and
// stores its centre, NO_SNAKE runs both FIRs around an identity, NO_FIR
// applies snake to the input with no filters.
enum Variant { FULL = 0, COPY = 1, NO_SNAKE = 2, NO_FIR = 3 };

template <int V>
__global__ void __launch_bounds__(THREADS)
anti_alias_kernel(const void* __restrict__ x, void* __restrict__ y,
                  const float* __restrict__ alpha, const float* __restrict__ beta,
                  int logscale, int param_bf16, int C, int T, int bf16, dmel::Taps taps) {
  __shared__ float xs[TILE + 2 * XH];
  __shared__ float ve[TILE + 2 * VH];
  __shared__ float vo[TILE + 2 * VH];

  const long long row = blockIdx.x;
  const int c = static_cast<int>(row % C);
  const int t0 = blockIdx.y * TILE;
  const long long off = row * static_cast<long long>(T);

  // snake: gain 1/alpha; snakebeta: gain 1/beta (both exp'd under logscale)
  float a = alpha[c];
  float g = beta != nullptr ? beta[c] : alpha[c];
  if (logscale) {
    a = expf(a);
    g = expf(g);
  }
  // with bf16 parameters the exps, the sum and the quotient are each rounded to bf16
  a = dmel::round_to(a, param_bf16);
  g = dmel::round_to(g, param_bf16);
  const float inv_beta = dmel::round_to(1.f / dmel::round_to(g + 1e-9f, param_bf16), param_bf16);

  const int xbase = t0 - XH;
  for (int i = threadIdx.x; i < TILE + 2 * XH; i += THREADS) {
    xs[i] = dmel::load_f(x, off + dmel::clampi(xbase + i, 0, T - 1), bf16);
  }
  __syncthreads();

  if (V == COPY || V == NO_FIR) {
    for (int i = threadIdx.x; i < TILE && t0 + i < T; i += THREADS) {
      const float v = xs[XH + i];
      dmel::store_f(y, off + t0 + i, V == COPY ? v : dmel::snake(v, a, inv_beta), bf16);
    }
    return;
  }

  for (int i = threadIdx.x; i < TILE + 2 * VH; i += THREADS) {
    float e, o;
    if (V == FULL) {
      dmel::snake_phases(xs, xbase, t0 - VH + i, T, taps, a, inv_beta, bf16, e, o);
    } else {  // NO_SNAKE: the same phases, rounding and edge rule around an identity
      const int s = t0 - VH + i;
      if (s < 0) {
        e = o = dmel::round_to(dmel::up_even(xs, xbase, 0, taps), bf16);
      } else if (s >= T) {
        e = o = dmel::round_to(dmel::up_odd(xs, xbase, T - 1, taps), bf16);
      } else {
        e = dmel::round_to(dmel::up_even(xs, xbase, s, taps), bf16);
        o = dmel::round_to(dmel::up_odd(xs, xbase, s, taps), bf16);
      }
    }
    ve[i] = e;
    vo[i] = o;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TILE && t0 + i < T; i += THREADS) {
    dmel::store_f(y, off + t0 + i, dmel::down(ve + i, vo + i, taps), bf16);
  }
}

template <int V>
int launch(const void* x, void* y, const float* alpha, const float* beta, int logscale,
           int param_bf16, int B, int C, int T, int bf16, const float* taps, void* stream) {
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(C),
                  static_cast<unsigned>((T + TILE - 1) / TILE));
  anti_alias_kernel<V><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, alpha, beta, logscale, param_bf16, C, T, bf16, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* dmel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: [B, C, T] contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// alpha, beta: [C] float32 on the device, the parameters' values (bf16
// ones when param_bf16 = 1); beta == nullptr selects snake.
// taps: 12 host floats (bf16 values when bf16 = 1; the kernel rounds v
// then). Returns cudaGetLastError() after the launch.
extern "C" int dmel_anti_alias(const void* x, void* y, const float* alpha,
                               const float* beta, int logscale, int param_bf16, int B, int C,
                               int T, int bf16, const float* taps, void* stream) {
  return launch<FULL>(x, y, alpha, beta, logscale, param_bf16, B, C, T, bf16, taps, stream);
}

// The ablation probe's entry: the same launch with parts of the kernel
// removed. variant: 0 full, 1 copy, 2 no_snake, 3 no_fir.
extern "C" int dmel_anti_alias_variant(const void* x, void* y, const float* alpha,
                                       const float* beta, int logscale, int param_bf16, int B,
                                       int C, int T, int bf16, const float* taps, int variant,
                                       void* stream) {
  const int pb = param_bf16;
  switch (variant) {
    case FULL: return launch<FULL>(x, y, alpha, beta, logscale, pb, B, C, T, bf16, taps, stream);
    case COPY: return launch<COPY>(x, y, alpha, beta, logscale, pb, B, C, T, bf16, taps, stream);
    case NO_SNAKE: return launch<NO_SNAKE>(x, y, alpha, beta, logscale, pb, B, C, T, bf16, taps, stream);
    case NO_FIR: return launch<NO_FIR>(x, y, alpha, beta, logscale, pb, B, C, T, bf16, taps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
