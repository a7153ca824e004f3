// K1: fused anti-aliased snake / snakebeta activation, channels-first.
//
// Replaces the Pallas TPU kernel `_kernel` / `_fused_forward`
// (dmel_codec_tpu/ops/anti_alias.py, launched from
// fused_anti_alias_activation). Same function, exact at both edges; the
// plain PyTorch version is ops/anti_alias.py anti_alias_activation_reference.
//
// Bound on the H100: by bytes on paper (one element read and one written
// per sample, 2 B each in bf16: 0.044 ms at s1 [16, 384, 5952]), by
// instruction issue in practice: per output sample two 6-tap up FIRs (14
// instructions), two sinf (about 18 each), the snakes (6) and a 12-tap down
// FIR (18, in the order `acc += f e + f o` compiles to), about 90 issued
// instructions with the halo and the shuffles (about 100 on the SASS), so
// 36.6 M samples at s1 take at least about 0.11 ms of the 132 SMs' 4 schedulers
// (probes/k1_floor.py counts it from the SASS). The TPU kernel ran the FIRs
// as banded matmuls on the MXU and a fitted polynomial sin because the
// VPU's sin was slow; here the FIRs are 6-tap FMA chains and sin is sinf's.
//
// Design (the earlier one-block-per-512-outputs design spent 3x the byte
// bound on a pure copy and redid the coefficients per 512 outputs): warps
// walk tasks of 256-output units of a row with 16-byte accesses and
// register windows, the down FIR a unit late (snake_units.cuh, shared with
// the probe P1). A task is up to 8 units (fewer when the launch is small,
// so that every resident warp has two tasks), with as many blocks as the
// card holds at once (3 of 256 threads per SM, 80 registers a thread). A
// block computes every channel's coefficients once, into shared memory; no
// block barrier after them. Every output has the bits of the earlier design
// (checked on the card against it, and sin_reduced against sinf over every
// float, by chip_smoke.py).
//
// Arithmetic in float32, output in the input dtype (float32 or bfloat16);
// on bf16 input the taps come rounded to bf16 from the wrapper and v is
// rounded to bf16 before the down FIR, the two rounding points of the JAX
// kernel's bf16 banded matmuls (ops/anti_alias.py:317-372). The snake's
// per-channel coefficients, alpha and 1 / (beta + eps) (exp'd under
// logscale), are computed in the parameters' dtype as the JAX op computes
// them before its kernel (ops/anti_alias.py:607-612): with bf16 parameters
// each step is rounded to bf16, so no launch before the kernel is needed to
// prepare them.
#include "snake_units.cuh"

namespace {

using namespace dmel::units;

constexpr int MAX_SEGU = 8;  // units a warp walks in one task, at most

// K1: each block computes every channel's snake coefficients once, into
// shared memory, then its warps walk their tasks (snake_units.cuh) with the
// exact edges and, on bf16 x, v rounded to bf16.
template <int V, bool BF16>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
anti_alias_kernel(const void* __restrict__ x, void* __restrict__ y, const float* __restrict__ alpha,
                  const float* __restrict__ beta, int logscale, int param_bf16, int C, int n_rows, Plan pl,
                  dmel::Taps taps) {
  // the snake's coefficients of every channel, once per block: snake: gain
  // 1/alpha; snakebeta: gain 1/beta (both exp'd under logscale); with bf16
  // parameters the exps, the sum and the quotient are each rounded to bf16
  extern __shared__ float coef[];  // [C] alpha, then [C] 1 / (beta + eps)
  if (V == FULL || V == NO_FIR) {
    for (int c = threadIdx.x; c < C; c += THREADS) {
      float g = beta != nullptr ? beta[c] : alpha[c];
      float a = alpha[c];
      if (logscale) {
        a = expf(a);
        g = expf(g);
      }
      coef[c] = dmel::round_to(a, param_bf16);
      g = dmel::round_to(g, param_bf16);
      coef[C + c] = dmel::round_to(1.f / dmel::round_to(g + 1e-9f, param_bf16), param_bf16);
    }
    __syncthreads();
  }
  walk<V, BF16, true, BF16>(x, y, coef, coef + C, C, n_rows, pl, taps);
}

template <int V, bool BF16>
int launch(const void* x, void* y, const float* alpha, const float* beta, int logscale, int param_bf16, int B,
           int C, int T, const float* taps, void* stream, int* config) {
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  Plan pl = make_plan(x, y, T, BF16 ? 2 : 4);
  const long long n_rows = static_cast<long long>(B) * C;
  const long long n_work = n_rows * pl.n_units;
  if (n_rows >= MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  static const long long cap = resident_blocks(anti_alias_kernel<V, BF16>, 8 * 1024);
  // units per task: as many as keep two tasks per resident warp, up to 8
  // (a long segment saves halo steps, a short one keeps small launches wide)
  const long long per_warp = n_work / (2 * cap * WARPS);
  pl.segu = static_cast<int>(per_warp < 1 ? 1 : (per_warp > MAX_SEGU ? MAX_SEGU : per_warp));
  const int grid = grid_of(pl, n_rows, cap);
  if (config != nullptr) {
    config[0] = grid;
    config[1] = THREADS;
    config[2] = (V == FULL || V == NO_FIR) ? 8 * C : 0;
    config[3] = pl.n_units;
    config[4] = pl.lead;
    config[5] = pl.vec;
    config[6] = pl.segu;
  }
  const size_t smem = (V == FULL || V == NO_FIR) ? 8 * static_cast<size_t>(C) : 0;  // the coefficients
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  anti_alias_kernel<V, BF16><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, alpha, beta, logscale, param_bf16, C, static_cast<int>(n_rows), pl, tp);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_v(const void* x, void* y, const float* alpha, const float* beta, int logscale, int param_bf16, int B,
             int C, int T, int bf16, const float* taps, void* stream, int* config) {
  return bf16 ? launch<V, true>(x, y, alpha, beta, logscale, param_bf16, B, C, T, taps, stream, config)
              : launch<V, false>(x, y, alpha, beta, logscale, param_bf16, B, C, T, taps, stream, config);
}

}  // namespace

// Counts the floats x with |x| < 105615 where |sin_reduced(x)| and
// |sinf(x)| differ in any bit (all 2^32 patterns are visited): K1's
// self-check that its sinf without conversions is sinf up to the sign.
__global__ void sin_check_kernel(unsigned long long* bad) {
  unsigned long long n = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32); i += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(i));
    if (fabsf(x) < 105615.f && (__float_as_uint(sin_reduced(x)) ^ __float_as_uint(sinf(x))) & 0x7fffffffu) ++n;
  }
  if (n) atomicAdd(bad, n);
}

extern "C" const char* dmel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: [B, C, T] contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// alpha, beta: [C] float32 on the device, the parameters' values (bf16
// ones when param_bf16 = 1); beta == nullptr selects snake.
// taps: 12 host floats (bf16 values when bf16 = 1; the kernel rounds v
// then). The kernel uses 16-byte accesses where x and y share their
// 16-byte phase, element by element throughout otherwise. config, if not
// null, receives 7 ints: grid, threads, shared memory per block, units per
// row, lead, vec and units per task as launched. Returns cudaGetLastError() after the launch.
extern "C" int dmel_anti_alias(const void* x, void* y, const float* alpha, const float* beta, int logscale,
                               int param_bf16, int B, int C, int T, int bf16, const float* taps, int* config,
                               void* stream) {
  return launch_v<FULL>(x, y, alpha, beta, logscale, param_bf16, B, C, T, bf16, taps, stream, config);
}

// bad: one zeroed unsigned 64-bit count on the device; receives the
// mismatches of sin_reduced against sinf over every float.
extern "C" int dmel_sin_check(unsigned long long* bad, void* stream) {
  sin_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(bad);
  return static_cast<int>(cudaGetLastError());
}

// The ablation probe's entry: the same launch with parts of the kernel
// removed. variant: 0 full, 1 copy, 2 no_snake, 3 no_fir.
extern "C" int dmel_anti_alias_variant(const void* x, void* y, const float* alpha, const float* beta, int logscale,
                                       int param_bf16, int B, int C, int T, int bf16, const float* taps, int variant,
                                       void* stream) {
  const int pb = param_bf16;
  switch (variant) {
    case FULL: return launch_v<FULL>(x, y, alpha, beta, logscale, pb, B, C, T, bf16, taps, stream, nullptr);
    case COPY: return launch_v<COPY>(x, y, alpha, beta, logscale, pb, B, C, T, bf16, taps, stream, nullptr);
    case NO_SNAKE: return launch_v<NO_SNAKE>(x, y, alpha, beta, logscale, pb, B, C, T, bf16, taps, stream, nullptr);
    case NO_FIR: return launch_v<NO_FIR>(x, y, alpha, beta, logscale, pb, B, C, T, bf16, taps, stream, nullptr);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
