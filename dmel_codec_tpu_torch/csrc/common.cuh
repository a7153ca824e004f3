// Shared device helpers for the anti-aliased snake activation (K1,
// anti_alias.cu) and the fused AMP stage (K2, stage_fused.cu).
//
// The activation is the reference chain UpSample1d (replicate 5, 12-tap
// kaiser-sinc, x2) -> snake -> DownSample1d (replicate 5/6 of the
// POST-snake 2x signal, same FIR) in polyphase form, so the 2x-rate signal
// never leaves on-chip memory (derivation: dmel_codec_tpu/ops/anti_alias.py
// module docstring). With f the 12 taps and x replicate-clamped to [0, T):
//
//   u[2s]   = 2 * sum_i f[2i+1] * x[s+2-i]      (even phase, i = 0..5)
//   u[2s+1] = 2 * sum_i f[2i]   * x[s+3-i]      (odd phase)
//   v       = u + inv_beta * sin^2(alpha * u)
//   y[t]    = sum_i f[2i+1] * v_e[t+i-2] + f[2i] * v_o[t+i-3]
//
// Post-snake edges: v_e[s] = v_o[s] = v_e[0] for s < 0 and
// v_e[s] = v_o[s] = v_o[T-1] for s >= T, which is exactly the reference's
// replicate pad of the 2x signal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dmel {

struct Taps {
  float f[12];
};

__device__ __forceinline__ float load_f(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, long long i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Round to the storage type of the inter-op planes (identity for float32).
__device__ __forceinline__ float round_to(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// xs[i] holds x at time base + i, already replicate-clamped to [0, T).
__device__ __forceinline__ float up_even(const float* xs, int base, int s, Taps tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i + 1] * xs[s + 2 - i - base];
  return 2.f * acc;
}

__device__ __forceinline__ float up_odd(const float* xs, int base, int s, Taps tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i] * xs[s + 3 - i - base];
  return 2.f * acc;
}

__device__ __forceinline__ float snake(float u, float alpha, float inv_beta) {
  const float s = sinf(alpha * u);
  return u + inv_beta * s * s;
}

// Both snake phases at half-rate index s, with the post-snake edge rules.
// Reads xs at times s-3 .. s+3 (or 0-3 .. 2 / T-3 .. T+2 at the edges).
__device__ __forceinline__ void snake_phases(const float* xs, int base, int s, int T,
                                             Taps tp, float alpha, float inv_beta,
                                             float& e, float& o) {
  if (s < 0) {
    e = o = snake(up_even(xs, base, 0, tp), alpha, inv_beta);
  } else if (s >= T) {
    e = o = snake(up_odd(xs, base, T - 1, tp), alpha, inv_beta);
  } else {
    e = snake(up_even(xs, base, s, tp), alpha, inv_beta);
    o = snake(up_odd(xs, base, s, tp), alpha, inv_beta);
  }
}

// Down FIR at output t; e / o point at v_e[t-3] / v_o[t-3].
__device__ __forceinline__ float down(const float* e, const float* o, Taps tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i + 1] * e[i + 1] + tp.f[2 * i] * o[i];
  return acc;
}

}  // namespace dmel
