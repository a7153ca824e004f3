// Shared device helpers for the anti-aliased snake activation (K1,
// anti_alias.cu) and the fused AMP stage (K2, stage_fused_tc.cu and
// stage_fused_tf32.cu; K2-v1, stage_fused_v1.cu).
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
//
// bf16 contract (K1 on bf16 x; K2's v2 contract on bf16 planes): the
// caller passes the taps rounded to bf16 (the factor 2 stays exact) and
// sets round_v; float32 and K2's v1 contract keep float32 taps and v.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// v[0..3] += p[i .. i + 3], p float32 (16-byte aligned at i) or bf16 (8-byte).
__device__ __forceinline__ void add4(float (&v)[4], const void* p, long long i, int bf16) {
  if (bf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    v[0] += __low2float(lo);
    v[1] += __high2float(lo);
    v[2] += __low2float(hi);
    v[3] += __high2float(hi);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    v[0] += f.x;
    v[1] += f.y;
    v[2] += f.z;
    v[3] += f.w;
  }
}

// p[i .. i + 3] = v, as add4's types and alignment.
__device__ __forceinline__ void store4(void* p, long long i, const float (&v)[4], int bf16) {
  if (bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = make_float4(v[0], v[1], v[2], v[3]);
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
// round_v rounds the snake's output v to bf16 before the down FIR reads it
// (the bf16 contract of the JAX kernels, which store v in the plane dtype).
__device__ __forceinline__ void snake_phases(const float* xs, int base, int s, int T,
                                             Taps tp, float alpha, float inv_beta,
                                             int round_v, float& e, float& o) {
  if (s < 0) {
    e = o = round_to(snake(up_even(xs, base, 0, tp), alpha, inv_beta), round_v);
  } else if (s >= T) {
    e = o = round_to(snake(up_odd(xs, base, T - 1, tp), alpha, inv_beta), round_v);
  } else {
    e = round_to(snake(up_even(xs, base, s, tp), alpha, inv_beta), round_v);
    o = round_to(snake(up_odd(xs, base, s, tp), alpha, inv_beta), round_v);
  }
}

// Down FIR at output t; e / o point at v_e[t-3] / v_o[t-3].
__device__ __forceinline__ float down(const float* e, const float* o, Taps tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i + 1] * e[i + 1] + tp.f[2 * i] * o[i];
  return acc;
}

// up_even / up_odd (the same sums in the same order) on a register window
// w[j] = x at the time of position q + j - 5 (even: q + 5 - i, odd: q + 6 - i).
template <int W>
__device__ __forceinline__ float up_even_w(const float (&w)[W], int q, const Taps& tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i + 1] * w[q + 5 - i];
  return 2.f * acc;
}

template <int W>
__device__ __forceinline__ float up_odd_w(const float (&w)[W], int q, const Taps& tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i] * w[q + 6 - i];
  return 2.f * acc;
}

// down (the same sum in the same order) at output q of register windows
// e[j] = v_e at q + j - 2, o[j] = v_o at q + j - 3 (relative to output q = 0).
template <int W>
__device__ __forceinline__ float down_w(const float (&e)[W], const float (&o)[W], int q, const Taps& tp) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += tp.f[2 * i + 1] * e[q + i] + tp.f[2 * i] * o[q + i];
  return acc;
}

}  // namespace dmel
