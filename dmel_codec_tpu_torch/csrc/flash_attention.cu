// FA: causal grouped-query flash attention, forward.
//
// Replaces the Pallas TPU kernel that `_flash_causal_attention`
// (dmel_codec_tpu/models/transformer.py) reaches through jax's
// pallas.ops.tpu.flash_attention. Same function; the plain PyTorch version
// is ops/flash_attention.py flash_attention_reference:
//
//   out[b, s, h, :] = softmax_{t <= s}(q[b, s, h, :] . k[b, t, h / g, :] / sqrt(hd))
//                     . v[b, t, h / g, :]          g = H / KH
//
// The JAX wrapper repeats K/V to full heads and zero-pads S to a multiple
// of 128 for the TPU's tiling; here a block indexes its KV head and masks
// the ragged last tile, so any S >= 1 runs as it is.
//
// Bound on the H100: operations. The two products do 4 * hd flops per
// (query, visible key) pair against a few bytes per query row, far above the
// card's flop/byte balance, so what matters is which unit runs them.
//
// bf16 (flash_attention_mma_kernel): both products on the tensor cores,
// mma.sync.m16n8k16 with float32 sums, as P4 (probes.cu) does. One block of
// 4 warps per (batch, head, tile of 64 queries), longest rows first; a warp
// owns 16 query rows, whose Q fragments it loads once (ldmatrix) and keeps
// in registers. K and V tiles of 64 keys stay bf16 in shared memory, staged
// with cp.async into two buffers, so the next tile's copy overlaps this
// tile's products. S = Q K^T lands in registers; the online softmax runs
// there (row max and sum across the 4 lanes of a quad, exp2 with the scale
// folded in); P is rounded to bf16 A fragments in registers (the JAX
// kernel's `p.astype(v.dtype)` before P V, flash_attention.py:471) and
// O += P V reads V through ldmatrix.trans. The row sum l is taken from the
// float32 P, as in the JAX kernel. K/V are read once per query head of a
// group (7 blocks share a KV head); the 512 KB of one batch's KV head stay
// in the 50 MB L2.
//
// float32 (flash_attention_tf32_kernel): float32 inputs keep float32-grade
// products, as the JAX float32 path does (one TF32 product would keep ~3
// digits), on the tensor cores: both products split-TF32 (each operand
// x = hi + lo, three mma.sync.m16n8k8 .tf32 products per tile, the layout
// and fragments in flash_common.cuh), about a third of the tensor cores'
// TF32 rate against the CUDA cores' 67 TFLOP/s. The bf16 kernel's layout: a
// block of 4 warps per (batch, head, tile of 64 queries), longest rows
// first, a warp per 16 query rows, the online softmax on the score tile in
// registers, masking on the diagonal tile only. Q stays float32 in shared
// memory and is split per k-step (one split feeds 8 key tiles of 8); each
// K and V tile is loaded by 16-byte loads and split once into hi and lo
// tiles, which every warp reads (87 KB of shared memory at hd 64: two
// blocks an SM, one's loads beside the other's products). P stays float32
// and is split like any operand (the bf16 path rounds it as jax does); its
// C fragments are the A fragments of P V with each 8 keys in the order
// {0, 2, 4, 6, 1, 3, 5, 7}. O += P V takes each key tile's products into a
// fresh accumulator added to O in float32 rounded to nearest: the tensor
// cores truncate their sums, and one accumulator over a whole row of keys
// would drift.
//
// Both: scores, softmax and accumulation are float32; the output is rounded
// once to the input dtype. For training the kernel also stores L = m +
// log(l) per row (float32): the backward kernels (flash_attention_bwd.cu)
// recompute P = exp(S - L) from it. The tiling constants, the tile loaders
// and the tensor-core helpers are in flash_common.cuh.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace dmel_flash;

// ---- float32: split-TF32 on the tensor cores -------------------------------

constexpr size_t tf32_smem_bytes(int HD) {  // Q, and the hi and lo tiles of K and V
  return sizeof(float) * 5 * 64 * (HD + 4);
}

template <int HD>
__global__ void __launch_bounds__(TF32_THREADS)
flash_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out,
                            float* __restrict__ lse, int S, int H, int KH, float scale) {
  constexpr int TS = HD + 4;  // float32 row stride of a shared tile
  constexpr int KS = HD / 8;  // k-steps over the head dimension
  constexpr int DT = HD / 8;  // 8-wide output column tiles
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Kh = Qs + 64 * TS;
  float* Kl = Kh + 64 * TS;
  float* Vh = Kl + 64 * TS;
  float* Vl = Vh + 64 * TS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;  // longest rows first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / (H / KH);
  const int n_tiles = q0 / 64 + 1;  // key tiles 0 .. diagonal
  const float sl2 = scale * LOG2E;  // exp(x * scale) = exp2(x * sl2)

  stage_tiles_f32<HD, 1, false>(Qs, nullptr, q, nullptr, nullptr, nullptr, b, S, H, h, q0);

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (l: this lane's part)
  const int row_lo = q0 + warp * 16 + lane / 4;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * 64;
    __syncthreads();  // every warp is done with tile j - 1 (and Q has landed)
    stage_tiles_f32<HD, 2, true>(Kh, Kl, k, Vh, Vl, v, b, S, KH, kh, n0);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 C tiles
    float sc[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) sc[jn][0] = sc[jn][1] = sc[jn][2] = sc[jn][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned qh[4], ql[4];
      lds_a_split(qh, ql, Qs, TS, warp * 16, 8 * ks);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        unsigned bh[2], bl[2];
        lds_bt(bh, Kh, TS, 8 * jn, 8 * ks);
        lds_bt(bl, Kl, TS, 8 * jn, 8 * ks);
        mma_split(sc[jn], qh, ql, bh, bl);
      }
    }

    // causal mask (the diagonal tile only), online softmax in the exp2 domain
    const bool diag = j == n_tiles - 1;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[jn][e] * sl2;
        if (diag && n0 + 8 * jn + 2 * t + (e & 1) > row_lo + 8 * (e >> 1)) x = -INFINITY;
        sc[jn][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);  // key n0 <= row is visible: finite
      corr[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[jn][e] - m[e >> 1]);  // exactly 0 where masked
        sc[jn][e] = p;
        l[e >> 1] += p;
      }
    }

    // O = corr O + P V: this tile's products into a fresh accumulator (the
    // tensor cores truncate their sums), added to O rounded to nearest; P
    // stays float32, split into hi and lo like any operand
    float of[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) of[dt][0] = of[dt][1] = of[dt][2] = of[dt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      unsigned ph[4], pl[4];
      c_to_a_split(ph, pl, sc[kk]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        unsigned bh[2], bl[2];
        lds_b_perm(bh, Vh, TS, 8 * kk, 8 * dt);
        lds_b_perm(bl, Vl, TS, 8 * kk, 8 * dt);
        mma_split(of[dt], ph, pl, bh, bl);
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] = __fadd_rn(__fmul_rn(o[dt][0], corr[0]), of[dt][0]);
      o[dt][1] = __fadd_rn(__fmul_rn(o[dt][1], corr[0]), of[dt][1]);
      o[dt][2] = __fadd_rn(__fmul_rn(o[dt][2], corr[1]), of[dt][2]);
      o[dt][3] = __fadd_rn(__fmul_rn(o[dt][3], corr[1]), of[dt][3]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / l[r];
    float* dst = out + ((b * S + row) * H + h) * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(dst + 8 * dt) = make_float2(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    if (lse != nullptr && t == 0) lse[(b * H + h) * S + row] = (m[r] + log2f(l[r])) * LN2;
  }
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int MMA_WARPS = 4;  // a warp per 16 query rows: 64 rows per block
constexpr int MMA_THREADS = 32 * MMA_WARPS;

constexpr size_t mma_smem_bytes(int HD) {  // Q, and two buffers each of K and V
  return sizeof(__nv_bfloat16) * 5 * 64 * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int S, int H, int KH, float scale) {
  constexpr int LD = HD + 8;  // bf16 row stride of a shared tile
  constexpr int KS = HD / 16; // k-steps over the head dimension
  constexpr int DT = HD / 8;  // 8-wide output column tiles
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + 64 * LD;  // [2][64][LD]
  __nv_bfloat16* Vs = Ks + 2 * 64 * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;  // longest rows first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / (H / KH);
  const int n_tiles = q0 / 64 + 1;  // key tiles 0 .. diagonal
  const float sl2 = scale * LOG2E;  // exp(x * scale) = exp2(x * sl2)

  stage_tile_bf16<HD, MMA_THREADS>(Qs, q, b, S, H, h, q0);
  stage_tile_bf16<HD, MMA_THREADS>(Ks, k, b, S, KH, kh, 0);
  stage_tile_bf16<HD, MMA_THREADS>(Vs, v, b, S, KH, kh, 0);
  cp_async_commit();

  unsigned qf[KS][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (l: this lane's part)
  const int row_lo = q0 + warp * 16 + g;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1's buffer
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_a(qf[kk], Qs, LD, warp * 16, kk * 16);
    }
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      stage_tile_bf16<HD, MMA_THREADS>(Ks + nb * 64 * LD, k, b, S, KH, kh, (j + 1) * 64);
      stage_tile_bf16<HD, MMA_THREADS>(Vs + nb * 64 * LD, v, b, S, KH, kh, (j + 1) * 64);
      cp_async_commit();
    }
    const __nv_bfloat16* Kt = Ks + (j & 1) * 64 * LD;
    const __nv_bfloat16* Vt = Vs + (j & 1) * 64 * LD;
    const int n0 = j * 64;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 C tiles
    float sc[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) sc[jn][0] = sc[jn][1] = sc[jn][2] = sc[jn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bk[4];
        ldsm_bt(bk, Kt, LD, jp * 16, kk * 16);
        mma_16816(sc[2 * jp], qf[kk], bk[0], bk[1]);
        mma_16816(sc[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // causal mask (the diagonal tile only), online softmax in the exp2 domain
    const bool diag = j == n_tiles - 1;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[jn][e] * sl2;
        if (diag && n0 + 8 * jn + 2 * t + (e & 1) > row_lo + 8 * (e >> 1)) x = -INFINITY;
        sc[jn][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);  // key n0 <= row is visible: finite
      corr[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[jn][e] - m[e >> 1]);  // exactly 0 where masked
        sc[jn][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned pa[4];
      c_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned bv[4];
        ldsm_b(bv, Vt, LD, kk * 16, dp * 16);
        mma_16816(o[2 * dp], pa, bv[0], bv[1]);
        mma_16816(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* dst = out + ((b * S + row) * H + h) * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    if (lse != nullptr && t == 0) lse[(b * H + h) * S + row] = (m[r] + log2f(l[r])) * LN2;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int KH, int bf16, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S + 63) / 64), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  if (bf16) {
    constexpr size_t smem = mma_smem_bytes(HD);
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_mma_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_attention_mma_kernel<HD><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, S, H, KH,
        scale);
  } else {
    constexpr size_t smem = tf32_smem_bytes(HD);
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_attention_tf32_kernel<HD><<<grid, TF32_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, S, H, KH, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [B, S, H, HD]; k, v: [B, S, KH, HD]; all contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1). HD a multiple of 16 up to 128, H a
// multiple of KH, H and B at most 65535; bf16 pointers 16-byte aligned.
// lse: null, or float32 [B, H, S]
// that receives each row's log-sum-exp of its scaled visible scores (what
// the backward kernels recompute the probabilities from). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// size it was not built for).
extern "C" int dmel_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int B, int S, int H, int KH, int HD,
                                    int bf16, float scale, void* stream) {
  float* const ls = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return launch<16>(q, k, v, out, ls, B, S, H, KH, bf16, scale, st);
    case 32: return launch<32>(q, k, v, out, ls, B, S, H, KH, bf16, scale, st);
    case 48: return launch<48>(q, k, v, out, ls, B, S, H, KH, bf16, scale, st);
    case 64: return launch<64>(q, k, v, out, ls, B, S, H, KH, bf16, scale, st);
    case 80: return launch<80>(q, k, v, out, ls, B, S, H, KH, bf16, scale, st);
    case 96: return launch<96>(q, k, v, out, ls, B, S, H, KH, bf16, scale, st);
    case 112: return launch<112>(q, k, v, out, ls, B, S, H, KH, bf16, scale, st);
    case 128: return launch<128>(q, k, v, out, ls, B, S, H, KH, bf16, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch FA makes for these arguments: cfg[0..2] = grid x, y, z,
// cfg[3] = threads per block, cfg[4] = dynamic shared memory per block in
// bytes. Returns cudaErrorInvalidValue for a head size it was not built for.
extern "C" int dmel_flash_attention_config(int B, int S, int H, int HD, int bf16, int* cfg) {
  if (HD % 16 != 0 || HD < 16 || HD > 128) return static_cast<int>(cudaErrorInvalidValue);
  cfg[0] = (S + 63) / 64;
  cfg[1] = H;
  cfg[2] = B;
  cfg[3] = bf16 ? MMA_THREADS : TF32_THREADS;
  cfg[4] = static_cast<int>(bf16 ? mma_smem_bytes(HD) : tf32_smem_bytes(HD));
  return 0;
}
