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
// float32 (flash_attention_kernel): float32 inputs keep float32 products,
// as the JAX float32 path does (TF32 would keep ~3 digits), so both
// products run on the float32 CUDA cores (67 TFLOP/s peak). One block of 128
// threads per (batch, head, tile of 64 queries) walks the key tiles
// 0 .. diagonal, staging K and V (64 keys each) through shared memory as
// float32. The threads form a 16 x 8 grid: a thread owns 4 query rows
// (ty + 16 i) and, of the 64 x 64 score tile, 8 columns (tx + 8 j); the 8
// lanes that share a row reduce its max and sum with shuffles. Online
// softmax: running max m and sum l per row in registers, P through shared
// memory (each row is written and read by one warp), the output tile (4 rows
// x hd / 8 columns per thread) rescaled in registers. Shared rows are padded
// so that the float4 reads of Q, K and P and the float2 reads of V are free
// of bank conflicts.
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

constexpr size_t smem_bytes(int HD) {
  return sizeof(float) * (BM * (HD + 4) + BN * (HD + 4) + BN * HD + BM * PS);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int KH, float scale) {
  constexpr int QS = HD + 4;   // row stride of the Q and K tiles
  constexpr int OP = HD / 16;  // output column pairs per thread, c = 16 jp + 2 tx + {0, 1}
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BM * QS;
  float* Vs = Ks + BN * QS;
  float* Ps = Vs + BN * HD;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / (H / KH);

  load_tile<HD>(Qs, QS, q, b, S, H, h, q0, 0);

  float m[RI], l[RI], o[RI][OP][2];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jp = 0; jp < OP; ++jp) o[i][jp][0] = o[i][jp][1] = 0.f;
  }

  for (int n0 = 0; n0 <= q0; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD>(Ks, QS, k, b, S, KH, kh, n0, 0);
    load_tile<HD>(Vs, HD, v, b, S, KH, kh, n0, 0);
    __syncthreads();

    // scores: acc[i][j] = q[row i] . k[col j]
    float acc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + TY * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[(tx + TX * j) * QS + d]);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          acc[i][j] = fmaf(qv[i].x, kv.x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, kv.y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, kv.z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, kv.w, acc[i][j]);
        }
      }
    }

    // causal mask and online softmax; P goes to shared memory
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = n0 + tx + TX * j;
        const float s = col <= row ? acc[i][j] * scale : -INFINITY;
        acc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int w = 1; w < TX; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      // column n0 <= q0 <= row is visible, so mn is finite
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(acc[i][j] - mn);  // exactly 0 where masked
        sum += p;
        Ps[(ty + TY * i) * PS + tx + TX * j] = p;
      }
#pragma unroll
      for (int w = 1; w < TX; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int jp = 0; jp < OP; ++jp) {
        o[i][jp][0] *= corr;
        o[i][jp][1] *= corr;
      }
    }
    __syncwarp();  // a row of P is written and read by the same warp

    // o += P . V
#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float p[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(&Ps[(ty + TY * i) * PS + n]);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int jp = 0; jp < OP; ++jp) {
          const float2 vv =
              *reinterpret_cast<const float2*>(&Vs[(n + nn) * HD + 16 * jp + 2 * tx]);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            o[i][jp][0] = fmaf(p[i][nn], vv.x, o[i][jp][0]);
            o[i][jp][1] = fmaf(p[i][nn], vv.y, o[i][jp][1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    const float inv = 1.f / l[i];
    const long long base = ((b * S + row) * H + h) * HD;
#pragma unroll
    for (int jp = 0; jp < OP; ++jp) {
      out[base + 16 * jp + 2 * tx] = o[i][jp][0] * inv;
      out[base + 16 * jp + 2 * tx + 1] = o[i][jp][1] * inv;
    }
    if (lse != nullptr && tx == 0) lse[(b * H + h) * S + row] = m[i] + logf(l[i]);
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
  const dim3 grid(static_cast<unsigned>((S + BM - 1) / BM), static_cast<unsigned>(H),
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
    constexpr size_t smem = smem_bytes(HD);
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(
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
  cfg[0] = (S + BM - 1) / BM;
  cfg[1] = H;
  cfg[2] = B;
  cfg[3] = bf16 ? MMA_THREADS : THREADS;
  cfg[4] = static_cast<int>(bf16 ? mma_smem_bytes(HD) : smem_bytes(HD));
  return 0;
}
