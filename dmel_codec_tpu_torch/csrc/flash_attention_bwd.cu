// FA-dKV and FA-dQ: causal grouped-query flash attention, backward.
//
// Replace the two Pallas TPU kernels that jax's
// pallas.ops.tpu.flash_attention launches under jax.grad of
// `_flash_causal_attention` (dmel_codec_tpu/models/transformer.py):
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`. Same functions;
// the plain PyTorch version is ops/flash_attention.py
// flash_attention_backward_reference. With s = scale * q . k over the
// visible keys t <= s of a query row, L its log-sum-exp (stored by the
// forward kernel), dO the gradient of the output O and
// D = rowsum(dO * O) (one reduction outside the kernels, as in the JAX
// package):
//
//   P  = exp(s - L)                (exactly 0 where masked)
//   dV = P^T dO                    summed over the g = H / KH heads of a group
//   dS = P * (dO V^T - D)
//   dK = scale * dS^T Q            summed over the group
//   dQ = scale * dS K
//
// The JAX wrapper repeats K/V to full heads (and sums dK/dV over the group
// through the transpose of that repeat), zero-pads S to a multiple of 128
// and plans major/minor blocks for the TPU's sequential grid. Here a block
// indexes its KV head, masks the ragged last tile, and loops over what the
// TPU grid walked in order.
//
// Bound on the H100: operations (five 64 x 64 x hd products per visible tile
// pair against a few bytes per row). Like the forward, this first version
// runs every product on the float32 CUDA cores so that float32 inputs keep
// float32 products, and recomputes the score tile in each kernel (seven
// products in all).
//
// FA-dQ: one block per (batch, head, tile of 64 queries), longest rows
// first. Q and dO stay in shared memory; the block walks the key tiles
// 0 .. diagonal, staging K and V, forms P and dP = dO V^T in registers,
// writes dS to shared memory (each row is written and read by one warp) and
// accumulates dQ += dS K in registers.
//
// FA-dKV: one block per (batch, KV head, tile of 64 keys). K and V stay in
// shared memory; the block loops over the g query heads of its group and,
// for each, over the query tiles from the diagonal to the end, staging Q
// and dO. It forms the TRANSPOSED tiles P^T and dS^T (rows = keys) so that
// the accumulations dV += P^T dO and dK += dS^T Q have the forward's
// register layout. The sum over the group happens in the block's registers:
// no atomics, one store per element, a deterministic result, dK/dV in
// [B, S, KH, hd] directly. Rows at or beyond S are zero-filled and masked,
// so any S >= 1 runs as it is.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace dmel_flash;

// acc[i][j] = sum_d A[(ty + TY i) * (HD + 4) + d] * Bt[(tx + TX j) * (HD + 4) + d]
template <int HD>
__device__ __forceinline__ void tile_product(float (&acc)[RI][CJ], const float* A,
                                             const float* Bt, int ty, int tx) {
  constexpr int QS = HD + 4;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 av[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(ty + TY * i) * QS + d]);
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bt[(tx + TX * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * BM * (HD + 4) + BM * PS);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * BM * (HD + 4) + 2 * BN * PS + 2 * BM);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_dq_kernel(const void* __restrict__ q, const void* __restrict__ k,
                          const void* __restrict__ v, const void* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          void* __restrict__ dq, int S, int H, int KH, int bf16,
                          float scale) {
  constexpr int QS = HD + 4;   // row stride of the operand tiles
  constexpr int OP = HD / 16;  // dQ column pairs per thread, c = 16 jp + 2 tx + {0, 1}
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BM * QS;
  float* Ks = dOs + BM * QS;
  float* Vs = Ks + BN * QS;
  float* dSs = Vs + BN * QS;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / (H / KH);

  load_tile<HD>(Qs, QS, q, b, S, H, h, q0, bf16);
  load_tile<HD>(dOs, QS, dout, b, S, H, h, q0, bf16);

  float L[RI], D[RI], acc_dq[RI][OP][2];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    L[i] = row < S ? lse[(b * H + h) * S + row] : 0.f;
    D[i] = row < S ? delta[(b * H + h) * S + row] : 0.f;
#pragma unroll
    for (int jp = 0; jp < OP; ++jp) acc_dq[i][jp][0] = acc_dq[i][jp][1] = 0.f;
  }

  for (int n0 = 0; n0 <= q0; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD>(Ks, QS, k, b, S, KH, kh, n0, bf16);
    load_tile<HD>(Vs, QS, v, b, S, KH, kh, n0, bf16);
    __syncthreads();

    float p[RI][CJ], dp[RI][CJ];
    tile_product<HD>(p, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = n0 + tx + TX * j;
        p[i][j] = (col <= row && row < S) ? expf(p[i][j] * scale - L[i]) : 0.f;
      }
    }
    tile_product<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        dSs[(ty + TY * i) * PS + tx + TX * j] = p[i][j] * (dp[i][j] - D[i]);
    __syncwarp();  // a row of dS is written and read by the same warp

    // dq += dS . K
#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float ds[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(&dSs[(ty + TY * i) * PS + n]);
        ds[i][0] = t.x;
        ds[i][1] = t.y;
        ds[i][2] = t.z;
        ds[i][3] = t.w;
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int jp = 0; jp < OP; ++jp) {
          const float2 kv =
              *reinterpret_cast<const float2*>(&Ks[(n + nn) * QS + 16 * jp + 2 * tx]);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            acc_dq[i][jp][0] = fmaf(ds[i][nn], kv.x, acc_dq[i][jp][0]);
            acc_dq[i][jp][1] = fmaf(ds[i][nn], kv.y, acc_dq[i][jp][1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    const long long base = ((b * S + row) * H + h) * HD;
#pragma unroll
    for (int jp = 0; jp < OP; ++jp) {
      dmel::store_f(dq, base + 16 * jp + 2 * tx, acc_dq[i][jp][0] * scale, bf16);
      dmel::store_f(dq, base + 16 * jp + 2 * tx + 1, acc_dq[i][jp][1] * scale, bf16);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_dkv_kernel(const void* __restrict__ q, const void* __restrict__ k,
                           const void* __restrict__ v, const void* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           void* __restrict__ dk, void* __restrict__ dv, int S, int H,
                           int KH, int bf16, float scale) {
  constexpr int QS = HD + 4;
  constexpr int OP = HD / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BN * QS;
  float* Qs = Vs + BN * QS;
  float* dOs = Qs + BM * QS;
  float* PTs = dOs + BM * QS;   // P^T, rows = keys
  float* dSTs = PTs + BN * PS;  // dS^T
  float* Ls = dSTs + BN * PS;
  float* Ds = Ls + BM;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int n0 = blockIdx.x * BN;  // key tile 0 walks the most query tiles and starts first
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int g = H / KH;

  load_tile<HD>(Ks, QS, k, b, S, KH, kh, n0, bf16);
  load_tile<HD>(Vs, QS, v, b, S, KH, kh, n0, bf16);

  float acc_dk[RI][OP][2], acc_dv[RI][OP][2];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jp = 0; jp < OP; ++jp)
      acc_dk[i][jp][0] = acc_dk[i][jp][1] = acc_dv[i][jp][0] = acc_dv[i][jp][1] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kh * g + hh;
    for (int m0 = n0; m0 < S; m0 += BM) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<HD>(Qs, QS, q, b, S, H, h, m0, bf16);
      load_tile<HD>(dOs, QS, dout, b, S, H, h, m0, bf16);
      if (threadIdx.x < BM) {
        const int m = m0 + threadIdx.x;
        Ls[threadIdx.x] = m < S ? lse[(b * H + h) * S + m] : 0.f;
        Ds[threadIdx.x] = m < S ? delta[(b * H + h) * S + m] : 0.f;
      }
      __syncthreads();

      // P^T[key][query] = exp(scale * k . q - L[query]) where query >= key
      float acc[RI][CJ];
      tile_product<HD>(acc, Ks, Qs, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int key = n0 + ty + TY * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + TX * j;
          const int qr = m0 + c;
          PTs[(ty + TY * i) * PS + c] =
              (key <= qr && qr < S) ? expf(acc[i][j] * scale - Ls[c]) : 0.f;
        }
      }
      // dS^T = P^T * (v . dO - D[query]); a thread reads back its own P^T entries
      tile_product<HD>(acc, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + TX * j;
          const int at = (ty + TY * i) * PS + c;
          dSTs[at] = PTs[at] * (acc[i][j] - Ds[c]);
        }
      __syncwarp();  // a row of P^T / dS^T is written and read by the same warp

      // dv += P^T . dO, dk += dS^T . Q
#pragma unroll 2
      for (int m = 0; m < BM; m += 4) {
        float pt[RI][4], ds[RI][4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(&PTs[(ty + TY * i) * PS + m]);
          const float4 c = *reinterpret_cast<const float4*>(&dSTs[(ty + TY * i) * PS + m]);
          pt[i][0] = a.x;
          pt[i][1] = a.y;
          pt[i][2] = a.z;
          pt[i][3] = a.w;
          ds[i][0] = c.x;
          ds[i][1] = c.y;
          ds[i][2] = c.z;
          ds[i][3] = c.w;
        }
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
#pragma unroll
          for (int jp = 0; jp < OP; ++jp) {
            const float2 dov =
                *reinterpret_cast<const float2*>(&dOs[(m + mm) * QS + 16 * jp + 2 * tx]);
            const float2 qv =
                *reinterpret_cast<const float2*>(&Qs[(m + mm) * QS + 16 * jp + 2 * tx]);
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              acc_dv[i][jp][0] = fmaf(pt[i][mm], dov.x, acc_dv[i][jp][0]);
              acc_dv[i][jp][1] = fmaf(pt[i][mm], dov.y, acc_dv[i][jp][1]);
              acc_dk[i][jp][0] = fmaf(ds[i][mm], qv.x, acc_dk[i][jp][0]);
              acc_dk[i][jp][1] = fmaf(ds[i][mm], qv.y, acc_dk[i][jp][1]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = n0 + ty + TY * i;
    if (key >= S) continue;
    const long long base = ((b * S + key) * KH + kh) * HD;
#pragma unroll
    for (int jp = 0; jp < OP; ++jp) {
      const int c = 16 * jp + 2 * tx;
      dmel::store_f(dk, base + c, acc_dk[i][jp][0] * scale, bf16);
      dmel::store_f(dk, base + c + 1, acc_dk[i][jp][1] * scale, bf16);
      dmel::store_f(dv, base + c, acc_dv[i][jp][0], bf16);
      dmel::store_f(dv, base + c + 1, acc_dv[i][jp][1], bf16);
    }
  }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int S, int H, int KH, int bf16,
              float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((S + BM - 1) / BM), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_attention_dq_kernel<HD><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, H, KH, bf16, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B, int S, int H,
               int KH, int bf16, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((S + BN - 1) / BN), static_cast<unsigned>(KH),
                  static_cast<unsigned>(B));
  flash_attention_dkv_kernel<HD><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, H, KH, bf16, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DMEL_FLASH_HEAD_SIZES(CALL) \
  switch (HD) {                     \
    case 16: return CALL(16);       \
    case 32: return CALL(32);       \
    case 48: return CALL(48);       \
    case 64: return CALL(64);       \
    case 80: return CALL(80);       \
    case 96: return CALL(96);       \
    case 112: return CALL(112);     \
    case 128: return CALL(128);     \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// q, dout, dq: [B, S, H, HD]; k, v, dk, dv: [B, S, KH, HD]; all contiguous,
// float32 (bf16 = 0) or bfloat16 (bf16 = 1). lse, delta: float32 [B, H, S]
// (the forward kernel's log-sum-exp, and rowsum(dout * out)). HD a multiple
// of 16 up to 128, H a multiple of KH, H and B at most 65535. Each returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head size
// it was not built for).
extern "C" int dmel_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int B, int S, int H,
                                           int KH, int HD, int bf16, float scale,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define CALL(N) launch_dq<N>(q, k, v, dout, ls, dl, dq, B, S, H, KH, bf16, scale, st)
  DMEL_FLASH_HEAD_SIZES(CALL)
#undef CALL
}

extern "C" int dmel_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int B,
                                            int S, int H, int KH, int HD, int bf16,
                                            float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define CALL(N) launch_dkv<N>(q, k, v, dout, ls, dl, dk, dv, B, S, H, KH, bf16, scale, st)
  DMEL_FLASH_HEAD_SIZES(CALL)
#undef CALL
}
