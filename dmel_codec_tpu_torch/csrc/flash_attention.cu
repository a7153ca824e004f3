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
// card's flop/byte balance. This first version runs both products on the
// float32 CUDA cores (67 TFLOP/s peak, against 989 on the bf16 tensor
// cores), so that float32 inputs keep float32 products; tensor-core
// products are the next step for the bf16 path.
//
// Design: one block of 128 threads per (batch, head, tile of 64 queries).
// It walks the key tiles 0 .. diagonal, staging K and V (64 keys each)
// through shared memory as float32. The threads form a 16 x 8 grid: a
// thread owns 4 query rows (ty + 16 i) and, of the 64 x 64 score tile, 8
// columns (tx + 8 j); the 8 lanes that share a row reduce its max and sum
// with shuffles. Online softmax: running max m and sum l per row in
// registers, P through shared memory (each row is written and read by one
// warp), the output tile (4 rows x hd / 8 columns per thread) rescaled in
// registers. Shared rows are padded so that the float4 reads of Q, K and P
// and the float2 reads of V are free of bank conflicts. Scores, softmax and
// accumulation are float32; the output is rounded once to the input dtype.
// For training the kernel also stores L = m + log(l) per row (float32): the
// backward kernels (flash_attention_bwd.cu) recompute P = exp(S - L) from it.
// The tiling constants and the tile loader are in flash_common.cuh.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace dmel_flash;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BM * (HD + 4) + BN * (HD + 4) + BN * HD + BM * PS);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                       const void* __restrict__ v, void* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int KH, int bf16,
                       float scale) {
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

  load_tile<HD>(Qs, QS, q, b, S, H, h, q0, bf16);

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
    load_tile<HD>(Ks, QS, k, b, S, KH, kh, n0, bf16);
    load_tile<HD>(Vs, HD, v, b, S, KH, kh, n0, bf16);
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
      dmel::store_f(out, base + 16 * jp + 2 * tx, o[i][jp][0] * inv, bf16);
      dmel::store_f(out, base + 16 * jp + 2 * tx + 1, o[i][jp][1] * inv, bf16);
    }
    if (lse != nullptr && tx == 0) lse[(b * H + h) * S + row] = m[i] + logf(l[i]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int H, int KH, int bf16, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((S + BM - 1) / BM), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(q, k, v, out, lse, S, H, KH,
                                                              bf16, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [B, S, H, HD]; k, v: [B, S, KH, HD]; all contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1). HD a multiple of 16 up to 128, H a
// multiple of KH, H and B at most 65535. lse: null, or float32 [B, H, S]
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
