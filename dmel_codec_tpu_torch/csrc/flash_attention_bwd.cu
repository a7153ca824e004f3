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
// pair against a few bytes per row). float32 inputs keep float32-grade
// products (one TF32 product would keep ~3 digits), as the JAX float32 path
// does: FA-dQ's on the tensor cores as split-TF32 products
// (flash_common.cuh), FA-dKV's on the CUDA cores; bf16 inputs run every
// product of both kernels on the tensor cores. Each kernel recomputes the
// score tile (seven products in all).
//
// FA-dQ: one block per (batch, head, tile of 64 queries), longest rows
// first. Q and dO stay in shared memory; the block walks the key tiles
// 0 .. diagonal.
//   float32 (dq_tf32_kernel): the bf16 kernel's layout with the three
// products split-TF32 on mma.sync.m16n8k8 .tf32. Q and dO stay float32 in
// shared memory and are split per k-step; each K and V tile is loaded by
// 16-byte loads and split once into hi and lo tiles that every warp reads
// (102 KB of shared memory at hd 64: two blocks an SM). P and dS stay
// float32 in registers (no rounding), dS's C fragments are the A fragments
// of dS K with each 8 keys in the order {0, 2, 4, 6, 1, 3, 5, 7}, and K is
// read as dS K's B operand from the same hi and lo tiles as Q K^T's. Each
// key tile's dS K goes into a fresh accumulator added to the float32 dQ
// sums rounded to nearest (the tensor cores truncate their sums); dQ is
// scaled once and stored once, in float32. The sums run in one fixed
// order: the same bits in every run.
//   bf16 (dq_mma_kernel): S = Q K^T, dP = dO V^T and dQ += dS K on
// mma.sync.m16n8k16, a warp per 16 query rows; K and V double-buffered with
// cp.async (55 KB of shared memory at hd 64, 104 KB at hd 128); only the
// diagonal tile masks (rows at or beyond S have zero Q and dO); P and dS
// stay in float32 registers, and scale * dS is rounded to bf16 before dS K,
// as the JAX kernel rounds it (flash_attention.py:1249-1258), its C
// fragments repacked into A fragments in registers; K is dS K's B operand
// through ldmatrix.trans, so nothing is transposed in shared memory. dQ
// sums in float32 registers and is stored once, in bf16.
//
// FA-dKV: one block per (batch, query head, tile of 64 keys): at the
// trainer's [2, 1024, 14 -> 2, 64] that is 16 x 14 x 2 = 448 blocks of 4
// warps (3.4 per SM; the earlier design, one block per KV head looping over
// the group, launched 64 on 132 SMs). K and V stay in shared memory; the
// block walks the query tiles from the diagonal to the end, staging Q and
// dO, and forms the TRANSPOSED tiles P^T and dS^T (rows = keys), so that
// dV += P^T dO and dK += dS^T Q accumulate per key row. The g = H / KH query
// heads of a group sum deterministically: each block writes its float32
// partial dK and dV to a scratch [B, H, S, hd], counts itself in with one
// atomic per block, and the block that comes last for its (batch, KV head,
// key tile) adds the g partials in head order and stores dK and dV in the
// inputs' dtype, [B, S, KH, hd] directly. The order of arrival picks only
// which block adds, never the order of the sum: two runs give the same
// bits. Rows at or beyond S are zero-filled and masked, so any S >= 1 runs
// as it is.
//   float32 (dkv_f32_kernel): the products on the CUDA cores in the
// forward's 16 x 8 thread grid, P^T and dS^T through shared memory.
//   bf16 (dkv_mma_kernel): the four products S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO and dK += dS^T Q on mma.sync.m16n8k16, a warp per 16 keys; Q
// and dO double-buffered with cp.async; P^T and dS^T stay in registers and
// are rounded to bf16 before their products, as the JAX kernel rounds them
// (flash_attention.py:900, :918); dS^T itself is formed from the float32
// P^T.
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

constexpr size_t dq_tf32_smem_bytes(int HD) {  // Q, dO, and the hi and lo tiles of K and V
  return sizeof(float) * 6 * 64 * (HD + 4);
}

template <int HD>
__global__ void __launch_bounds__(TF32_THREADS)
dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int S, int H, int KH, float scale) {
  constexpr int TS = HD + 4;
  constexpr int KS = HD / 8;  // k-steps over the head dimension
  constexpr int DT = HD / 8;  // 8-wide dQ column tiles
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + 64 * TS;
  float* Kh = dOs + 64 * TS;
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
  const float sl2 = scale * LOG2E;

  stage_tiles_f32<HD, 2, false>(Qs, nullptr, q, dOs, nullptr, dout, b, S, H, h, q0);

  // this lane's rows row_lo and row_lo + 8: L (log2 domain) and D. Rows at
  // or beyond S have zero Q and dO and L = D = 0, so their dS is 0.
  const int row_lo = q0 + warp * 16 + lane / 4;
  float L2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    L2[r] = row < S ? lse[(b * H + h) * S + row] * LOG2E : 0.f;
    Dr[r] = row < S ? delta[(b * H + h) * S + row] : 0.f;
  }
  float acc[DT][4];  // dQ / scale, float32 sums rounded to nearest
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * 64;
    __syncthreads();  // every warp is done with tile j - 1 (and Q, dO have landed)
    stage_tiles_f32<HD, 2, true>(Kh, Kl, k, Vh, Vl, v, b, S, KH, kh, n0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned qh[4], ql[4], oh[4], ol[4];
      lds_a_split(qh, ql, Qs, TS, warp * 16, 8 * ks);
      lds_a_split(oh, ol, dOs, TS, warp * 16, 8 * ks);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        unsigned kh2[2], kl2[2], vh2[2], vl2[2];
        lds_bt(kh2, Kh, TS, 8 * jn, 8 * ks);
        lds_bt(kl2, Kl, TS, 8 * jn, 8 * ks);
        lds_bt(vh2, Vh, TS, 8 * jn, 8 * ks);
        lds_bt(vl2, Vl, TS, 8 * jn, 8 * ks);
        mma_split(sc[jn], qh, ql, kh2, kl2);
        mma_split(dp[jn], oh, ol, vh2, vl2);
      }
    }
    // P = exp(scale s - L), exactly 0 above the diagonal; dS = P (dP - D),
    // float32
    const bool diag = j == n_tiles - 1;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool masked = diag && n0 + 8 * jn + 2 * t + (e & 1) > row_lo + 8 * r;
        const float p = masked ? 0.f : exp2f(sc[jn][e] * sl2 - L2[r]);
        sc[jn][e] = p * (dp[jn][e] - Dr[r]);
      }
    }
    // dQ += dS K: this tile's products into a fresh accumulator (the tensor
    // cores truncate their sums), added to dQ rounded to nearest
    float af[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) af[d][0] = af[d][1] = af[d][2] = af[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      unsigned sh[4], sl[4];
      c_to_a_split(sh, sl, sc[kk]);
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) {
        unsigned bh[2], bl[2];
        lds_b_perm(bh, Kh, TS, 8 * kk, 8 * dd);
        lds_b_perm(bl, Kl, TS, 8 * kk, 8 * dd);
        mma_split(af[dd], sh, sl, bh, bl);
      }
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = __fadd_rn(acc[d][e], af[d][e]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    float* dst = dq + ((b * S + row) * H + h) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(dst + 8 * d) = make_float2(acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
  }
}

constexpr int DQ_WARPS = 4;  // a warp per 16 query rows: 64 rows per block
constexpr int DQ_THREADS = 32 * DQ_WARPS;

constexpr size_t dq_mma_smem_bytes(int HD) {  // Q, dO, two buffers each of K and V
  return sizeof(__nv_bfloat16) * 6 * 64 * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(DQ_THREADS)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int S, int H, int KH, float scale) {
  constexpr int LD = HD + 8;
  constexpr int KS = HD / 16;  // k-steps over the head dimension
  constexpr int DT = HD / 8;   // 8-wide dQ column tiles
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* dOs = Qs + 64 * LD;
  __nv_bfloat16* Ks = dOs + 64 * LD;  // [2][64][LD]
  __nv_bfloat16* Vs = Ks + 2 * 64 * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;  // longest rows first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / (H / KH);
  const int n_tiles = q0 / 64 + 1;  // key tiles 0 .. diagonal
  const float sl2 = scale * LOG2E;

  stage_tile_bf16<HD, DQ_THREADS>(Qs, q, b, S, H, h, q0);
  stage_tile_bf16<HD, DQ_THREADS>(dOs, dout, b, S, H, h, q0);
  stage_tile_bf16<HD, DQ_THREADS>(Ks, k, b, S, KH, kh, 0);
  stage_tile_bf16<HD, DQ_THREADS>(Vs, v, b, S, KH, kh, 0);
  cp_async_commit();

  // this lane's rows row_lo and row_lo + 8: L (log2 domain) and D. Rows at
  // or beyond S have zero Q and dO and L = D = 0, so their dS is 0.
  const int row_lo = q0 + warp * 16 + g;
  float L2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    L2[r] = row < S ? lse[(b * H + h) * S + row] * LOG2E : 0.f;
    Dr[r] = row < S ? delta[(b * H + h) * S + row] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1's buffer
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      stage_tile_bf16<HD, DQ_THREADS>(Ks + nb * 64 * LD, k, b, S, KH, kh, (j + 1) * 64);
      stage_tile_bf16<HD, DQ_THREADS>(Vs + nb * 64 * LD, v, b, S, KH, kh, (j + 1) * 64);
      cp_async_commit();
    }
    const __nv_bfloat16* Kt = Ks + (j & 1) * 64 * LD;
    const __nv_bfloat16* Vt = Vs + (j & 1) * 64 * LD;
    const int n0 = j * 64;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned qa[4], oa[4];
      ldsm_a(qa, Qs, LD, warp * 16, kk * 16);
      ldsm_a(oa, dOs, LD, warp * 16, kk * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bk[4], bv[4];
        ldsm_bt(bk, Kt, LD, jp * 16, kk * 16);
        ldsm_bt(bv, Vt, LD, jp * 16, kk * 16);
        mma_16816(sc[2 * jp], qa, bk[0], bk[1]);
        mma_16816(sc[2 * jp + 1], qa, bk[2], bk[3]);
        mma_16816(dp[2 * jp], oa, bv[0], bv[1]);
        mma_16816(dp[2 * jp + 1], oa, bv[2], bv[3]);
      }
    }
    // P = exp(scale s - L), exactly 0 above the diagonal; dS = P (dP - D),
    // then scale dS (the value the JAX kernel rounds to bf16)
    const bool diag = j == n_tiles - 1;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool masked = diag && n0 + 8 * jn + 2 * t + (e & 1) > row_lo + 8 * r;
        const float p = masked ? 0.f : exp2f(sc[jn][e] * sl2 - L2[r]);
        sc[jn][e] = p * (dp[jn][e] - Dr[r]) * scale;
      }
    }
    // dQ += round_bf16(scale dS) K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned sa[4];
      c_to_a(sa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        unsigned bk[4];
        ldsm_b(bk, Kt, LD, kk * 16, dd * 16);
        mma_16816(acc[2 * dd], sa, bk[0], bk[1]);
        mma_16816(acc[2 * dd + 1], sa, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dq + ((b * S + row) * H + h) * HD + 2 * t);
#pragma unroll
    for (int d = 0; d < DT; ++d) out[4 * d] = __floats2bfloat162_rn(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

// ---- FA-dKV ----------------------------------------------------------------

// The last of the g blocks of (batch, KV head, key tile n0) to arrive sums
// their float32 partials (scratch [B, H, S, HD]) in head order and stores
// dK and dV. Called by every thread of a block after it wrote its partial.
template <int HD, int NT>
__device__ __forceinline__ void finish_group(const float* part_k, const float* part_v,
                                             unsigned* count, void* dk, void* dv, long long b,
                                             int S, int H, int KH, int n0, int bf16) {
  __shared__ bool last;
  const int g = H / KH;
  const int kh = blockIdx.y / g;
  __threadfence();  // this thread's partial is visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* c = count + (b * KH + kh) * gridDim.x + blockIdx.x;
    last = atomicAdd(c, 1u) == static_cast<unsigned>(g - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int C4 = HD / 4;
  for (int i = threadIdx.x; i < 64 * C4; i += NT) {
    const int r = i / C4, c = 4 * (i % C4);
    const int key = n0 + r;
    if (key >= S) continue;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int hh = 0; hh < g; ++hh) {
      const long long at = ((b * H + kh * g + hh) * S + key) * HD + c;
      const float4 pk = __ldcg(reinterpret_cast<const float4*>(part_k + at));
      const float4 pv = __ldcg(reinterpret_cast<const float4*>(part_v + at));
      sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
      sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
    }
    const long long o = ((b * S + key) * KH + kh) * HD + c;
    if (bf16) {
      __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dk) + o);
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dv) + o);
      k2[0] = __floats2bfloat162_rn(sk.x, sk.y);
      k2[1] = __floats2bfloat162_rn(sk.z, sk.w);
      v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
      v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(dk) + o) = sk;
      *reinterpret_cast<float4*>(static_cast<float*>(dv) + o) = sv;
    }
  }
}

constexpr size_t dkv_f32_smem_bytes(int HD) {
  return sizeof(float) * (4 * BM * (HD + 4) + 2 * BN * PS + 2 * BM);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ part_k, float* __restrict__ part_v, unsigned* count,
               float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KH,
               float scale) {
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
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / (H / KH);

  load_tile<HD>(Ks, QS, k, b, S, KH, kh, n0);
  load_tile<HD>(Vs, QS, v, b, S, KH, kh, n0);

  float acc_dk[RI][OP][2], acc_dv[RI][OP][2];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jp = 0; jp < OP; ++jp)
      acc_dk[i][jp][0] = acc_dk[i][jp][1] = acc_dv[i][jp][0] = acc_dv[i][jp][1] = 0.f;

  for (int m0 = n0; m0 < S; m0 += BM) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD>(Qs, QS, q, b, S, H, h, m0);
    load_tile<HD>(dOs, QS, dout, b, S, H, h, m0);
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

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = n0 + ty + TY * i;
    if (key >= S) continue;
    const long long base = ((b * H + h) * S + key) * HD;
#pragma unroll
    for (int jp = 0; jp < OP; ++jp) {
      const int c = 16 * jp + 2 * tx;
      *reinterpret_cast<float2*>(part_k + base + c) =
          make_float2(acc_dk[i][jp][0] * scale, acc_dk[i][jp][1] * scale);
      *reinterpret_cast<float2*>(part_v + base + c) =
          make_float2(acc_dv[i][jp][0], acc_dv[i][jp][1]);
    }
  }
  finish_group<HD, THREADS>(part_k, part_v, count, dk, dv, b, S, H, KH, n0, 0);
}

constexpr int DKV_WARPS = 4;  // a warp per 16 keys: 64 keys per block
constexpr int DKV_THREADS = 32 * DKV_WARPS;

constexpr size_t dkv_mma_smem_bytes(int HD) {  // K, V, two buffers each of Q and dO; L, D
  return sizeof(__nv_bfloat16) * 6 * 64 * (HD + 8) + sizeof(float) * 4 * 64;
}

template <int HD>
__global__ void __launch_bounds__(DKV_THREADS)
dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ part_k, float* __restrict__ part_v, unsigned* count,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
               int KH, float scale) {
  constexpr int LD = HD + 8;
  constexpr int KS = HD / 16;
  constexpr int DT = HD / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + 64 * LD;
  __nv_bfloat16* Qs = Vs + 64 * LD;   // [2][64][LD]
  __nv_bfloat16* dOs = Qs + 2 * 64 * LD;
  float* Ls = reinterpret_cast<float*>(dOs + 2 * 64 * LD);  // [2][64], L * log2(e)
  float* Ds = Ls + 2 * 64;                                   // [2][64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * 64;  // key tile 0 walks the most query tiles and starts first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kh = h / (H / KH);
  const int n_tiles = (S - n0 + 63) / 64;  // query tiles n0 .. end
  const float sl2 = scale * LOG2E;
  const float* lrow = lse + (b * H + h) * S;
  const float* drow = delta + (b * H + h) * S;

  auto stage = [&](int j) {  // query tile j into buffer j & 1
    const int m0 = n0 + 64 * j, nb = j & 1;
    stage_tile_bf16<HD, DKV_THREADS>(Qs + nb * 64 * LD, q, b, S, H, h, m0);
    stage_tile_bf16<HD, DKV_THREADS>(dOs + nb * 64 * LD, dout, b, S, H, h, m0);
    if (threadIdx.x < 64) {
      const int m = m0 + threadIdx.x;
      Ls[nb * 64 + threadIdx.x] = m < S ? lrow[m] * LOG2E : 0.f;
      Ds[nb * 64 + threadIdx.x] = m < S ? drow[m] : 0.f;
    }
  };
  stage_tile_bf16<HD, DKV_THREADS>(Ks, k, b, S, KH, kh, n0);
  stage_tile_bf16<HD, DKV_THREADS>(Vs, v, b, S, KH, kh, n0);
  stage(0);
  cp_async_commit();

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[d][e] = adv[d][e] = 0.f;
  const int key_lo = n0 + warp * 16 + g;  // this lane's key rows: key_lo, key_lo + 8

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1's buffers
    if (j + 1 < n_tiles) {
      stage(j + 1);
      cp_async_commit();
    }
    const int nb = j & 1, m0 = n0 + 64 * j;
    const __nv_bfloat16* Qt = Qs + nb * 64 * LD;
    const __nv_bfloat16* dOt = dOs + nb * 64 * LD;
    const float* Lt = Ls + nb * 64;
    const float* Dt = Ds + nb * 64;

    // S^T = K Q^T: 16 keys x 64 queries per warp
    float st[8][4], dp[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned ak[4], av[4];
      ldsm_a(ak, Ks, LD, warp * 16, kk * 16);
      ldsm_a(av, Vs, LD, warp * 16, kk * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned bq[4], bo[4];
        ldsm_bt(bq, Qt, LD, jp * 16, kk * 16);
        ldsm_bt(bo, dOt, LD, jp * 16, kk * 16);
        mma_16816(st[2 * jp], ak, bq[0], bq[1]);
        mma_16816(st[2 * jp + 1], ak, bq[2], bq[3]);
        mma_16816(dp[2 * jp], av, bo[0], bo[1]);  // dP^T = V dO^T
        mma_16816(dp[2 * jp + 1], av, bo[2], bo[3]);
      }
    }
    // P^T = exp(scale s - L[query]) where key <= query < S; dS^T = P^T (dP^T - D[query])
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * jn + 2 * t + (e & 1);  // query column in the tile
        const int qr = m0 + c;
        const int key = key_lo + 8 * (e >> 1);
        const float p = (key <= qr && qr < S) ? exp2f(st[jn][e] * sl2 - Lt[c]) : 0.f;
        st[jn][e] = p;
        dp[jn][e] = p * (dp[jn][e] - Dt[c]);
      }
    }
    // dV += P^T dO, dK += dS^T Q, with P^T and dS^T rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned pa[4], sa[4];
      c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dq = 0; dq < HD / 16; ++dq) {
        unsigned bo[4], bq[4];
        ldsm_b(bo, dOt, LD, kk * 16, dq * 16);
        ldsm_b(bq, Qt, LD, kk * 16, dq * 16);
        mma_16816(adv[2 * dq], pa, bo[0], bo[1]);
        mma_16816(adv[2 * dq + 1], pa, bo[2], bo[3]);
        mma_16816(adk[2 * dq], sa, bq[0], bq[1]);
        mma_16816(adk[2 * dq + 1], sa, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= S) continue;
    const long long base = ((b * H + h) * S + key) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<float2*>(part_k + base + 8 * d) =
          make_float2(adk[d][2 * r] * scale, adk[d][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(part_v + base + 8 * d) =
          make_float2(adv[d][2 * r], adv[d][2 * r + 1]);
    }
  }
  finish_group<HD, DKV_THREADS>(part_k, part_v, count, dk, dv, b, S, H, KH, n0, 1);
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int S, int H, int KH, int bf16,
              float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S + 63) / 64), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  if (bf16) {
    constexpr size_t smem = dq_mma_smem_bytes(HD);
    const cudaError_t e = cudaFuncSetAttribute(
        dq_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    using bf = __nv_bfloat16;
    dq_mma_kernel<HD><<<grid, DQ_THREADS, smem, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), S, H, KH, scale);
  } else {
    constexpr size_t smem = dq_tf32_smem_bytes(HD);
    const cudaError_t e = cudaFuncSetAttribute(
        dq_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dq_tf32_kernel<HD><<<grid, TF32_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), S, H, KH, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* part_k, float* part_v,
               unsigned* count, void* dk, void* dv, int B, int S, int H, int KH, int bf16,
               float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S + 63) / 64), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  if (bf16) {
    constexpr size_t smem = dkv_mma_smem_bytes(HD);
    const cudaError_t e = cudaFuncSetAttribute(
        dkv_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    using bf = __nv_bfloat16;
    dkv_mma_kernel<HD><<<grid, DKV_THREADS, smem, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(dout), lse, delta, part_k, part_v, count, static_cast<bf*>(dk),
        static_cast<bf*>(dv), S, H, KH, scale);
  } else {
    constexpr size_t smem = dkv_f32_smem_bytes(HD);
    const cudaError_t e = cudaFuncSetAttribute(
        dkv_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dkv_f32_kernel<HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, part_k,
        part_v, count, static_cast<float*>(dk), static_cast<float*>(dv), S, H, KH, scale);
  }
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

// FA-dKV's scratch, beside the arguments of FA-dQ: part_k, part_v float32
// [B, H, S, HD]; count: B * KH * ceil(S / 64) unsigned ints, zeroed before
// each launch. bf16 pointers 16-byte aligned.
extern "C" int dmel_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* part_k, void* part_v,
                                            void* count, void* dk, void* dv, int B, int S,
                                            int H, int KH, int HD, int bf16, float scale,
                                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* pk = static_cast<float*>(part_k);
  float* pv = static_cast<float*>(part_v);
  unsigned* cnt = static_cast<unsigned*>(count);
#define CALL(N) \
  launch_dkv<N>(q, k, v, dout, ls, dl, pk, pv, cnt, dk, dv, B, S, H, KH, bf16, scale, st)
  DMEL_FLASH_HEAD_SIZES(CALL)
#undef CALL
}

// The launches FA-dKV (which = 0) and FA-dQ (which = 1) make for these
// arguments, as dmel_flash_attention_config reports FA's: grid x, y, z,
// threads per block, dynamic shared memory per block in bytes.
extern "C" int dmel_flash_attention_bwd_config(int which, int B, int S, int H, int HD, int bf16,
                                               int* cfg) {
  if (HD % 16 != 0 || HD < 16 || HD > 128) return static_cast<int>(cudaErrorInvalidValue);
  cfg[0] = (S + 63) / 64;
  cfg[1] = H;
  cfg[2] = B;
  cfg[3] = which == 1 ? (bf16 ? DQ_THREADS : TF32_THREADS) : bf16 ? DKV_THREADS : THREADS;
  cfg[4] = static_cast<int>(which == 1 ? (bf16 ? dq_mma_smem_bytes(HD) : dq_tf32_smem_bytes(HD))
                            : bf16     ? dkv_mma_smem_bytes(HD)
                                       : dkv_f32_smem_bytes(HD));
  return 0;
}
