// K2-v1: a whole BigVGAN AMP resblock stage in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `fused_amp_stage`
// (dmel_codec_tpu/ops/stage_fused.py, `use_v2=False`): for k in (3, 7, 11):
// xb = x; for d in (1, 3, 5): xb += conv_{k,1}(act(conv_{k,d}(act(xb))));
// out = mean of the three xb. What sets it apart from K2 (one launch per
// act -> conv pair, planes through device memory) is that the whole chain
// of a time tile stays in shared memory in float32 and is rounded once, at
// the store. ops/stage_fused.py amp_stage_v1 launches it once per stage;
// stage_reference_v1 is the plain PyTorch version. One design, two kernels,
// picked by dtype: bf16 convs on bf16 operands as the JAX kernel runs them
// on the matrix unit, float32 convs to float32 accuracy as it runs them at
// HIGHEST (stage_fused.py:145-149).
//
// Bound on the H100: by operations, the C x C x k convs on the tensor cores
// (bf16: one product at the bf16 rate; float32: three TF32 products at the
// TF32 rate, half of bf16's, so six times the bf16 time) beside the 36
// activations on the CUDA cores (two 6-tap up FIRs, two sinf and a 12-tap
// down FIR per sample), with R = 96 columns per side of receptive field
// that a tile must either recompute or fetch. The earlier designs (one CTA
// per tile, float32 FMA convs) recomputed 2.55x the stored columns at C = 48
// and ran at 1 % of the bound; its float32 kernel spent 74 % of its time in
// the convs. Design:
//  * A thread-block cluster of G = 8 CTAs owns 8 adjacent tiles of W
//    columns (what fits 227 KB: bf16 256 at C = 48, 512 at C <= 32; float32
//    256 at C = 48, 512 at C = 24). After each of the 36 operations the CTAs
//    pull their neighbours' edge columns through distributed shared memory
//    (mapa + ld.shared::cluster, one barrier.cluster each): only the cluster
//    window's two ends compute what is not stored, 1.10x the stored columns
//    at C = 48, 1.05x at C = 24.
//  * The conv input is a plane in the no-swizzle K-major layout (bf16
//    [KP / 8][rows][8], float32 [KP / 4][rows][4]: a core matrix is 8 rows
//    of 16 bytes either way), so tap j's operand is the same plane shifted by
//    j d rows. Each warpgroup takes 64-row tiles:
//    - bf16 (stage_v1_tc_kernel): wgmma m64nNk16 (N = C rounded up to 24,
//      32 or 48) over (tap, 16 input channels) by descriptor; the conv's
//      weights come by one bulk copy (TMA) while the activation before it
//      runs.
//    - float32 (stage_v1_tf32_kernel): split-TF32, x = hi + lo with hi =
//      tf32(x) and lo = tf32(x - hi), A_hi B_hi + A_hi B_lo + A_lo B_hi on
//      wgmma m64nNk8 .tf32 (A from registers: each warpgroup loads and splits
//      its fragments of the float32 plane; B hi and lo split by the wrapper).
//      A whole conv's hi + lo weights (203 KB at C = 48) do not fit beside
//      the planes, so they stream tap by tap through a ring of 2-4 slots
//      (TMA bulk copies, full / empty mbarriers; the next conv's first taps
//      arrive while its activation runs), and each warpgroup keeps the
//      float32 sums of its tiles in registers through the taps, each tap's
//      products added to them from a fresh accumulator.
//  * The activation: a warp per (channel, 128 columns), lanes in odd runs
//    over register windows of its input, both snake phases into the warp's
//    scratch, then the down FIR, written to the conv input plane.
//  * The running sum of the three resblocks goes to a float32 scratch in
//    device memory (it would cost shared memory that W needs).
// Each stored output goes through the same operations wherever its tile
// lies, so a run on a slice gives the bits of the whole run beyond R
// samples from the cut. Numeric contract (stage_fused.py:145-149, 253-268,
// 297): input cast to float32; activations float32 with float32 taps and
// sinf; conv operands (the activation's output, the weights) rounded to
// bf16 and summed in float32 by the tensor cores, or kept float32 and split,
// bias float32; residual spine and running sum float32; one cast at the
// store.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int SMEM = 227 * 1024;  // dynamic shared memory one block may ask for on sm_90
constexpr int MAXB = 8;         // resblocks per stage
constexpr int MAXD = 8;         // dilations per resblock

struct V1Spec {
  int n_blk;
  int k[MAXB];
  int n_dil[MAXB];
  int dil[MAXB][MAXD];
};

// ---- bf16: the convs on the tensor cores, a cluster of tiles -------------

constexpr int TC_NT = 512;                            // 4 warpgroups
constexpr int TC_NW = TC_NT / 32;
constexpr int TC_XH = 8;                              // act-input halo columns per side (an act reaches 6)
constexpr int TC_PA = 32;                             // conv-input halo rows per side (a conv reaches <= 32)
constexpr int TC_SEG = 128;                           // activation outputs per warp unit
constexpr int TC_NS = TC_SEG + 6;                     // the half-rate positions they need
constexpr int TC_RUN_S = ((TC_NS + 31) / 32) | 1;     // a lane's run of positions (odd: distinct banks)
constexpr int TC_RUN_R = ((TC_SEG + 31) / 32) | 1;    // a lane's run of outputs
constexpr int TC_LV = 136;                            // scratch floats per phase and warp (>= 25 * 5 + 11)

constexpr int TC_MAX_KP = 48;                         // conv input channels (rounded up), at most
constexpr int TC_MAX_SLOTS = 4;                       // float32: per-tap weight slots, at most

__host__ __device__ constexpr uint32_t align128(uint32_t v) { return (v + 127u) & ~127u; }

// Shared memory of a block (ops/stage_fused.v1_tc_bytes and v1_tf32_bytes
// mirror it): the float32 residual spine xb and conv output t ([C][W + 2 XH]
// each), the conv input a in the no-swizzle K-major layout ([KP / 8][W + 2
// PA][8] bf16, or [KP / 4][W + 2 PA][4] float32), the weights (bf16: one
// conv, [k][KP / 8][N][8]; float32: `slots` per-tap slots of hi and lo,
// [2][KP / 4][N][4] each), the activation scratch and the weights'
// mbarriers (bf16: one; float32: a full and an empty one per slot).
struct V1TcLayout {
  int lw, ra;
  uint32_t xb, tp, a, w, scr, bar, total;
};

__host__ __device__ inline V1TcLayout v1tc_layout(int C, int KP, int W, int esize, uint32_t w_bytes,
                                                  uint32_t bar_bytes) {
  V1TcLayout l;
  l.lw = W + 2 * TC_XH;
  l.ra = W + 2 * TC_PA;
  l.xb = 0;
  l.tp = l.xb + align128(4u * C * l.lw);
  l.a = l.tp + align128(4u * C * l.lw);
  l.w = l.a + align128(static_cast<uint32_t>(esize) * KP * l.ra);
  l.scr = l.w + align128(w_bytes);
  l.bar = l.scr + 4u * TC_NW * 2 * TC_LV;
  l.total = l.bar + bar_bytes + 128;  // + the alignment of the base to 128 bytes
  return l;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
template <typename E>
__device__ __forceinline__ E from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// a[c][j] = act(src[c][.])[j] for this CTA's columns j in [0, W) that lie
// in the window [0, n) (window column gW + j), as E (bf16: the conv's
// rounded operand; float32: as it is); the rest of a is left as it is
// (zero). src rows hold local columns [-XH, W + XH); reads are clamped to
// the window, whose first and last samples the activation replicates, and
// the post-snake edge rule applies at its ends, as if the window were the
// whole signal. v1 contract: float32 taps and v.
template <typename E>
__device__ void act_tc(const float* src, int lw, E* at, int ra, int C, int W, int gW, int n,
                       const float* alpha, const float* inv_beta, int n_convs, int nconv, float* scr,
                       const dmel::Taps& tp) {
  constexpr int EPC = 16 / sizeof(E);  // values in a 16-byte row of a core matrix
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ve = scr + warp * 2 * TC_LV;
  float* vo = ve + TC_LV;
  const int n_seg = W / TC_SEG;
  const int lo = max(-gW, -TC_XH), hi = min(n - 1 - gW, W + TC_XH - 1);
  for (int u = warp; u < C * n_seg; u += TC_NW) {
    const int c = u / n_seg;
    const int j0 = (u - c * n_seg) * TC_SEG;
    const int g0 = gW + j0;
    if (g0 >= n) continue;  // beyond the window: a stays zero
    const float a = alpha[c * n_convs + nconv];
    const float ib = inv_beta[c * n_convs + nconv];
    const float* row = src + c * lw + TC_XH;
    // positions p = 0 .. TC_NS - 1 are local columns j0 - 3 + p; a lane
    // takes p0 .. p0 + TC_RUN_S - 1 from a window of x at j0 - 6 + p0 + i
    const int p0 = lane * TC_RUN_S;
    float wx[TC_RUN_S + 6];
#pragma unroll
    for (int i = 0; i < TC_RUN_S + 6; ++i) wx[i] = row[dmel::clampi(j0 - 6 + p0 + i, lo, hi)];
#pragma unroll
    for (int q = 0; q < TC_RUN_S; ++q) {
      const int p = p0 + q;
      if (p < TC_NS) {
        ve[p] = dmel::snake(dmel::up_even_w(wx, q, tp), a, ib);
        vo[p] = dmel::snake(dmel::up_odd_w(wx, q, tp), a, ib);
      }
    }
    __syncwarp();
    const int r0 = lane * TC_RUN_R;
    if (r0 < TC_SEG) {
      // the post-snake edge rule: v_e = v_o = v_e at window column 0 before
      // it, v_o at column n - 1 after it
      const int pz = min(max(3 - g0, 0), TC_LV - 1), pl = min(max(n + 2 - g0, 0), TC_LV - 1);
      float ew[TC_RUN_R + 5], ow[TC_RUN_R + 5];
#pragma unroll
      for (int i = 0; i < TC_RUN_R + 5; ++i) {
        const int pe = r0 + 1 + i, po = r0 + i;
        const int ge = g0 - 3 + pe, go = g0 - 3 + po;
        ew[i] = ge < 0 ? ve[pz] : (ge >= n ? vo[pl] : ve[pe]);
        ow[i] = go < 0 ? ve[pz] : (go >= n ? vo[pl] : vo[po]);
      }
      E* ac = at + (c / EPC) * ra * EPC + c % EPC;
#pragma unroll
      for (int q = 0; q < TC_RUN_R; ++q) {
        const int r = r0 + q;
        if (r < TC_SEG) {
          const float v = g0 + r < n ? dmel::down_w(ew, ow, q, tp) : 0.f;
          ac[(TC_PA + j0 + r) * EPC] = from_float<E>(v);
        }
      }
    }
    __syncwarp();
  }
}

// The conv's epilogue for one 64-row tile mt: dst[c][j] (+)= acc + bias[c].
// acc[4 jn + 2 h + e]: row 16 (warp % 4) + g + 8 h, column 8 jn + 2 tq + e.
template <int N, bool ADD>
__device__ __forceinline__ void conv_store(const float (&acc)[N / 2], int mt, float* dst, int lw, const float* bias,
                                           int n_convs, int nconv, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int jn = 0; jn < N / 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = 8 * jn + 2 * tq + e;
      if (co >= C) continue;
      const float b = bias[co * n_convs + nconv];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = dst + co * lw + TC_XH + mt * 64 + 16 * (warp % 4) + g + 8 * h;
        const float v = acc[4 * jn + 2 * h + e];
        *p = ADD ? *p + (v + b) : v + b;
      }
    }
  }
}

// bf16: dst[c][j] (+)= conv(a)[c][j] + bias[c] for j in [0, W): each
// warpgroup takes 64-row tiles mt = g4, g4 + 4, .. and runs wgmma m64nNk16
// over (tap, 16 input channels); tap j's operand is the tile shifted by
// j d - P rows (the descriptor's start address), its weights [KP / 8][N][8]
// in w.
template <int N, bool ADD>
__device__ void conv_tc(uint32_t a_sm, int ra, uint32_t w_sm, float* dst, int lw, const float* bias, int n_convs,
                        int nconv, int C, int KP, int W, int k, int d) {
  const int warp = threadIdx.x >> 5, g4 = warp / 4;
  const int P = d * (k - 1) / 2;
  const uint32_t lbo_a = static_cast<uint32_t>(ra) * 16;
  const int ksteps = KP / 16;
  for (int mt = g4; mt < W / 64; mt += 4) {
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    dmel::fence_operands(acc);
    dmel::wgmma_fence();
    for (int j = 0; j < k; ++j) {
      const uint32_t a0 = a_sm + static_cast<uint32_t>(TC_PA + mt * 64 + j * d - P) * 16;
      const uint32_t b0 = w_sm + static_cast<uint32_t>(j * (KP / 8)) * N * 16;
      for (int kk = 0; kk < ksteps; ++kk) {
        dmel::wgmma<N, 0>(acc, dmel::plain_desc(a0 + 2 * kk * lbo_a, lbo_a, 128),
                          dmel::plain_desc(b0 + 2 * kk * N * 16, N * 16, 128), (j | kk) != 0);
      }
    }
    dmel::wgmma_commit();
    dmel::wgmma_wait<0>();
    dmel::fence_operands(acc);
    conv_store<N, ADD>(acc, mt, dst, lw, bias, n_convs, nconv, C);
  }
}

// float32: the same conv on split-TF32 products. Each warpgroup holds the
// float32 sums of its (at most MT) 64-row tiles g4, g4 + 4, .. through the
// taps; for each tap (weights hi and lo, [2][KP / 4][N][4], from slot
// `stage + j` of the launch's weight stream, `slots` slots in the ring), tile
// and 8 input channels it loads its m64nNk8 A fragments from the float32
// tile (rows j d - P further), splits them (dmel::split_tf32) and issues
// A_hi B_hi, A_hi B_lo and A_lo B_hi into a fresh accumulator, which is then
// added to the tile's sums rounded to nearest (the tensor cores' own sum
// truncates: stage_fused_tf32.cu); thread 0 refills a slot with stage +
// slots once every warpgroup is done with it.
template <int N, int MT, bool ADD>
__device__ void conv_tf32(const float* at, int ra, uint32_t ring, uint32_t bars, int slots, int stage, int n_stages,
                          const float* w, float* dst, int lw, const float* bias, int n_convs, int nconv, int C,
                          int KP, int W, int k, int d) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g4 = warp / 4;
  const int gq = lane / 4, tq = lane % 4;
  const int P = d * (k - 1) / 2;
  const int ksteps = KP / 8, mts = W / 256;
  const uint32_t slot_bytes = 8u * KP * N;
  float acc[MT][N / 2], part[N / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[i][e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) part[e] = 0.f;
  dmel::fence_operands(part);
  for (int j = 0; j < k; ++j) {
    const int g = stage + j, s = g % slots;
    dmel::mbar_wait(bars + 8 * s, (g / slots) & 1);
    const uint32_t bh = ring + s * slot_bytes, bl = bh + slot_bytes / 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < mts) {
        // a[0] at row r, column tq of core-matrix column 2 kk; a[1] 8 rows
        // further, a[2] and a[3] one core-matrix column further
        const float* a0 = at + (TC_PA + (g4 + 4 * i) * 64 + 16 * (warp % 4) + gq + j * d - P) * 4 + tq;
#pragma unroll
        for (int kk = 0; kk < TC_MAX_KP / 8; ++kk) {
          if (kk < ksteps) {
            const float* p = a0 + 2 * kk * ra * 4;
            uint32_t ah[4], al[4];
            dmel::split_tf32(p[0], ah[0], al[0]);
            dmel::split_tf32(p[32], ah[1], al[1]);
            dmel::split_tf32(p[ra * 4], ah[2], al[2]);
            dmel::split_tf32(p[ra * 4 + 32], ah[3], al[3]);
            const uint64_t dh = dmel::plain_desc(bh + 2 * kk * N * 16, N * 16, 128);
            const uint64_t dl = dmel::plain_desc(bl + 2 * kk * N * 16, N * 16, 128);
            dmel::wgmma_fence();
            dmel::wgmma_tf32<N>(part, ah, dh, kk);
            dmel::wgmma_tf32<N>(part, ah, dl, 1);
            dmel::wgmma_tf32<N>(part, al, dh, 1);
          }
        }
        dmel::wgmma_commit();
        dmel::wgmma_wait<0>();
        dmel::fence_operands(part);
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[i][e] += part[e];
      }
    }
    if (g + slots < n_stages) {  // the slot takes a later stage once every group is done with it
      if (tid % 128 == 0) dmel::mbar_arrive(bars + 8 * (slots + s));
      if (tid == 0) {
        dmel::mbar_wait(bars + 8 * (slots + s), (g / slots) & 1);
        dmel::mbar_expect_tx(bars + 8 * s, slot_bytes);
        dmel::bulk_load(ring + s * slot_bytes, w + static_cast<long long>(g + slots) * 2 * KP * N, slot_bytes,
                        bars + 8 * s);
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i < mts) conv_store<N, ADD>(acc[i], g4 + 4 * i, dst, lw, bias, n_convs, nconv, C);
  }
}

// The halo columns [-XH, 0) and [W, W + XH) of a float32 plane from the
// neighbours' edge columns (none beyond the cluster's ends: the activation
// clamps its reads to the window there).
__device__ void pull_cols(float* plane, uint32_t plane_sa, int C, int lw, int W, int rank, int G) {
  for (int i = threadIdx.x; i < C * 4; i += TC_NT) {
    const int c = i >> 2, side = (i >> 1) & 1, h = i & 1;
    const int nb = side ? rank + 1 : rank - 1;
    if (nb < 0 || nb >= G) continue;
    const int from = side ? 4 * h : W - TC_XH + 4 * h;
    const int to = side ? W + 4 * h : -TC_XH + 4 * h;
    const uint4 v = dmel::ld_peer(plane_sa + 4u * (c * lw + TC_XH + from), nb);
    *reinterpret_cast<uint4*>(plane + c * lw + TC_XH + to) = v;
  }
}

// The halo rows [-PA, 0) and [W, W + PA) of the conv input (q_cols columns
// of core matrices, a 16-byte row each) from the neighbours' edge rows
// (zero beyond the cluster's ends, as the conv sees zeros beyond the
// window).
__device__ void pull_rows(unsigned char* at, uint32_t a_sm, int q_cols, int ra, int W, int rank, int G) {
  for (int i = threadIdx.x; i < q_cols * 2 * TC_PA; i += TC_NT) {
    const int q = i / (2 * TC_PA), rr = i % (2 * TC_PA);
    const int side = rr >= TC_PA, r = rr % TC_PA;
    const int nb = side ? rank + 1 : rank - 1;
    if (nb < 0 || nb >= G) continue;
    const int from = side ? r : W - TC_PA + r;
    const int to = side ? W + r : -TC_PA + r;
    const uint4 v = dmel::ld_peer(a_sm + 16u * (q * ra + TC_PA + from), nb);
    *reinterpret_cast<uint4*>(at + 16 * (q * ra + TC_PA + to)) = v;
  }
}

// Tiles along the rows a float32 block's warpgroup holds at most (W / 256
// of them): its sums stay in registers through a conv's taps.
template <int N>
__host__ __device__ constexpr int tf32_max_tiles() {
  return N == 24 ? 4 : (N == 32 ? 2 : 1);
}

// One stage, v1 contract, in E (bf16, or float32 on split-TF32 products). A
// cluster of G CTAs computes a window of G W columns (the S = G W - 2 R it
// stores and R more on each side, clipped to [0, T)); CTA `rank` owns
// window columns [rank W, rank W + W). After every operation the CTAs pull
// their neighbours' edge columns (the conv input's 32 rows, the activation
// input's 8 columns) through distributed shared memory, one cluster barrier
// each, so that only the window's ends compute what is not stored. Each
// stored output goes through the same operations wherever its tile lies.
template <int N, typename E>
__device__ __forceinline__ void stage_v1_body(const E* __restrict__ x, const void* __restrict__ w,
                                              const float* __restrict__ bias, const float* __restrict__ alpha,
                                              const float* __restrict__ inv_beta, E* __restrict__ out,
                                              float* __restrict__ acc_g, int C, int T, int W, int R, int KP,
                                              int kmax, int slots, int parts, const V1Spec& spec,
                                              const dmel::Taps& taps) {
  constexpr bool F32 = sizeof(E) == 4;
  extern __shared__ __align__(128) unsigned char v1_raw[];
  const V1TcLayout L = F32 ? v1tc_layout(C, KP, W, 4, 8u * slots * KP * N, 16u * slots)
                           : v1tc_layout(C, KP, W, 2, 2u * kmax * KP * N, 16);
  const uint32_t raw_sa = static_cast<uint32_t>(__cvta_generic_to_shared(v1_raw));
  const uint32_t base = (raw_sa + 127) & ~127u;
  unsigned char* gbase = v1_raw + (base - raw_sa);
  float* xb = reinterpret_cast<float*>(gbase + L.xb);
  float* tp = reinterpret_cast<float*>(gbase + L.tp);
  unsigned char* at = gbase + L.a;
  float* scr = reinterpret_cast<float*>(gbase + L.scr);
  const uint32_t a_sm = base + L.a, w_sm = base + L.w, bar = base + L.bar;
  const int tid = threadIdx.x;
  const int q_cols = KP * static_cast<int>(sizeof(E)) / 16;  // 16-byte columns of a

  const int rank = static_cast<int>(dmel::cluster_rank()), G = static_cast<int>(dmel::cluster_size());
  const int S = G * W - 2 * R;
  const int t0 = (blockIdx.x / G) * S;
  const int wlo = max(t0 - R, 0);
  const int n = min(t0 + S + R, T) - wlo;  // window columns
  const int gW = rank * W;                 // window column of local column 0
  const bool live = gW < n;
  const int coff = t0 - wlo, nc = min(S, T - t0);  // stored window columns [coff, coff + nc)
  const long long plane = static_cast<long long>(blockIdx.y) * C * T;

  int n_convs = 0, n_taps = 0;
  for (int b = 0; b < spec.n_blk; ++b) {
    n_convs += 2 * spec.n_dil[b];
    n_taps += 2 * spec.n_dil[b] * spec.k[b];
  }
  // float32: the weights stream tap by tap, stage g = the g-th (conv, tap) of the launch
  const bool stream_w = F32 && (parts & 2) && live;
  const int n_stages = stream_w ? n_taps : 0;
  const float* wf = static_cast<const float*>(w);

  for (int i = tid; i < q_cols * L.ra; i += TC_NT) reinterpret_cast<uint4*>(at)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    if constexpr (F32) {
      for (int s = 0; s < slots; ++s) {
        dmel::mbar_init(bar + 8 * s, 1);                 // full: expect_tx + the bytes
        dmel::mbar_init(bar + 8 * (slots + s), TC_NW / 4);  // empty: one arrival per warpgroup
      }
    } else {
      dmel::mbar_init(bar, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    if constexpr (F32) {
      const uint32_t bytes = 8u * KP * N;
      for (int s = 0; s < slots && s < n_stages; ++s) {
        dmel::mbar_expect_tx(bar + 8 * s, bytes);
        dmel::bulk_load(w_sm + s * bytes, wf + static_cast<long long>(s) * 2 * KP * N, bytes, bar + 8 * s);
      }
    } else {
      const uint32_t bytes = 2u * spec.k[0] * KP * N;
      dmel::mbar_expect_tx(bar, bytes);
      dmel::bulk_load(w_sm, w, bytes, bar);
    }
  }

  const float scale = 1.f / static_cast<float>(spec.n_blk);
  int nconv = 0, stage = 0;
  long long woff = 0;
  for (int b = 0; b < spec.n_blk; ++b) {
    const int k = spec.k[b];
    // xb = x on local columns [-XH, W + XH), clamped to the signal
    for (int i = tid; i < C * L.lw; i += TC_NT) {
      const int c = i / L.lw;
      const int col = dmel::clampi(wlo + gW + (i - c * L.lw) - TC_XH, 0, T - 1);
      xb[i] = to_float(x[plane + static_cast<long long>(c) * T + col]);
    }
    __syncthreads();
    for (int p = 0; p < spec.n_dil[b]; ++p) {
      for (int half = 0; half < 2; ++half) {
        float* src = half ? tp : xb;
        float* dst = half ? xb : tp;
        const int d = half ? 1 : spec.dil[b][p];
        if ((parts & 1) && live) {
          act_tc(src, L.lw, reinterpret_cast<E*>(at), L.ra, C, W, gW, n, alpha, inv_beta, n_convs, nconv, scr, taps);
        }
        dmel::cluster_sync();  // every CTA's a is written
        pull_rows(at, a_sm, q_cols, L.ra, W, rank, G);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // a's stores, seen by wgmma
        __syncthreads();
        if constexpr (F32) {
          if (stream_w) {
            constexpr int MT = tf32_max_tiles<N>();
            const float* af = reinterpret_cast<const float*>(at);
            if (half) {
              conv_tf32<N, MT, true>(af, L.ra, w_sm, bar, slots, stage, n_stages, wf, dst, L.lw, bias, n_convs,
                                     nconv, C, KP, W, k, d);
            } else {
              conv_tf32<N, MT, false>(af, L.ra, w_sm, bar, slots, stage, n_stages, wf, dst, L.lw, bias, n_convs,
                                      nconv, C, KP, W, k, d);
            }
          }
          stage += k;
          ++nconv;
          dmel::cluster_sync();  // every CTA's dst is written
        } else {
          dmel::mbar_wait(bar, nconv & 1);  // this conv's weights
          if ((parts & 2) && live) {
            if (half) {
              conv_tc<N, true>(a_sm, L.ra, w_sm, dst, L.lw, bias, n_convs, nconv, C, KP, W, k, d);
            } else {
              conv_tc<N, false>(a_sm, L.ra, w_sm, dst, L.lw, bias, n_convs, nconv, C, KP, W, k, d);
            }
          }
          woff += static_cast<long long>(k) * KP * N;
          ++nconv;
          dmel::cluster_sync();  // every CTA's dst is written and its products are done
          if (tid == 0 && nconv < n_convs) {  // the next conv's weights, while its activation runs
            const int kn = half && p == spec.n_dil[b] - 1 ? spec.k[b + 1] : k;
            const uint32_t bytes = 2u * kn * KP * N;
            dmel::mbar_expect_tx(bar, bytes);
            dmel::bulk_load(w_sm, static_cast<const __nv_bfloat16*>(w) + woff, bytes, bar);
          }
        }
        // the next activation's input halo (xb after a block's last pair is reloaded instead)
        if (!half || p < spec.n_dil[b] - 1) pull_cols(dst, base + (half ? L.xb : L.tp), C, L.lw, W, rank, G);
        __syncthreads();
      }
    }
    // the running sum of the blocks over the stored columns (float32 in
    // acc_g), the mean into out at the last block
    for (int i = tid; i < C * W; i += TC_NT) {
      const int c = i / W, j = i - c * W;
      const int g = gW + j;
      if (g < coff || g >= coff + nc) continue;
      const long long idx = plane + static_cast<long long>(c) * T + wlo + g;
      const float v = xb[c * L.lw + TC_XH + j];
      if (b == spec.n_blk - 1) {
        out[idx] = from_float<E>((b == 0 ? v : acc_g[idx] + v) * scale);
      } else {
        acc_g[idx] = b == 0 ? v : acc_g[idx] + v;
      }
    }
    __syncthreads();
  }
  dmel::cluster_sync();  // no CTA leaves while a peer may still read its shared memory
}

template <int N>
__global__ void __launch_bounds__(TC_NT, 1)
stage_v1_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ alpha,
                   const float* __restrict__ inv_beta, __nv_bfloat16* __restrict__ out, float* __restrict__ acc_g,
                   int C, int T, int W, int R, int KP, int kmax, int parts, V1Spec spec, dmel::Taps taps) {
  stage_v1_body<N, __nv_bfloat16>(x, w, bias, alpha, inv_beta, out, acc_g, C, T, W, R, KP, kmax, 1, parts, spec,
                                  taps);
}

template <int N>
__global__ void __launch_bounds__(TC_NT, 1)
stage_v1_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ alpha, const float* __restrict__ inv_beta, float* __restrict__ out,
                     float* __restrict__ acc_g, int C, int T, int W, int R, int KP, int slots, int parts, V1Spec spec,
                     dmel::Taps taps) {
  stage_v1_body<N, float>(x, w, bias, alpha, inv_beta, out, acc_g, C, T, W, R, KP, 0, slots, parts, spec, taps);
}

template <int N>
int launch_v1(const void* x, const void* w, const float* bias, const float* alpha, const float* inv_beta, void* out,
              float* acc, int B, int C, int T, int W, int R, int KP, int G, int slots, int parts, const V1Spec& spec,
              const dmel::Taps& tp, cudaStream_t stream, int* config) {
  const bool f32 = slots > 0;
  int kmax = 0;
  for (int b = 0; b < spec.n_blk; ++b) kmax = spec.k[b] > kmax ? spec.k[b] : kmax;
  const V1TcLayout l = f32 ? v1tc_layout(C, KP, W, 4, 8u * slots * KP * N, 16u * slots)
                           : v1tc_layout(C, KP, W, 2, 2u * kmax * KP * N, 16);
  const int S = G * W - 2 * R;
  if (l.total > static_cast<uint32_t>(SMEM) || S < 1 || (f32 && W / 256 > tf32_max_tiles<N>())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = f32 ? reinterpret_cast<const void*>(stage_v1_tf32_kernel<N>)
                           : reinterpret_cast<const void*>(stage_v1_tc_kernel<N>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(l.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((T + S - 1) / S * G), static_cast<unsigned>(B));
  cfg.blockDim = dim3(TC_NT);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(G);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (config != nullptr) {
    config[0] = static_cast<int>(cfg.gridDim.x);
    config[1] = static_cast<int>(cfg.gridDim.y);
    config[2] = TC_NT;
    config[3] = static_cast<int>(l.total);
    config[4] = G;
    config[5] = W;
  }
  if (f32) {
    err = cudaLaunchKernelEx(&cfg, stage_v1_tf32_kernel<N>, static_cast<const float*>(x),
                             static_cast<const float*>(w), bias, alpha, inv_beta, static_cast<float*>(out), acc, C, T,
                             W, R, KP, slots, parts, spec, tp);
  } else {
    err = cudaLaunchKernelEx(&cfg, stage_v1_tc_kernel<N>, static_cast<const __nv_bfloat16*>(x),
                             static_cast<const __nv_bfloat16*>(w), bias, alpha, inv_beta,
                             static_cast<__nv_bfloat16*>(out), acc, C, T, W, R, KP, kmax, parts, spec, tp);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int make_spec(V1Spec& spec, int n_blk, const int* ks, const int* n_dils, const int* dils, int max_d) {
  if (n_blk < 1 || n_blk > MAXB || max_d < 1 || max_d > MAXD) return 1;
  spec.n_blk = n_blk;
  for (int b = 0; b < n_blk; ++b) {
    if (n_dils[b] < 1 || n_dils[b] > max_d || ks[b] < 1 || ks[b] % 2 == 0) return 1;
    spec.k[b] = ks[b];
    spec.n_dil[b] = n_dils[b];
    for (int p = 0; p < n_dils[b]; ++p) spec.dil[b][p] = dils[b * max_d + p];
  }
  return 0;
}

}  // namespace

// Bytes of shared memory a block may use in all; the wrapper plans W from it.
extern "C" int dmel_stage_v1_smem_bytes() { return SMEM; }

// One whole stage on [B, C, T] planes (contiguous) on the tensor cores, v1
// contract, in a cluster of G CTAs. bf16 (slots = 0): x, out bf16; w the
// stage's convs one after another in ops/stage_fused.tc_weights' layout
// ([k][KP / 8][N][8] bf16 each, one N block), KP = C rounded up to 16.
// float32 (slots = 2 .. 4 per-tap weight slots): x, out float32; w the
// stage's convs one after another in ops/stage_fused.tf32_weights' layout
// with one K chunk ([k][hi, lo][KP / 4][N][4] float32 each), KP = C rounded
// up to 8 (at most 48). N in {24, 32, 48} >= C. acc: a float32 [B, C, T]
// scratch for the running sum. bias, alpha (exp'd), inv_beta: float32
// [C][n_convs]; taps float32. W: columns a CTA owns (a multiple of 256 up
// to 1024; float32: at most 1024, 512, 256 at N = 24, 32, 48); R: the
// stage's reach per side; G: CTAs per cluster (at most 8); every conv's
// reach at most 32. parts: 3 the stage; the breakdown probe
// (probes/stage_parts.py) drops the activations (2), the convs (1) or both
// (0). config, if not null, receives 6 ints: grid x, grid y, threads,
// shared memory per block, cluster size, W. Returns the first CUDA error (0
// = launched).
extern "C" int dmel_stage_v1_tc(const void* x, const void* w, const float* bias, const float* alpha,
                                const float* inv_beta, void* out, float* acc, int N, int KP, int B, int C, int T,
                                int W, int R, int G, int slots, int n_blk, const int* ks, const int* n_dils,
                                const int* dils, int max_d, const float* taps, int parts, int* config, void* stream) {
  V1Spec spec;
  const int kp_step = slots > 0 ? 8 : 16;
  if (make_spec(spec, n_blk, ks, n_dils, dils, max_d) || C < 1 || C > N || KP < C || KP % kp_step ||
      KP > TC_MAX_KP || B < 1 || B > 65535 || T < 1 || W < 256 || W % 256 || W > 1024 || G < 1 || G > 8 || R < 0 ||
      slots < 0 || slots == 1 || slots > TC_MAX_SLOTS || parts < 0 || parts > 3 ||
      reinterpret_cast<uintptr_t>(w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int b = 0; b < n_blk; ++b) {
    for (int p = 0; p < spec.n_dil[b]; ++p) {
      if (spec.dil[b][p] * (spec.k[b] - 1) / 2 > TC_PA) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 24: return launch_v1<24>(x, w, bias, alpha, inv_beta, out, acc, B, C, T, W, R, KP, G, slots, parts, spec, tp, s, config);
    case 32: return launch_v1<32>(x, w, bias, alpha, inv_beta, out, acc, B, C, T, W, R, KP, G, slots, parts, spec, tp, s, config);
    case 48: return launch_v1<48>(x, w, bias, alpha, inv_beta, out, acc, B, C, T, W, R, KP, G, slots, parts, spec, tp, s, config);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
