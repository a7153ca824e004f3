// K2, bf16: one fused act -> conv step of a BigVGAN AMP resblock stage on
// the tensor cores (wgmma). The float32 steps run on the split-TF32 kernel
// of stage_fused_tf32.cu; ops/stage_fused.py picks the kernel by dtype, as the JAX
// kernel runs its bf16 convs on the matrix unit (`mm_dtype = bfloat16`,
// dmel_codec_tpu/ops/stage_fused.py:396-397) and float32 at HIGHEST.
//
// Replaces, with stage_fused_tf32.cu, the Pallas TPU kernel `_kernel_v2` /
// `fused_amp_stage_v2` (dmel_codec_tpu/ops/stage_fused.py); one launch
// computes
//   out = (round(conv_{k,d}(act(src)) + bias) [+ res] [+ acc_in]) / mean_of
// and ops/stage_fused.py drives it 18 times per stage. act_conv_reference is
// the plain PyTorch version of one launch.
//
// Bound on the H100: by operations, the C x C x k convs at the bf16
// tensor-core rate (about 1.8 TFLOP per stage at C = 192), beside the
// activation at the float32 rate (per sample and launch two 6-tap up FIRs,
// two sinf, one 12-tap down FIR) and the planes between launches (about 10
// bytes per sample and launch). What sets the time is the activation on the
// CUDA cores: about 60 % of a launch, the products 20 %, the stores 15 %
// (probes/stage_parts.py on the flagship's stages).
//
// Design. A block owns BM output samples of one batch row and N of the
// output channels (all of C_out up to 192; wider stages take several
// blocks of 192), with 16 warps and 128 registers a thread on each SM
// (TcCfg): at N >= 128 one block of 4 warpgroups, at N <= 96 two blocks of
// 2. The conv is a GEMM per tap j: M = time, N = C_out, K = C_in,
// D[t][co] += A_j[t][ci] B_j[ci][co] with A_j[t][ci] =
// act(src)[ci][t0 + t + j d - P] and B_j = w[j] ([C_out][C_in], K-major).
//  1. Every warp computes the activation of one input channel of each
//     chunk (as many channels as the block has warps; the chunk loop needs
//     no block barrier) for the
//     tile and its halo, BM + 2P rows, into a bf16 tile A in wgmma's
//     no-swizzle K-major layout [C_in / 8][rows][8]: a core matrix is 8
//     consecutive rows of 16 bytes, so tap j's operand is the same tile
//     shifted by j d rows and only the descriptor's start address moves
//     (any d, no copy). The warp's input rows pass through float32 shared
//     memory (prefetched into registers while the chunk before computes);
//     each lane then takes a run of consecutive snake positions, and of
//     outputs of the down FIR, from register windows (odd runs: the lanes
//     read distinct banks). Padded input channels are zero.
//  2. Meanwhile the TMA unit streams the weights by 1-D bulk copies
//     through a ring of shared-memory slots (full / empty mbarriers; thread
//     0 issues the first slots at the start and refills each when all
//     warpgroups are done with it): the wrapper lays each conv out once as
//     [N block][tap][K chunk][K chunk / 8][N][8] bf16, zero-padded, so
//     every (tap, K chunk) is one contiguous copy in the order the products
//     read them.
//  3. Each warpgroup runs wgmma.mma_async m64nWNk16 (A and B K-major from
//     shared memory, float32 sums in registers) for 64 rows x WN columns
//     (WN = N / 2 at N = 128 and 192, else N) over (tap, K chunk, 16
//     channels), one commit group per slot. (Issuing a K step's products
//     while the next step's activation runs, in one block, was slower:
//     the sums then hold their registers through the activation, which
//     spills.)
//  4. The epilogue puts round(conv + bias) into a [N][BM] float32 tile over
//     A and the scratch, then adds res and acc_in, divides by mean_of and
//     stores 4 consecutive samples a thread (a warp: 128 samples of one
//     channel, 16 bytes a lane).
// Each output's sum runs over (tap, K) in one fixed order wherever its
// tile starts, so the result does not depend on where a window lies.
// probes/stage_parts.py times the kernel with parts removed.
//
// Numeric contracts (both on bf16 planes). v2 (plane_bf16 = 1, the
// default): the activation's input, its taps (rounded by the wrapper), the
// snake's output v and the conv's output are rounded to bf16, as the JAX v2
// kernel's banded bf16 matmuls and bf16 planes (stage_fused.py:398-403,
// 500-519). v1 (plane_bf16 = 0; `use_v2=False` at stages wider than K2-v1
// takes): float32 input, taps, v and planes; only the conv operands are
// bf16 (stage_fused.py:145-149, 231-268). Arithmetic is float32 and the
// activation's output is always a bf16 operand of the tensor cores.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TC_XH = 8;                      // input halo beyond the activation window
constexpr int TC_SMEM = 227 * 1024;           // dynamic shared memory one block may ask for
constexpr int TC_PAIR_SMEM = 115712;          // per block when two share an SM (228 KB less 2 x 1 KB reserved)
constexpr int TC_MAX_KSTEPS = 6;              // KC / 16 of a weight slot, at most
constexpr int TC_MAX_P = 32;                  // a conv's reach per side, d (k - 1) / 2, at most
constexpr int TC_MAX_SLOTS = 32;              // weight slots: every stage of a narrow conv at once

// A block's shape: 16 warps per SM in all, 128 registers a thread. Wide
// (N >= 128): one block of 4 warpgroups; at N = 128 and 192 it owns 128
// output samples and each group 64 rows x N / 2 columns (N / 4 float32
// sums a thread), at N = 160 256 samples and 64 rows x N a group. Narrow
// (N <= 96): two blocks of 2 warpgroups share an SM (3 % faster on the
// flagship's narrow stages than one block of 4 with 256 samples), each
// with 128 samples, a group 64 rows x N. A warp computes one channel of
// each activation chunk. Lanes take runs of consecutive positions, odd in
// length so that a warp's lanes read distinct banks.
template <int N>
struct TcCfg {
  static constexpr bool kWide = N >= 128;
  static constexpr int kWarps = kWide ? 16 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroups = kWarps / 4;              // warpgroups
  static constexpr int kBlocksPerSM = kWide ? 1 : 2;
  static constexpr int kSmem = kWide ? TC_SMEM : TC_PAIR_SMEM;
  static constexpr int kCI = kWarps;                      // channels per activation chunk
  static constexpr bool kSplit = N == 128 || N == 192;
  static constexpr int kBM = kWide && !kSplit ? 256 : 128;  // output samples per block
  static constexpr int kRowGroups = kBM / 64;             // groups along the rows
  static constexpr int kWN = kSplit ? N / 2 : N;          // a group's columns
  static constexpr int kXReg = (kBM + 2 * TC_MAX_P + 2 * TC_XH + 31) / 32;  // a lane's input samples
  static constexpr int kRun = ((kBM + 2 * TC_MAX_P + 6 + 31) / 32) | 1;     // a lane's longest run
  static constexpr int kOtp = kBM + 4;                    // row of the epilogue's [N][kOtp] float32 tile
};

// Shared memory of a block: the bf16 tile A ([KP / 8][rows][8]), the
// float32 activation scratch (xs [CI][LX], ve and vo [CI][LV]), the weight
// ring (slots of KC x N bf16) and its full / empty barriers. After the
// products the epilogue reuses A and the scratch for the output tile.
struct TcLayout {
  int rows, lx, lv;
  uint32_t scratch, ring, slot_bytes, bars, total;
};

__host__ __device__ inline TcLayout tc_layout(int BM, int CI, int P, int KP, int N, int KC, int slots) {
  TcLayout l;
  l.rows = BM + 2 * P;
  l.lx = l.rows + 2 * TC_XH;
  l.lv = l.rows + 6;
  l.scratch = (static_cast<uint32_t>(KP) * l.rows * 2 + 127) & ~127u;
  l.ring = l.scratch + ((static_cast<uint32_t>(CI) * (l.lx + 2 * l.lv) * 4 + 127) & ~127u);
  const uint32_t ot = static_cast<uint32_t>(N) * (BM + 4) * 4;
  l.ring = l.ring > ot ? l.ring : ot;
  l.slot_bytes = static_cast<uint32_t>(KC) * N * 2;
  l.bars = l.ring + slots * l.slot_bytes;
  l.total = l.bars + 16 * slots + 128;  // + the alignment of the base to 128 bytes
  return l;
}

// Input samples lane, lane + 32, ... of channel c of src at times xbase + j
// (replicate-clamped to [0, T); zero past C) into xr.
template <int XR>
__device__ __forceinline__ void load_chunk(float (&xr)[XR], const void* src, int src_bf16, int plane_bf16,
                                           long long plane, int c, int C, int T, int xbase, int lx, int lane) {
  const long long row = plane + static_cast<long long>(c) * T;
#pragma unroll
  for (int r = 0; r < XR; ++r) {
    const int j = lane + 32 * r;
    float v = 0.f;
    if (j < lx && c < C) v = dmel::round_to(dmel::load_f(src, row + dmel::clampi(xbase + j, 0, T - 1), src_bf16), plane_bf16);
    xr[r] = v;
  }
}

template <int N>
__global__ void __launch_bounds__(TcCfg<N>::kThreads, TcCfg<N>::kBlocksPerSM)
act_conv_tc_kernel(const void* __restrict__ src, int src_bf16, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, int bias_stride, const float* __restrict__ alpha,
                   const float* __restrict__ inv_beta, int ab_stride, const void* res, int res_bf16,
                   const float* acc_in, void* out, int out_bf16, float mean_of, int plane_bf16, int C,
                   int T, int k, int d, int KP, int KC, int slots, int vec4, int parts, dmel::Taps taps) {
  using Cfg = TcCfg<N>;
  constexpr int BM = Cfg::kBM, WN = Cfg::kWN, RUN = Cfg::kRun, OTP = Cfg::kOtp, CI = Cfg::kCI;
  extern __shared__ __align__(128) unsigned char tc_raw[];
  const int P = d * (k - 1) / 2;
  const TcLayout lay = tc_layout(BM, CI, P, KP, N, KC, slots);
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(tc_raw)) + 127) & ~127u;
  unsigned char* gbase = tc_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(tc_raw)));
  const uint32_t a_sm = base, ring = base + lay.ring, bars = base + lay.bars;
  __nv_bfloat16* a_tile = reinterpret_cast<__nv_bfloat16*>(gbase);
  float* xs = reinterpret_cast<float*>(gbase + lay.scratch);  // [CI][LX]
  float* ve = xs + CI * lay.lx;                               // [CI][LV]
  float* vo = ve + CI * lay.lv;                               // [CI][LV]

  const int kchunks = KP / KC;
  const int n_stages = (parts & 2) ? k * kchunks : 0;
  const int t0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * N;
  const long long plane = static_cast<long long>(blockIdx.z) * C * T;
  const __nv_bfloat16* wb = w + static_cast<long long>(blockIdx.y) * k * KP * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // thread 0 keeps the weight ring full: the first slots now, so that they
  // arrive while the activation runs, each later one when its slot is free
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      dmel::mbar_init(bars + 8 * s, 1);                                  // full: expect_tx + the bytes
      dmel::mbar_init(bars + 8 * (slots + s), Cfg::kGroups);            // empty: one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < slots && s < n_stages; ++s) {
      dmel::mbar_expect_tx(bars + 8 * s, lay.slot_bytes);
      dmel::bulk_load(ring + s * lay.slot_bytes, wb + static_cast<long long>(s) * KC * N, lay.slot_bytes, bars + 8 * s);
    }
  }
  __syncthreads();

  // ---- 1. the activation of every input channel into A: warp ci takes
  // channel ci0 + ci of each chunk; lane runs of consecutive positions
  // from register windows (odd runs: the lanes read distinct banks)
  const int rows = lay.rows, lx = lay.lx, lv = lay.lv;
  const int abase = t0 - P;          // time of A's row 0
  const int vbase = abase - 3;       // time of ve / vo[.][0]
  const int xbase = abase - TC_XH;   // time of xs[.][0]
  const int ci = warp;
  const int n_s = rows + 6;          // half-rate snake positions
  const int run_s = ((n_s + 31) / 32) | 1, run_r = ((rows + 31) / 32) | 1;
  const int s0 = lane * run_s, r0 = lane * run_r;
  float xr[Cfg::kXReg];  // the next chunk's input, loaded while this one computes
  if (parts & 1) load_chunk(xr, src, src_bf16, plane_bf16, plane, ci, C, T, xbase, lx, lane);
  for (int ci0 = 0; ci0 < ((parts & 1) ? KP : 0); ci0 += CI) {
    const bool live = ci0 + ci < C;  // channels past C are zero
    const float a_c = live ? alpha[(ci0 + ci) * ab_stride] : 0.f;
    const float ib_c = live ? inv_beta[(ci0 + ci) * ab_stride] : 0.f;
    float* xc = xs + ci * lx;
    float* ec = ve + ci * lv;
    float* oc = vo + ci * lv;
#pragma unroll
    for (int r = 0; r < Cfg::kXReg; ++r) {
      if (lane + 32 * r < lx) xc[lane + 32 * r] = xr[r];
    }
    __syncwarp();
    if (ci0 + CI < KP) load_chunk(xr, src, src_bf16, plane_bf16, plane, ci0 + CI + ci, C, T, xbase, lx, lane);
    if (live) {  // both snake phases at positions s0 .. s0 + run_s - 1 (time vbase + s)
      float wx[RUN + 6];
#pragma unroll
      for (int j = 0; j < RUN + 6; ++j) wx[j] = s0 + 2 + j < lx ? xc[s0 + 2 + j] : 0.f;
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        const int s = s0 + q, ts = vbase + s0 + q;
        if (q < run_s && s < n_s) {
          float e, o;
          if (ts < 0 || ts >= T) {  // the post-snake edge rules
            dmel::snake_phases(xc, xbase, ts, T, taps, a_c, ib_c, plane_bf16, e, o);
          } else {
            e = dmel::round_to(dmel::snake(dmel::up_even_w(wx, q, taps), a_c, ib_c), plane_bf16);
            o = dmel::round_to(dmel::snake(dmel::up_odd_w(wx, q, taps), a_c, ib_c), plane_bf16);
          }
          ec[s] = e;
          oc[s] = o;
        }
      }
    }
    __syncwarp();
    {  // the down FIR at rows r0 .. r0 + run_r - 1 (time abase + r), into A
      float ew[RUN + 6], ow[RUN + 6];
#pragma unroll
      for (int j = 0; j < RUN + 6; ++j) {
        ew[j] = live && r0 + j < n_s ? ec[r0 + j] : 0.f;
        ow[j] = live && r0 + j < n_s ? oc[r0 + j] : 0.f;
      }
      const int c = ci0 + ci;
      __nv_bfloat16* ac = a_tile + static_cast<long long>(c / 8) * rows * 8 + c % 8;
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        const int r = r0 + q, t = abase + r0 + q;
        if (q < run_r && r < rows) {
          const float v = live && t >= 0 && t < T ? dmel::down(ew + q, ow + q, taps) : 0.f;
          ac[r * 8] = __float2bfloat16(v);
        }
      }
    }
    __syncwarp();  // the warp's scratch is free for its next channel
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // A's stores, seen by wgmma
  __syncthreads();

  // ---- 2. the products: group g4 (a warpgroup) owns rows 64 (g4 % kRowGroups) ..,
  // columns WN (g4 / kRowGroups) ..; thread 0 refills each slot once every
  // group is done with it
  const int g4 = warp / 4, wtid = tid % 128;
  const int mrow = 64 * (g4 % Cfg::kRowGroups), ncol = WN * (g4 / Cfg::kRowGroups);
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_lbo = static_cast<uint32_t>(rows) * 16;
  const int ksteps = KC / 16;  // 1 .. TC_MAX_KSTEPS
  dmel::fence_operands(acc);
  for (int it = 0; it < n_stages; ++it) {
    const int s = it % slots;
    const int j = it / kchunks, kc = it % kchunks;
    dmel::mbar_wait(bars + 8 * s, (it / slots) & 1);
    const uint32_t a0 = a_sm + static_cast<uint32_t>(kc * KC / 8) * a_lbo + static_cast<uint32_t>(mrow + j * d) * 16;
    const uint32_t b0 = ring + s * lay.slot_bytes + ncol * 16;
    dmel::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_MAX_KSTEPS; ++kk) {
      if (kk < ksteps) {
        dmel::wgmma<WN, 0>(acc, dmel::plain_desc(a0 + 2 * kk * a_lbo, a_lbo, 128),
                           dmel::plain_desc(b0 + 2 * kk * N * 16, N * 16, 128), (it | kk) != 0);
      }
    }
    dmel::wgmma_commit();
    dmel::fence_operands(acc);
    // the previous stage's slot takes a later stage: once its products are
    // done (a conv whose stages all fit the ring issues them back to back)
    if (it > 0 && it - 1 + slots < n_stages) {
      dmel::wgmma_wait<1>();
      dmel::fence_operands(acc);
      const int prev = (it - 1) % slots;
      if (wtid == 0) dmel::mbar_arrive(bars + 8 * (slots + prev));
      if (tid == 0) {
        dmel::mbar_wait(bars + 8 * (slots + prev), ((it - 1) / slots) & 1);
        dmel::mbar_expect_tx(bars + 8 * prev, lay.slot_bytes);
        dmel::bulk_load(ring + prev * lay.slot_bytes, wb + static_cast<long long>(it - 1 + slots) * KC * N,
                        lay.slot_bytes, bars + 8 * prev);
      }
      __syncwarp();
    }
  }
  dmel::wgmma_wait<0>();
  dmel::fence_operands(acc);

  // ---- 3. epilogue. acc[4 j + 2 h + e] is row 16 (warp % 4) + g + 8 h,
  // column 8 j + 2 t + e of the group's tile: round(conv + bias) goes to a
  // [N][OTP] float32 tile over A and the scratch, then each thread adds res
  // and acc_in to 4 consecutive samples of one channel (a warp: 128
  // samples, 16 bytes a lane) and stores them.
  __syncthreads();  // every group's products are done: A is free
  float* ot = reinterpret_cast<float*>(gbase);
  {
    const int g = lane / 4, tq = lane % 4;
    const int m0 = mrow + 16 * (warp % 4) + g;
#pragma unroll
    for (int jn = 0; jn < WN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ncol + 8 * jn + 2 * tq + e;
        const float b = co0 + col < C ? bias[(co0 + col) * bias_stride] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) ot[col * OTP + m0 + 8 * h] = dmel::round_to(acc[4 * jn + 2 * h + e] + b, plane_bf16);
      }
    }
  }
  __syncthreads();
  const int n_cols = min(N, C - co0);
  for (int i = tid; i < n_cols * (BM / 4); i += Cfg::kThreads) {
    const int col = i / (BM / 4), m = 4 * (i % (BM / 4));
    const int t = t0 + m;
    if (t >= T) continue;
    const long long idx = plane + static_cast<long long>(co0 + col) * T + t;
    const float4 f = *reinterpret_cast<const float4*>(ot + col * OTP + m);
    float v[4] = {f.x, f.y, f.z, f.w};
    if (vec4 && t + 3 < T) {
      if (res != nullptr) dmel::add4(v, res, idx, res_bf16);
      if (acc_in != nullptr) dmel::add4(v, acc_in, idx, 0);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = v[q] / mean_of;
      dmel::store4(out, idx, v, out_bf16);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (t + q >= T) break;
        float u = v[q];
        if (res != nullptr) u += dmel::load_f(res, idx + q, res_bf16);
        if (acc_in != nullptr) u += acc_in[idx + q];
        dmel::store_f(out, idx + q, u / mean_of, out_bf16);
      }
    }
  }
}

template <int N>
int launch_tc(const void* src, int src_bf16, const __nv_bfloat16* w, const float* bias, int bias_stride,
              const float* alpha, const float* inv_beta, int ab_stride, const void* res, int res_bf16,
              const float* acc_in, void* out, int out_bf16, float mean_of, int plane_bf16, int B, int C, int T,
              int k, int d, int KP, int KC, int parts, dmel::Taps tp, cudaStream_t stream) {
  using Cfg = TcCfg<N>;
  const int P = d * (k - 1) / 2;
  const int n_stages = k * (KP / KC);
  const TcLayout none = tc_layout(Cfg::kBM, Cfg::kCI, P, KP, N, KC, 0);
  const int fit = (Cfg::kSmem - static_cast<int>(none.total)) / static_cast<int>(none.slot_bytes + 16);
  const int slots = std::min(std::min(fit, TC_MAX_SLOTS), n_stages);
  // a slot is freed one stage late (its products may still run), so the
  // ring needs two unless there is one stage
  if (slots < std::min(2, n_stages)) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(tc_layout(Cfg::kBM, Cfg::kCI, P, KP, N, KC, slots).total);
  cudaError_t err = cudaFuncSetAttribute(act_conv_tc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + Cfg::kBM - 1) / Cfg::kBM, (C + N - 1) / N, B);
  // 4 samples a thread in the epilogue where T keeps every 4th sample on 16 bytes of each plane
  const int vec4 = T % 4 == 0 && ((reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(acc_in) |
                                   reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  act_conv_tc_kernel<N><<<grid, Cfg::kThreads, bytes, stream>>>(
      src, src_bf16, w, bias, bias_stride, alpha, inv_beta, ab_stride, res, res_bf16, acc_in, out, out_bf16,
      mean_of, plane_bf16, C, T, k, d, KP, KC, slots, vec4, parts, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One bf16 act -> conv step on [B, C, T] planes (all contiguous, same
// shape):  out = (round(conv_{k,d}(act(src)) + bias) [+ res] [+ acc_in]) / mean_of
// src, res: float32 (flag 0) or bfloat16 (flag 1); acc_in float32; out
// float32 or bfloat16. w: the conv in the kernel's layout (bf16,
// [C / N blocks][k][KP / KC][KC / 8][N][8], zero-padded; see
// ops/stage_fused.tc_weights), N in {24, 32, 48, 64, 96, 128, 160, 192}, KP =
// C rounded up to 16, KC a multiple of 16 dividing KP. bias, alpha (exp'd),
// inv_beta: float32 columns read as p[c * stride]. res and acc_in may be
// null; out may alias res or acc_in (each element is read before it is
// written, by the same thread), never src. plane_bf16: 1 the v2 contract
// (taps passed rounded to bf16), 0 v1's. parts: 3 the launch; the
// breakdown probe (probes/stage_parts.py) drops the activation (2: A is
// left as it is), the products and the weight stream (1), or both (0).
// Returns cudaGetLastError() after the launch.
extern "C" int dmel_act_conv_tc(const void* src, int src_bf16, const void* w, int N, int KP, int KC,
                                const float* bias, int bias_stride, const float* alpha, const float* inv_beta,
                                int ab_stride, const void* res, int res_bf16, const float* acc_in, void* out,
                                int out_bf16, float mean_of, int plane_bf16, int B, int C, int T, int k, int d,
                                const float* taps, int parts, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || T < 1 || k < 1 || d < 1 || d * (k - 1) / 2 > TC_MAX_P || KP < C ||
      KP % 16 || KC < 16 || KC % 16 || KC > 16 * TC_MAX_KSTEPS || KP % KC || parts < 0 || parts > 3 ||
      reinterpret_cast<uintptr_t>(w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
#define DMEL_LAUNCH_TC(NN)                                                                                    \
  return launch_tc<NN>(src, src_bf16, wb, bias, bias_stride, alpha, inv_beta, ab_stride, res, res_bf16, acc_in, \
                       out, out_bf16, mean_of, plane_bf16, B, C, T, k, d, KP, KC, parts, tp, s)
  switch (N) {
    case 24: DMEL_LAUNCH_TC(24);
    case 32: DMEL_LAUNCH_TC(32);
    case 48: DMEL_LAUNCH_TC(48);
    case 64: DMEL_LAUNCH_TC(64);
    case 96: DMEL_LAUNCH_TC(96);
    case 128: DMEL_LAUNCH_TC(128);
    case 160: DMEL_LAUNCH_TC(160);
    case 192: DMEL_LAUNCH_TC(192);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DMEL_LAUNCH_TC
}
