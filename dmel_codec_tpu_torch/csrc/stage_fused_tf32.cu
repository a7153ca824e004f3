// K2, float32: one fused act -> conv step of a BigVGAN AMP resblock stage on
// the tensor cores, with split-TF32 products. The bf16 steps run on
// stage_fused_tc.cu; ops/stage_fused.py picks the kernel by dtype, as the
// JAX kernel runs bf16 convs on the matrix unit and float32 at HIGHEST
// (dmel_codec_tpu/ops/stage_fused.py:395-397), whose multi-pass products
// keep float32 accuracy.
//
// Replaces, with stage_fused_tc.cu, the Pallas TPU kernel `_kernel_v2` /
// `fused_amp_stage_v2` (dmel_codec_tpu/ops/stage_fused.py); one launch
// computes
//   out = (conv_{k,d}(act(src)) + bias [+ res] [+ acc_in]) / mean_of
// in float32 and ops/stage_fused.py drives it 18 times per stage (also for
// the v1 contract: in float32 the two contracts are one function).
// act_conv_reference is the plain PyTorch version of one launch.
//
// Bound on the H100: by operations. The C x C x k convs run as three TF32
// products at the dense TF32 rate (about 20 ms of a float32 codec request of
// 16 x 4 s), beside the activation on the CUDA cores (two 6-tap up FIRs, two
// sinf and a 12-tap down FIR per sample and launch) and the float32 planes
// between launches. The CUDA-core kernel this one replaced ran its convs as
// FMA at the float32 rate: 62 % of its 214 ms per request was products,
// 34 % the activation (probes/stage_parts.py).
//
// Design: act_conv_tc_kernel's (stage_fused_tc.cu), with the conv operands
// float32 and each product split.
//  * A block owns BM = 128 output samples of one batch row and N output
//    channels (N = C rounded up to 24, 48, 96 or 192; wider stages take
//    blocks of 192): at N = 192 one block of 4 warpgroups (2 x 2: 64 rows x
//    96 columns each), at N <= 96 two blocks of 2 warpgroups share an SM.
//  * Every warp computes the activation of one input channel of each chunk
//    for the tile and its halo (BM + 2P rows), in float32 with float32 taps
//    and v, into a float32 tile A in the no-swizzle K-major layout
//    [KS / 4][rows][4] (a core matrix is 8 rows of 4 TF32 values, 16 bytes),
//    so tap j's operand is the tile shifted by j d rows. A holds all input
//    channels (KS = KP) up to C = 208; wider stages run their input
//    channels in super-chunks of KS, each its activation, then its
//    products, the sums held in registers throughout.
//  * The products: x = hi + lo with hi = tf32(x), lo = tf32(x - hi)
//    (cvt.rna, dmel::split_tf32), and out += A_hi B_hi + A_hi B_lo +
//    A_lo B_hi (wgmma m64nNk8 .tf32); a product of two TF32 values is exact
//    in float32, so what is lost is A_lo B_lo and the remainders of the
//    split (about 2^-22 of each operand). The tensor cores' sum truncates,
//    so over all 3 x C x k / 8 products of a wide conv in one accumulator
//    the error drifts one way (past the 2e-5 tolerance at C = 96 and 192).
//    So each (tap, K chunk) slot's products go into a fresh accumulator,
//    which is then added to the float32 sums in registers, rounded to
//    nearest. A TF32 operand
//    of wgmma is K-major only, and A hi + lo would not fit shared memory
//    beside the rest at C = 192 (2 x 137 KB): A stays float32 in shared
//    memory, and each warpgroup loads its m64nNk8 fragments into registers
//    and splits them there (A from registers).
//  * B comes split already: the wrapper lays each conv out once as [N
//    block][tap][K chunk][hi, lo][KC / 4][N][4] float32 (zero-padded,
//    ops/stage_fused.tf32_weights), and the TMA unit streams each (tap, K
//    chunk) slot of hi and lo (KC x N x 8 bytes; the whole conv's 3.2 MB at
//    C = 192 does not fit) through a ring of shared-memory slots with full /
//    empty mbarriers while the activation runs; thread 0 refills a slot
//    once every warpgroup is done with it.
//  * The epilogue puts conv + bias into a [N][BM] float32 tile over A and
//    the scratch, adds res and acc_in, divides by mean_of and stores 4
//    consecutive samples a thread.
// Each output's sum runs over (tap, K chunk, 8 channels, the three
// products) in one fixed order wherever its tile starts, so the result does
// not depend on where a window lies. probes/stage_parts.py times the kernel
// with parts removed.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int F_XH = 8;                 // input halo beyond the activation window
constexpr int F_SMEM = 227 * 1024;      // dynamic shared memory one block may ask for
constexpr int F_PAIR_SMEM = 115712;     // per block when two share an SM (228 KB less 2 x 1 KB reserved)
constexpr int F_MAX_P = 32;             // a conv's reach per side, d (k - 1) / 2, at most
constexpr int F_MAX_SLOTS = 32;         // weight slots
constexpr int F_BM = 128;               // output samples per block

// A block's shape (ops/stage_fused.tf32_plan mirrors it): N = 192, one block
// of 16 warps (4 warpgroups, 2 along the rows x 2 along the columns, 48
// float32 sums a thread); N <= 96, two blocks of 8 warps (2 warpgroups
// along the rows, each 64 rows x N) share an SM. A warp computes one channel
// of each activation chunk.
template <int N>
struct F32Cfg {
  static constexpr bool kWide = N >= 128;
  static constexpr int kWarps = kWide ? 16 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroups = kWarps / 4;
  static constexpr int kBlocksPerSM = kWide ? 1 : 2;
  static constexpr int kSmem = kWide ? F_SMEM : F_PAIR_SMEM;
  static constexpr int kCI = kWarps;                      // channels per activation chunk
  static constexpr int kRowGroups = F_BM / 64;
  static constexpr int kWN = N / (kGroups / kRowGroups);  // a group's columns
  static constexpr int kXReg = (F_BM + 2 * F_MAX_P + 2 * F_XH + 31) / 32;  // a lane's input samples
  static constexpr int kRun = ((F_BM + 2 * F_MAX_P + 6 + 31) / 32) | 1;     // a lane's longest run
  static constexpr int kOtp = F_BM + 4;                   // row of the epilogue's [N][kOtp] float32 tile
  static constexpr int kMaxK = N >= 96 ? 1 : (N == 48 ? 2 : 3);  // KC / 8 of a weight slot, at most
};

// Shared memory of a block (ops/stage_fused.tf32_bytes mirrors it): the
// float32 tile A ([KS / 4][rows][4]), the activation scratch (xs [CI][LX],
// ve and vo [CI][LV]), the weight ring (slots of KC x N hi and lo) and its
// full / empty barriers. The epilogue's output tile reuses A and the
// scratch.
struct F32Layout {
  int rows, lx, lv;
  uint32_t scratch, ring, slot_bytes, bars, total;
};

__host__ __device__ inline F32Layout f32_layout(int CI, int P, int KS, int N, int KC, int slots) {
  F32Layout l;
  l.rows = F_BM + 2 * P;
  l.lx = l.rows + 2 * F_XH;
  l.lv = l.rows + 6;
  l.scratch = (static_cast<uint32_t>(KS) * l.rows * 4 + 127) & ~127u;
  l.ring = l.scratch + ((static_cast<uint32_t>(CI) * (l.lx + 2 * l.lv) * 4 + 127) & ~127u);
  const uint32_t ot = static_cast<uint32_t>(N) * (F_BM + 4) * 4;
  l.ring = l.ring > ot ? l.ring : ot;
  l.slot_bytes = static_cast<uint32_t>(KC) * N * 8;
  l.bars = l.ring + slots * l.slot_bytes;
  l.total = l.bars + 16 * slots + 128;  // + the alignment of the base to 128 bytes
  return l;
}

// Input samples lane, lane + 32, ... of channel c of src at times xbase + j
// (replicate-clamped to [0, T); zero past C) into xr.
template <int XR>
__device__ __forceinline__ void load_chunk_f32(float (&xr)[XR], const float* src, long long plane, int c, int C,
                                               int T, int xbase, int lx, int lane) {
  const long long row = plane + static_cast<long long>(c) * T;
#pragma unroll
  for (int r = 0; r < XR; ++r) {
    const int j = lane + 32 * r;
    xr[r] = j < lx && c < C ? src[row + dmel::clampi(xbase + j, 0, T - 1)] : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(F32Cfg<N>::kThreads, F32Cfg<N>::kBlocksPerSM)
act_conv_tf32_kernel(const float* __restrict__ src, const float* __restrict__ w, const float* __restrict__ bias,
                     int bias_stride, const float* __restrict__ alpha, const float* __restrict__ inv_beta,
                     int ab_stride, const float* res, const float* acc_in, float* out, float mean_of, int C, int T,
                     int k, int d, int KP, int KS, int KC, int slots, int vec4, int parts, dmel::Taps taps) {
  using Cfg = F32Cfg<N>;
  constexpr int WN = Cfg::kWN, RUN = Cfg::kRun, OTP = Cfg::kOtp, CI = Cfg::kCI;
  constexpr int PW = WN > 48 ? 48 : WN;  // columns whose products go into one fresh accumulator
  extern __shared__ __align__(128) unsigned char f32_raw[];
  const int P = d * (k - 1) / 2;
  const F32Layout lay = f32_layout(CI, P, KS, N, KC, slots);
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(f32_raw)) + 127) & ~127u;
  unsigned char* gbase = f32_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(f32_raw)));
  const uint32_t ring = base + lay.ring, bars = base + lay.bars;
  float* a_tile = reinterpret_cast<float*>(gbase);
  float* xs = reinterpret_cast<float*>(gbase + lay.scratch);  // [CI][LX]
  float* ve = xs + CI * lay.lx;                               // [CI][LV]
  float* vo = ve + CI * lay.lv;                               // [CI][LV]

  const int n_stages = (parts & 2) ? k * (KP / KC) : 0;
  const int t0 = blockIdx.x * F_BM;
  const int co0 = blockIdx.y * N;
  const long long plane = static_cast<long long>(blockIdx.z) * C * T;
  const long long slot_floats = 2ll * KC * N;
  const float* wb = w + static_cast<long long>(blockIdx.y) * k * KP * N * 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // thread 0 keeps the weight ring full: the first slots now, so that they
  // arrive while the activation runs, each later one when its slot is free
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      dmel::mbar_init(bars + 8 * s, 1);                        // full: expect_tx + the bytes
      dmel::mbar_init(bars + 8 * (slots + s), Cfg::kGroups);  // empty: one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < slots && s < n_stages; ++s) {
      dmel::mbar_expect_tx(bars + 8 * s, lay.slot_bytes);
      dmel::bulk_load(ring + s * lay.slot_bytes, wb + s * slot_floats, lay.slot_bytes, bars + 8 * s);
    }
  }
  __syncthreads();

  // The input channels go in super-chunks of KS (KS = KP unless A would
  // not fit shared memory: C > 208): the activation of a super-chunk into
  // A, then its products.
  const int rows = lay.rows, lx = lay.lx, lv = lay.lv;
  const int abase = t0 - P;          // time of A's row 0
  const int vbase = abase - 3;       // time of ve / vo[.][0]
  const int xbase = abase - F_XH;    // time of xs[.][0]
  const int ci = warp;
  const int n_s = rows + 6;          // half-rate snake positions
  const int run_s = ((n_s + 31) / 32) | 1, run_r = ((rows + 31) / 32) | 1;
  const int s0 = lane * run_s, r0 = lane * run_r;
  const int g4 = warp / 4, wtid = tid % 128, gq = lane / 4, tq = lane % 4;
  const int mrow = 64 * (g4 % Cfg::kRowGroups), ncol = WN * (g4 / Cfg::kRowGroups);
  const int ksteps = KC / 8;  // 1 .. kMaxK
  const int sc_stages = k * (KS / KC);
  float xr[Cfg::kXReg];  // the next chunk's input, loaded while this one computes

  // ---- 1. the activation of every input channel of the super-chunk from
  // sc0 into A (float32): warp ci takes channel ci0 + ci of each chunk; lane
  // runs of consecutive positions from register windows (odd runs: the
  // lanes read distinct banks)
  auto activate = [&](int sc0) {
    for (int ci0 = sc0; ci0 < ((parts & 1) ? sc0 + KS : 0); ci0 += CI) {
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
      if (ci0 + CI < KP) load_chunk_f32(xr, src, plane, ci0 + CI + ci, C, T, xbase, lx, lane);
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
              dmel::snake_phases(xc, xbase, ts, T, taps, a_c, ib_c, 0, e, o);
            } else {
              e = dmel::snake(dmel::up_even_w(wx, q, taps), a_c, ib_c);
              o = dmel::snake(dmel::up_odd_w(wx, q, taps), a_c, ib_c);
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
        const int c = ci0 - sc0 + ci;
        float* ac = a_tile + static_cast<long long>(c / 4) * rows * 4 + c % 4;
#pragma unroll
        for (int q = 0; q < RUN; ++q) {
          const int r = r0 + q, t = abase + r0 + q;
          if (q < run_r && r < rows) ac[r * 4] = live && t >= 0 && t < T ? dmel::down(ew + q, ow + q, taps) : 0.f;
        }
      }
      __syncwarp();  // the warp's scratch is free for its next channel
    }
    __syncthreads();
  };

  // ---- 2. the products of the super-chunk from sc0: group g4 (a
  // warpgroup) owns rows 64 (g4 % kRowGroups) .., columns WN (g4 /
  // kRowGroups) ..; per (tap, K chunk) slot it loads its A fragments (rows
  // j d further down for tap j), splits them and, for PW of its columns at
  // a time, issues A_hi B_hi, A_hi B_lo, A_lo B_hi for each 8 channels into
  // `part`, which starts at zero, then adds `part` to the float32 sums `acc`
  // (rounded to nearest: the tensor cores' own sum truncates, and over all
  // 3 x C x k / 8 products its error would grow past float32's; PW <= 48
  // keeps `acc` and `part` in registers at WN = 96); thread 0 refills each
  // slot once every group is done with it
  auto multiply = [&](int sc0, float (&acc)[WN / 2], float (&part)[PW / 2]) {
    const int it0 = (sc0 / KS) * sc_stages;
    for (int it = it0; it < (n_stages ? it0 + sc_stages : 0); ++it) {
      const int s = it % slots;
      const int j = (it - it0) / (KS / KC), kc = (it - it0) % (KS / KC);
      dmel::mbar_wait(bars + 8 * s, (it / slots) & 1);
      // a[0] at row r of A, column tq of core-matrix column q; a[1] 8 rows
      // further, a[2] and a[3] one core-matrix column further
      const float* a0 =
          a_tile + (static_cast<long long>(kc * KC / 4) * rows + mrow + 16 * (warp % 4) + gq + j * d) * 4 + tq;
      uint32_t ah[Cfg::kMaxK][4], al[Cfg::kMaxK][4];
#pragma unroll
      for (int kk = 0; kk < Cfg::kMaxK; ++kk) {
        if (kk < ksteps) {
          const float* p = a0 + 2ll * kk * rows * 4;
          dmel::split_tf32(p[0], ah[kk][0], al[kk][0]);
          dmel::split_tf32(p[32], ah[kk][1], al[kk][1]);
          dmel::split_tf32(p[rows * 4], ah[kk][2], al[kk][2]);
          dmel::split_tf32(p[rows * 4 + 32], ah[kk][3], al[kk][3]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < WN / PW; ++cc) {  // the group's columns, PW at a time
        const uint32_t bh = ring + s * lay.slot_bytes + (ncol + cc * PW) * 16, bl = bh + lay.slot_bytes / 2;
        dmel::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Cfg::kMaxK; ++kk) {
          if (kk < ksteps) {
            const uint64_t dh = dmel::plain_desc(bh + 2 * kk * N * 16, N * 16, 128);
            const uint64_t dl = dmel::plain_desc(bl + 2 * kk * N * 16, N * 16, 128);
            dmel::wgmma_tf32<PW>(part, ah[kk], dh, kk);
            dmel::wgmma_tf32<PW>(part, ah[kk], dl, 1);
            dmel::wgmma_tf32<PW>(part, al[kk], dh, 1);
          }
        }
        dmel::wgmma_commit();
        dmel::wgmma_wait<0>();
        dmel::fence_operands(part);
#pragma unroll
        for (int i = 0; i < PW / 2; ++i) acc[cc * (PW / 2) + i] += part[i];
      }
      if (it + slots < n_stages) {  // the slot takes a later stage once every group is done with it
        if (wtid == 0) dmel::mbar_arrive(bars + 8 * (slots + s));
        if (tid == 0) {
          dmel::mbar_wait(bars + 8 * (slots + s), (it / slots) & 1);
          dmel::mbar_expect_tx(bars + 8 * s, lay.slot_bytes);
          dmel::bulk_load(ring + s * lay.slot_bytes, wb + (it + slots) * slot_floats, lay.slot_bytes, bars + 8 * s);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every group's products are done: A is free
  };

  if (parts & 1) load_chunk_f32(xr, src, plane, ci, C, T, xbase, lx, lane);
  activate(0);  // the first super-chunk before the sums exist: they hold no registers through it
  float acc[WN / 2], part[PW / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < PW / 2; ++i) part[i] = 0.f;
  dmel::fence_operands(part);
  multiply(0, acc, part);
  for (int sc0 = KS; sc0 < KP; sc0 += KS) {
    activate(sc0);
    multiply(sc0, acc, part);
  }

  // ---- 3. epilogue. acc[4 j + 2 h + e] is row 16 (warp % 4) + g + 8 h,
  // column 8 j + 2 t + e of the group's tile: conv + bias goes to a
  // [N][OTP] float32 tile over A and the scratch, then each thread adds res
  // and acc_in to 4 consecutive samples of one channel and stores them.
  float* ot = reinterpret_cast<float*>(gbase);
  {
    const int m0 = mrow + 16 * (warp % 4) + gq;
#pragma unroll
    for (int jn = 0; jn < WN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ncol + 8 * jn + 2 * tq + e;
        const float b = co0 + col < C ? bias[(co0 + col) * bias_stride] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) ot[col * OTP + m0 + 8 * h] = acc[4 * jn + 2 * h + e] + b;
      }
    }
  }
  __syncthreads();
  const int n_cols = min(N, C - co0);
  for (int i = tid; i < n_cols * (F_BM / 4); i += Cfg::kThreads) {
    const int col = i / (F_BM / 4), m = 4 * (i % (F_BM / 4));
    const int t = t0 + m;
    if (t >= T) continue;
    const long long idx = plane + static_cast<long long>(co0 + col) * T + t;
    const float4 f = *reinterpret_cast<const float4*>(ot + col * OTP + m);
    float v[4] = {f.x, f.y, f.z, f.w};
    if (vec4 && t + 3 < T) {
      if (res != nullptr) dmel::add4(v, res, idx, 0);
      if (acc_in != nullptr) dmel::add4(v, acc_in, idx, 0);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = v[q] / mean_of;
      dmel::store4(out, idx, v, 0);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (t + q >= T) break;
        float u = v[q];
        if (res != nullptr) u += res[idx + q];
        if (acc_in != nullptr) u += acc_in[idx + q];
        out[idx + q] = u / mean_of;
      }
    }
  }
}

template <int N>
int launch_tf32(const float* src, const float* w, const float* bias, int bias_stride, const float* alpha,
                const float* inv_beta, int ab_stride, const float* res, const float* acc_in, float* out,
                float mean_of, int B, int C, int T, int k, int d, int KP, int KS, int KC, int slots, int parts,
                dmel::Taps tp, cudaStream_t stream) {
  using Cfg = F32Cfg<N>;
  const int P = d * (k - 1) / 2;
  const int n_stages = k * (KP / KC);
  const F32Layout lay = f32_layout(Cfg::kCI, P, KS, N, KC, slots);
  // a slot is refilled once every group is done with it, so the ring needs
  // two unless there is one stage
  if (KC > 8 * Cfg::kMaxK || KS % Cfg::kCI || KS % KC || KP % KS || slots < (n_stages < 2 ? n_stages : 2) ||
      slots > F_MAX_SLOTS ||
      lay.total > static_cast<uint32_t>(Cfg::kSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = static_cast<int>(lay.total);
  cudaError_t err = cudaFuncSetAttribute(act_conv_tf32_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + F_BM - 1) / F_BM, (C + N - 1) / N, B);
  // 4 samples a thread in the epilogue where T keeps every 4th sample on 16 bytes of each plane
  const int vec4 = T % 4 == 0 && ((reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(acc_in) |
                                   reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  act_conv_tf32_kernel<N><<<grid, Cfg::kThreads, bytes, stream>>>(
      src, w, bias, bias_stride, alpha, inv_beta, ab_stride, res, acc_in, out, mean_of, C, T, k, d, KP, KS, KC,
      slots, vec4, parts, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One float32 act -> conv step on [B, C, T] float32 planes (all contiguous,
// same shape):  out = (conv_{k,d}(act(src)) + bias [+ res] [+ acc_in]) / mean_of
// w: the conv in the kernel's layout (float32, [C / N blocks][KP / KS][k][KS
// / KC][hi, lo][KC / 4][N][4], zero-padded, hi and lo the split of each
// weight; see ops/stage_fused.tf32_weights), N in {24, 48, 96, 192}, KP = C
// rounded up to the block's warps (8, or 16 at N = 192), KS a multiple of
// the warps and of KC dividing KP (the input channels of a super-chunk: KP
// unless A would not fit), KC a multiple of 8 up to 24, slots the weight
// ring's (ops/stage_fused.tf32_plan). bias, alpha (exp'd),
// inv_beta: float32 columns read as p[c * stride]. res and acc_in may be
// null; out may alias res or acc_in (each element is read before it is
// written, by the same thread), never src. parts: 3 the launch; the
// breakdown probe (probes/stage_parts.py) drops the activation (2: A is
// left as it is), the products and the weight stream (1), or both (0).
// Returns cudaGetLastError() after the launch.
extern "C" int dmel_act_conv_tf32(const float* src, const float* w, int N, int KP, int KS, int KC, int slots,
                                  const float* bias, int bias_stride, const float* alpha, const float* inv_beta,
                                  int ab_stride, const float* res, const float* acc_in, float* out, float mean_of,
                                  int B, int C, int T, int k, int d, const float* taps, int parts, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || T < 1 || k < 1 || d < 1 || d * (k - 1) / 2 > F_MAX_P || KP < C || KP % 8 ||
      KS < 8 || KC < 8 || KC % 8 || parts < 0 || parts > 3 ||
      reinterpret_cast<uintptr_t>(w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DMEL_LAUNCH_TF32(NN)                                                                                      \
  return launch_tf32<NN>(src, w, bias, bias_stride, alpha, inv_beta, ab_stride, res, acc_in, out, mean_of, B, C, T, \
                         k, d, KP, KS, KC, slots, parts, tp, s)
  switch (N) {
    case 24: DMEL_LAUNCH_TF32(24);
    case 48: DMEL_LAUNCH_TF32(48);
    case 96: DMEL_LAUNCH_TF32(96);
    case 192: DMEL_LAUNCH_TF32(192);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DMEL_LAUNCH_TF32
}
