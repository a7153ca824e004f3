// K3, float32: one dilated conv1d of a BigVGAN AMP resblock on the tensor
// cores, with split-TF32 products and K2's epilogue:
//   out = (conv_{k,d}(a) + bias [+ res] [+ acc_in]) / mean_of
// on channels-first [B, C, T] float32 planes, `a` being K1's output (the
// anti-aliased snake, csrc/anti_alias.cu). ops/stage_conv.py drives it 18
// times a stage, after K1 each time, along K2's launch plan: the stages too
// wide for K2's fused activation (s0, C = 768, and s1, C = 384, of the
// 24 kHz vocoder) in float32. stage_conv_reference is the plain PyTorch
// version of one launch.
//
// Replaces, for those stages, the XLA convs behind the JAX
// `bigvgan_apply_fused` "block" route (dmel_codec_tpu/models/bigvgan.py:
// the resblocks of stages wider than fuse_max_channels, one conv per
// activation, at Precision.HIGHEST in float32), which the port had left to
// cuDNN's float32 implicit GEMM on the CUDA cores.
//
// Bound on the H100: by operations. A conv is a GEMM of M = B T output
// samples, N = C output channels and K = C k taps x input channels:
// 2 C^2 k B T model flops, run as three TF32 products (hi hi, hi lo, lo hi)
// at 494.7 TFLOP/s, so 165 TFLOP/s of model work at most (67 on the CUDA
// cores). The weights (C^2 k hi + lo: 52 MB for one k = 11 conv at C = 768)
// do not stay in shared memory and stream from L2 for every tile; an
// output tile of BM samples reads BM / 4 flops a byte of them, so the tile
// is as long in time as one TMA box of the activation allows (BM = 192).
//
// Design:
//  * A block owns BM = 64 WGS output samples of one batch row and BN
//    output channels (BN = 64 or 128), WGS consumer warpgroups (one per 64
//    samples) and one producer warp; the launch's grid walks output
//    channels fastest, so that the blocks in flight share their rows of
//    the activation and, chunk by chunk, their weights in L2.
//    ops/stage_conv.conv_plan picks (WGS, BN): the widest tile whose count
//    fills the SMs, else the narrowest, so that short inputs (a 1 s clip
//    at B = 1) still spread over the card.
//  * The producer warp keeps two rings full by TMA, each slot with a full
//    and an empty mbarrier: the activation, 16 input channels x S rows a
//    slot (one box of a tensor map over [B, C, T]: the tile and the
//    conv's reach on both sides, from the 16-byte boundary at or before
//    its first time, since a box must start on one; times outside [0, T)
//    and channels past C read as zero, which is the conv's zero padding),
//    and the weights, one
//    (16 input channels, tap) slot of hi and lo for the BN columns (bulk
//    copies of the layout ops/stage_conv.conv_weights packs once). One
//    activation slot serves all k taps: tap j reads it j d rows further.
//  * TF32 wgmma takes K-major operands from shared memory only, and the
//    activation tile is time-major. So A comes from registers: each
//    thread loads its m64nNk8 fragments straight from the [16][S] tile
//    (S = 8 mod 16 floats a row: the 32 lanes hit 32 banks), splits them
//    into hi = tf32(x) and lo = tf32(x - hi) (dmel::split_tf32) and issues
//    A_hi B_hi + A_hi B_lo + A_lo B_hi (wgmma m64n64k8 .tf32) per 64
//    columns. The tensor cores' own sum truncates, so each slot's six
//    products go into a fresh accumulator that is then added to float32
//    sums in registers (rounded to nearest), as K2 does.
//  * The epilogue puts conv + bias into a [BN][BM + 4] float32 tile over
//    the rings, then each thread adds res and acc_in to 4 consecutive
//    samples of one channel, divides by mean_of and stores them.
// Every output's sum runs over (16-channel chunk, tap, 8 channels, the
// three products) in one fixed order wherever its tile lies, with no
// atomics: the same bits from run to run.
#include <cuda.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int K3_KC = 16;                             // input channels a slot: two k-steps of 8
constexpr int K3_NB = 64;                             // output channels a weight block and a fresh accumulator
constexpr int K3_A_SLOTS = 3;                         // activation slots
constexpr int K3_B_SLOTS = 8;                         // weight slots
constexpr int K3_MAX_S = 256;                         // rows of an activation slot (one TMA box), at most
constexpr int K3_A_SLOT_BYTES = K3_KC * K3_MAX_S * 4;  // 16 KB
constexpr int K3_BLK_BYTES = K3_KC * K3_NB * 8;        // one weight block of a slot, hi + lo: 8 KB
constexpr int K3_SMEM = 227 * 1024;

// A block's shape and shared memory (ops/stage_conv.conv_smem_bytes
// mirrors it): the activation ring, the weight ring, their barriers; the
// epilogue's [BN][BM + 4] tile reuses the rings.
template <int WGS, int BN>
struct K3Cfg {
  static constexpr int kBM = 64 * WGS;
  static constexpr int kThreads = 128 * WGS + 32;
  static constexpr int kBlocks = BN / K3_NB;
  static constexpr int kBSlotBytes = kBlocks * K3_BLK_BYTES;
  static constexpr int kARing = K3_A_SLOTS * K3_A_SLOT_BYTES;
  static constexpr int kRings = kARing + K3_B_SLOTS * kBSlotBytes;
  static constexpr int kOtp = kBM + 4;
  static constexpr int kOut = BN * kOtp * 4;
  static constexpr int kBars = kRings > kOut ? kRings : kOut;
  static constexpr int kSmem = kBars + 16 * (K3_A_SLOTS + K3_B_SLOTS) + 128;  // + the base's alignment
  static_assert(kSmem <= K3_SMEM, "K3's block does not fit shared memory");
};

// Keeps A fragments in their registers until here: wgmma reads them
// asynchronously, after the instruction that the compiler sees use them.
__device__ __forceinline__ void hold(const uint32_t (&r)[2][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" ::"r"(r[i / 4][i % 4]) : "memory");
}

template <int WGS, int BN>
__global__ void __launch_bounds__(K3Cfg<WGS, BN>::kThreads, 1)
stage_conv_tf32_kernel(const __grid_constant__ CUtensorMap amap, const float* __restrict__ w,
                       const float* __restrict__ bias, const float* res, const float* acc_in, float* out,
                       float mean_of, int C, int T, int k, int d, int S, int nch, int vec4) {
  using Cfg = K3Cfg<WGS, BN>;
  constexpr int BM = Cfg::kBM, OTP = Cfg::kOtp;
  extern __shared__ __align__(128) unsigned char k3_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(k3_raw));
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* gbase = k3_raw + (base - raw);
  const uint32_t a_ring = base, b_ring = base + Cfg::kARing;
  const uint32_t full_a = base + Cfg::kBars, empty_a = full_a + 8 * K3_A_SLOTS;
  const uint32_t full_b = empty_a + 8 * K3_A_SLOTS, empty_b = full_b + 8 * K3_B_SLOTS;

  const int P = d * (k - 1) / 2;
  const int co0 = blockIdx.x * BN, t0 = blockIdx.y * BM, b = blockIdx.z;
  const int lead = (t0 - P) & 3;  // a box starts on 16 bytes: row `lead` of a slot is time t0 - P
  const int nb0 = co0 / K3_NB;
  const int blocks = min(Cfg::kBlocks, (C + K3_NB - 1) / K3_NB - nb0);  // weight blocks this tile holds
  const int n_stages = nch * k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K3_A_SLOTS; ++s) {
      dmel::mbar_init(full_a + 8 * s, 1);     // the producer's expect_tx + the bytes
      dmel::mbar_init(empty_a + 8 * s, WGS);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < K3_B_SLOTS; ++s) {
      dmel::mbar_init(full_b + 8 * s, 1);
      dmel::mbar_init(empty_b + 8 * s, WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
  if (warp == 4 * WGS) {
    // ---- the producer warp: one lane issues every copy, each into a slot
    // its last readers have released
    if (lane == 0) {
      int it = 0;
      for (int c = 0; c < nch; ++c) {
        const int sa = c % K3_A_SLOTS;
        dmel::mbar_wait(empty_a + 8 * sa, ((c / K3_A_SLOTS) & 1) ^ 1);
        dmel::mbar_expect_tx(full_a + 8 * sa, static_cast<uint32_t>(K3_KC) * S * 4);
        dmel::tma_load(a_ring + sa * K3_A_SLOT_BYTES, &amap, full_a + 8 * sa, t0 - P - lead, c * K3_KC, b);
        for (int j = 0; j < k; ++j, ++it) {
          const int sb = it % K3_B_SLOTS;
          dmel::mbar_wait(empty_b + 8 * sb, ((it / K3_B_SLOTS) & 1) ^ 1);
          dmel::mbar_expect_tx(full_b + 8 * sb, static_cast<uint32_t>(blocks) * K3_BLK_BYTES);
          for (int q = 0; q < blocks; ++q) {
            const float* src = w + (static_cast<long long>(nb0 + q) * n_stages + it) * (K3_BLK_BYTES / 4);
            dmel::bulk_load(b_ring + sb * Cfg::kBSlotBytes + q * K3_BLK_BYTES, src, K3_BLK_BYTES, full_b + 8 * sb);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup g: rows 64 g .. 64 g + 63 of the tile. Per
    // (chunk, tap) slot: its A fragments for both k-steps (rows j d
    // further for tap j), split; then per 64 columns the six products into
    // `part` (the first overwrites it), added to `acc` once they are done.
    const int g = warp / 4, gq = lane / 4, tq = lane % 4;
    const int row = 64 * g + 16 * (warp % 4) + gq;  // of the output tile; `lead` + row + j d of a slot
    const bool leader = threadIdx.x % 128 == 0;
    float part[K3_NB / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < K3_NB / 2; ++i) part[i] = 0.f;
    dmel::fence_operands(part);
    const float* a_tiles = reinterpret_cast<const float*>(gbase);
    int it = 0;
    for (int c = 0; c < nch; ++c) {
      const int sa = c % K3_A_SLOTS;
      dmel::mbar_wait(full_a + 8 * sa, (c / K3_A_SLOTS) & 1);
      const float* at = a_tiles + sa * (K3_A_SLOT_BYTES / 4) + tq * S + lead + row;
      for (int j = 0; j < k; ++j, ++it) {
        const int sb = it % K3_B_SLOTS;
        // a[0] row r, channel tq; a[1] row r + 8; a[2], a[3] channel tq + 4
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* p = at + j * d + 8 * kk * S;
          dmel::split_tf32(p[0], ah[kk][0], al[kk][0]);
          dmel::split_tf32(p[8], ah[kk][1], al[kk][1]);
          dmel::split_tf32(p[4 * S], ah[kk][2], al[kk][2]);
          dmel::split_tf32(p[4 * S + 8], ah[kk][3], al[kk][3]);
        }
        dmel::mbar_wait(full_b + 8 * sb, (it / K3_B_SLOTS) & 1);
        __syncwarp();  // wgmma is .aligned: the warp issues it converged
#pragma unroll
        for (int q = 0; q < Cfg::kBlocks; ++q) {
          if (q < blocks) {
            // the block's slot: [hi, lo][KC / 4][64][4]; k-step kk at 2 kk core-matrix columns
            const uint32_t bh = b_ring + sb * Cfg::kBSlotBytes + q * K3_BLK_BYTES, bl = bh + K3_BLK_BYTES / 2;
            dmel::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const uint64_t dh = dmel::plain_desc(bh + 2 * kk * K3_NB * 16, K3_NB * 16, 128);
              const uint64_t dl = dmel::plain_desc(bl + 2 * kk * K3_NB * 16, K3_NB * 16, 128);
              dmel::wgmma_tf32<K3_NB>(part, ah[kk], dh, kk);
              dmel::wgmma_tf32<K3_NB>(part, ah[kk], dl, 1);
              dmel::wgmma_tf32<K3_NB>(part, al[kk], dh, 1);
            }
            dmel::wgmma_commit();
            dmel::wgmma_wait<0>();
            dmel::fence_operands(part);
            hold(ah);
            hold(al);
#pragma unroll
            for (int i = 0; i < K3_NB / 2; ++i) acc[q * (K3_NB / 2) + i] += part[i];
          }
        }
        if (leader) {
          dmel::mbar_arrive(empty_b + 8 * sb);
          if (j == k - 1) dmel::mbar_arrive(empty_a + 8 * sa);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();  // every product is done: the rings are free

  // ---- epilogue. acc[32 q + 4 j + 2 h + e] is row 16 (warp % 4) + gq + 8 h
  // of the group's 64, column 64 q + 8 j + 2 tq + e: conv + bias into a
  // [BN][OTP] float32 tile, then each thread adds res and acc_in to 4
  // consecutive samples of one channel and stores them.
  float* ot = reinterpret_cast<float*>(gbase);
  if (warp < 4 * WGS) {
    const int gq = lane / 4, tq = lane % 4;
    const int row = 64 * (warp / 4) + 16 * (warp % 4) + gq;
#pragma unroll
    for (int q = 0; q < Cfg::kBlocks; ++q) {
#pragma unroll
      for (int jn = 0; jn < K3_NB / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = K3_NB * q + 8 * jn + 2 * tq + e;
          const float bv = co0 + col < C ? bias[co0 + col] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) ot[col * OTP + row + 8 * h] = acc[q * (K3_NB / 2) + 4 * jn + 2 * h + e] + bv;
        }
      }
    }
  }
  __syncthreads();
  const int n_cols = min(BN, C - co0);
  for (int i = threadIdx.x; i < n_cols * (BM / 4); i += Cfg::kThreads) {
    const int col = i / (BM / 4), m = 4 * (i % (BM / 4));
    const int t = t0 + m;
    if (t >= T) continue;
    const long long idx = (static_cast<long long>(b) * C + co0 + col) * T + t;
    const float4 f = *reinterpret_cast<const float4*>(ot + col * OTP + m);
    float v[4] = {f.x, f.y, f.z, f.w};
    if (vec4 && t + 3 < T) {
      if (res != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(res + idx);
        v[0] += r.x, v[1] += r.y, v[2] += r.z, v[3] += r.w;
      }
      if (acc_in != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(acc_in + idx);
        v[0] += r.x, v[1] += r.y, v[2] += r.z, v[3] += r.w;
      }
      *reinterpret_cast<float4*>(out + idx) = make_float4(v[0] / mean_of, v[1] / mean_of, v[2] / mean_of,
                                                          v[3] / mean_of);
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

// The activation's tensor map: [B, C, Ta] float32 (Ta a multiple of 4, so
// that each row starts on 16 bytes) in boxes of S times x 16 channels x 1
// row, no swizzle; what lies outside the tensor reads as zero.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

bool activation_map(CUtensorMap* map, const float* a, int B, int C, int Ta, int S) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Ta), static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * 4, dims[0] * dims[1] * 4};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(S), K3_KC, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(a), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WGS, int BN>
int launch_conv(const float* a, int B, int C, int T, int Ta, const float* w, const float* bias, const float* res,
                const float* acc_in, float* out, float mean_of, int k, int d, cudaStream_t stream) {
  using Cfg = K3Cfg<WGS, BN>;
  const int P = d * (k - 1) / 2;
  // rows of an activation slot: the tile, the reach on both sides and up
  // to 3 rows of lead (a box starts on 16 bytes), rounded up to 8 mod 16
  // (the fragment loads' banks)
  const int S = (Cfg::kBM + 2 * P + 3 + 7) / 16 * 16 + 8;
  if (S > K3_MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap;
  if (!activation_map(&amap, a, B, C, Ta, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(stage_conv_tf32_kernel<WGS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + BN - 1) / BN, (T + Cfg::kBM - 1) / Cfg::kBM, B);
  // 4 samples a thread in the epilogue where T keeps every 4th sample on 16 bytes of each plane
  const int vec4 = T % 4 == 0 && ((reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(acc_in) |
                                   reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  stage_conv_tf32_kernel<WGS, BN><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      amap, w, bias, res, acc_in, out, mean_of, C, T, k, d, S, (C + K3_KC - 1) / K3_KC, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One float32 K3 launch: out = (conv_{k,d}(a) + bias [+ res] [+ acc_in]) /
// mean_of, the conv zero-padded by d (k - 1) / 2 on both sides (k odd).
// a: [B, C, Ta] float32 with Ta >= T a multiple of 4 (columns T.. zero),
// 16-byte aligned; res, acc_in (may be null), out: [B, C, T] float32,
// contiguous; out may alias res or acc_in (each element is read before it
// is written, by the same thread), never a. w: the conv in
// ops/stage_conv.conv_weights' layout, [ceil(C / 64)][ceil(C / 16)][k][hi,
// lo][4][64][4] float32, 16-byte aligned. bias: [C] float32. (wgs, bn):
// consumer warpgroups and output channels of a block, (3, 128), (3, 64) or
// (1, 64) (ops/stage_conv.conv_plan). Returns cudaGetLastError() after the
// launch.
extern "C" int dmel_stage_conv_tf32(const float* a, int B, int C, int T, int Ta, const float* w, const float* bias,
                                    const float* res, const float* acc_in, float* out, float mean_of, int k, int d,
                                    int wgs, int bn, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || T < 1 || Ta < T || Ta % 4 || k < 1 || k % 2 == 0 || d < 1 ||
      (T + 63) / 64 > 65535 || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgs == 3 && bn == 128) return launch_conv<3, 128>(a, B, C, T, Ta, w, bias, res, acc_in, out, mean_of, k, d, s);
  if (wgs == 3 && bn == 64) return launch_conv<3, 64>(a, B, C, T, Ta, w, bias, res, acc_in, out, mean_of, k, d, s);
  if (wgs == 1 && bn == 64) return launch_conv<1, 64>(a, B, C, T, Ta, w, bias, res, acc_in, out, mean_of, k, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
