// K5: causal flash attention for multi-head latent attention's expanded
// form (models/deepseek_v3.py `LatentAttention`), bf16 in and out, float32
// scores, softmax and sums. For query (b, s) and head h:
//
//   out[b, s, h, :] = sum_{t <= pos[b, s]} softmax_t(q[b, s, h, :] . k[b, t, h, :] * scale)
//                     . v[b, t, h, :]
//
// with q = [q_nope 128 | roped q_pe 64], k = [k_nope 128 | the heads' shared
// roped k_pe 64] (192 deep) and v 128 wide: the decoder's own mask
// (`Decoder.forward`: key_pos <= positions), computed here from the
// positions instead of read. The plain PyTorch version is
// ops/mla_attention.py `mla_attention_reference`.
//
// It replaces no Pallas kernel: the JAX package has no latent attention.
// The port ran the prefill's attention as a chunked matmul -> float32 cast
// -> scale -> where -> softmax -> bf16 cast -> matmul over [16, 16, 256,
// 4,096] score blocks, five elementwise passes over 1 GiB each for every
// chunk of every layer, and over every cache position past the prompt too.
// Bound on the H100: operations. The two products do 2 x (192 + 128) flops
// per visible (query, key) pair against a few bytes per row; 21.6 TFLOP a
// dialog prefill of 16 x 3,127 positions over 27 layers, 21.9 ms at the
// bf16 peak, where the key and value tiles' bytes take ~8 ms.
//
// Design (a block per 128 queries of one (batch, head), the longest rows of
// each (batch, head) first):
//   * a producer warpgroup (one thread issues, the others give their
//     registers to the consumers: setmaxnreg 40 / 232) keeps a ring of 2
//     stages of K (128 keys x 192) and V (128 keys x 128) tiles full by TMA,
//     straight from the tensors where they lie (k_nope and v are
//     `kv_b_proj`'s output, k_pe the latent cache's rope columns, q_nope /
//     q_pe the projections'; no copy is made), in boxes of 64 columns
//     (128 bytes) x the tile's rows under the 128-byte swizzle, rows past the
//     end zero. K and V complete on mbarriers of their own, so that a
//     stage's products on K start before its V lands, and each is freed
//     once both consumers are done with it (208 KB of shared memory with Q);
//   * two consumer warpgroups of 64 query rows each: S = Q K^T on wgmma
//     m64n128k16 (12 k-steps, both operands K-major in shared memory), the
//     mask and an online softmax on the accumulators in registers (exp2 with
//     the scale folded into one FMA, row max and sum across the 4 lanes of a
//     quad), P rounded to bf16 in registers (as the plain version rounds its
//     probabilities) and O += P V on wgmma with A from registers and V as an
//     MN-major B (its rows, the keys, are the product's depth; 8 k-steps):
//     the accumulator's layout is the A fragment's. The groups take turns
//     at the tensor cores: each turn issues tile j's Q K^T and tile j - 1's
//     P V, then runs tile j's softmax while the other group issues;
//   * key tiles past a block's largest position are never loaded, and the
//     mask runs only on tiles that reach past a row's own position. A
//     skipped key's term is exactly 0 in the plain version (exp of -1e30
//     less the max underflows), so skipping changes the order of a sum, not
//     its terms. Every row sees key 0 (positions >= 0), so its running max
//     is finite after the first tile;
//   * O is normalised once at the end and stored as bf16; each block owns
//     its output rows (no split over keys, no atomics): the same bits on
//     every run.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using dmel_flash::LOG2E;
using dmel_flash::pack_bf16;

constexpr int NOPE = 128, ROPE = 64;  // query / key head: 192 deep
constexpr int QK = NOPE + ROPE;
constexpr int DV = 128;     // value head size
constexpr int BQ = 64;      // query rows of a consumer warpgroup
constexpr int GROUPS = 2;   // consumer warpgroups: 128 query rows a block
constexpr int BK = 128;     // keys of a tile
constexpr int STAGES = 2;
constexpr int BOX = 64;     // columns of a TMA box: 128 bytes, one swizzled row
constexpr int THREADS = 128 * (GROUPS + 1);  // and the producer warpgroup
constexpr uint32_t Q_BOX = BQ * 128;         // bytes of a box of a group's queries
constexpr uint32_t K_BOX = BK * 128;         // of a box of a key or value tile
constexpr uint32_t Q_BYTES = QK / BOX * Q_BOX;  // a group's queries: 24 KB
constexpr uint32_t K_BYTES = QK / BOX * K_BOX;  // 48 KB
constexpr uint32_t V_BYTES = DV / BOX * K_BOX;  // 32 KB
constexpr int N_BARS = 1 + 4 * STAGES;          // q_full; k_full, v_full, k_empty, v_empty a stage
constexpr uint32_t SMEM_BYTES = GROUPS * Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 8 * N_BARS + 16 + 1024;
static_assert(SMEM_BYTES <= 232448, "K5's shared memory");

struct Maps {  // TMA maps: q_nope, q_pe, k_nope, v as [B, rows, H, columns]; k_pe as [B, T, 64]
  CUtensorMap qn, qp, kn, kp, v;
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The two consumer groups take turns at the tensor cores (named barriers 1
// and 2 over their 256 threads): one issues its products while the other
// runs its softmax.
__device__ __forceinline__ void turn_wait(int grp) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + grp) : "memory");
}

__device__ __forceinline__ void turn_pass(int grp) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - grp) : "memory");
}

// One consumer's view of the block: its rows' positions and the softmax state.
struct Rows {
  int pos[2];  // rows g and g + 8 of the warp's 16, clamped to [0, T - 1]
  int pmin;
  float m[2], l[2];  // running max (exp2 domain) and this lane's part of the sum
};

// Tile j's scores sc (64 rows x 128 keys, the accumulator layout) -> P in
// pa (bf16 A fragments), the running max and sum, and O's correction: the
// mask only where the tile reaches past a row's position; p = exp2(score *
// scale * log2 e - m).
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4], float (&o)[DV / 2],
                                             Rows& rw, int n0, int t, float sl2) {
  const bool edge = n0 + BK - 1 > rw.pmin;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jn = 0; jn < BK / 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge && n0 + 8 * jn + 2 * t + (e & 1) > rw.pos[e >> 1]) sc[4 * jn + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * jn + e]);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(rw.m[r], mx[r] * sl2);  // finite from the first tile on (key 0)
    corr[r] = ex2(rw.m[r] - mn);
    rw.m[r] = mn;
    rw.l[r] *= corr[r];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p[e] = ex2(fmaf(sc[8 * kk + e], sl2, -rw.m[(e >> 1) & 1]));  // exactly 0 where masked
      rw.l[(e >> 1) & 1] += p[e];
    }
    pa[kk][0] = pack_bf16(p[0], p[1]);
    pa[kk][1] = pack_bf16(p[2], p[3]);
    pa[kk][2] = pack_bf16(p[4], p[5]);
    pa[kk][3] = pack_bf16(p[6], p[7]);
  }
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// S = Q K^T of one stage: 12 k-steps of 16, both operands K-major, 4 to a
// swizzled 128-byte row
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2], uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < QK / 16; ++kk)
    dmel::wgmma<BK, 0>(sc, dmel::sw128_desc(qa + (kk / 4) * Q_BOX + (kk % 4) * 32, 16, 1024),
                       dmel::sw128_desc(kb + (kk / 4) * K_BOX + (kk % 4) * 32, 16, 1024), kk != 0);
}

// O += P V of one stage: 8 k-steps of 16 keys, P from registers; V's rows
// (the keys) are the depth: an MN-major B of two 64-column boxes
__device__ __forceinline__ void issue_values(float (&o)[DV / 2], const uint32_t (&pa)[BK / 16][4], uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    dmel::wgmma_rs_128<1>(o, pa[kk], dmel::sw128_desc(vb + kk * 16 * 128, K_BOX, 1024), 1);
}

__global__ void __launch_bounds__(THREADS, 1)
mla_attention_kernel(const __grid_constant__ Maps maps, const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
                     int S, int T, int H, float sl2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's atoms
  const uint32_t q_sm = base;
  const uint32_t k_sm = q_sm + GROUPS * Q_BYTES;
  const uint32_t v_sm = k_sm + STAGES * K_BYTES;
  const uint32_t bars = v_sm + STAGES * V_BYTES;
  const uint32_t q_full = bars;
  int* top = reinterpret_cast<int*>(smem_raw + (bars - raw) + 8 * N_BARS);  // the block's largest position
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * STAGES + s); };

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ * GROUPS;

  if (tid == 0) {
    dmel::mbar_init(q_full, 1);  // the producer's expect_tx and the bytes
    for (int s = 0; s < STAGES; ++s) {
      dmel::mbar_init(k_full(s), 1);
      dmel::mbar_init(v_full(s), 1);
      dmel::mbar_init(k_empty(s), GROUPS);  // one arrival per consumer group
      dmel::mbar_init(v_empty(s), GROUPS);
    }
    *top = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < BQ * GROUPS) {
    const int row = q0 + tid;
    atomicMax(top, row < S ? min(max(pos[static_cast<long long>(b) * S + row], 0), T - 1) : 0);
  }
  __syncthreads();
  const int n_tiles = *top / BK + 1;  // key tiles 0 .. the one holding the largest position

  if (tid >= 128 * GROUPS) {
    // ---- the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 128 * GROUPS) {
      dmel::mbar_expect_tx(q_full, GROUPS * Q_BYTES);
      for (int grp = 0; grp < GROUPS; ++grp) {
        const uint32_t dst = q_sm + grp * Q_BYTES;
        const int row = q0 + grp * BQ;
        dmel::tma_load4(dst, &maps.qn, q_full, 0, h, row, b);
        dmel::tma_load4(dst + Q_BOX, &maps.qn, q_full, BOX, h, row, b);
        dmel::tma_load4(dst + 2 * Q_BOX, &maps.qp, q_full, 0, h, row, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t freed = ((j / STAGES) & 1) ^ 1;  // passes at once on a fresh barrier
        dmel::mbar_wait(k_empty(s), freed);
        dmel::mbar_expect_tx(k_full(s), K_BYTES);
        const uint32_t kd = k_sm + s * K_BYTES;
        dmel::tma_load4(kd, &maps.kn, k_full(s), 0, h, j * BK, b);
        dmel::tma_load4(kd + K_BOX, &maps.kn, k_full(s), BOX, h, j * BK, b);
        dmel::tma_load(kd + 2 * K_BOX, &maps.kp, k_full(s), 0, j * BK, b);
        dmel::mbar_wait(v_empty(s), freed);
        dmel::mbar_expect_tx(v_full(s), V_BYTES);
        const uint32_t vd = v_sm + s * V_BYTES;
        dmel::tma_load4(vd, &maps.v, v_full(s), 0, h, j * BK, b);
        dmel::tma_load4(vd + K_BOX, &maps.v, v_full(s), BOX, h, j * BK, b);
      }
    }
  } else {
    // ---- a consumer warpgroup: rows q0 + 64 grp + 16 warp + g (+ 8) of
    // the accumulators' layout (acc[4 j + 2 r + e]: row g + 8 r, column
    // 8 j + 2 t + e)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int grp = tid / 128, wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + grp * BQ + warp * 16 + g;
    Rows rw;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      rw.pos[r] = row < S ? min(max(pos[static_cast<long long>(b) * S + row], 0), T - 1) : 0;
      rw.m[r] = -INFINITY;
      rw.l[r] = 0.f;
    }
    rw.pmin = min(rw.pos[0], rw.pos[1]);
    const uint32_t qa = q_sm + grp * Q_BYTES;

    float o[DV / 2], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    uint32_t pa[BK / 16][4];  // the last tile's P as the A fragments of P V, rounded to bf16
    if (grp == 1) turn_pass(grp);  // group 0 goes first
    dmel::mbar_wait(q_full, 0);

    // Turn j issues S = Q K^T of tile j and O += P V of tile j - 1, then
    // runs tile j's softmax while the other group takes its turn; O takes
    // tile j's correction once tile j - 1's product is in it. The first and
    // the last turn are peeled (no product under a branch).
    dmel::mbar_wait(k_full(0), 0);
    turn_wait(grp);
    dmel::wgmma_fence();
    issue_scores(sc, qa, k_sm);
    dmel::wgmma_commit();
    turn_pass(grp);
    dmel::wgmma_wait<0>();
    dmel::fence_operands(sc);
    if (wtid == 0) dmel::mbar_arrive(k_empty(0));
    softmax_tile(sc, pa, o, rw, 0, t, sl2);

    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      dmel::mbar_wait(k_full(s), (j / STAGES) & 1);
      dmel::mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);
      turn_wait(grp);
      dmel::wgmma_fence();
      issue_scores(sc, qa, k_sm + s * K_BYTES);
      issue_values(o, pa, v_sm + sp * V_BYTES);
      dmel::wgmma_commit();
      turn_pass(grp);
      dmel::wgmma_wait<0>();
      dmel::fence_operands(sc);
      dmel::fence_operands(o);
      if (wtid == 0) {
        dmel::mbar_arrive(k_empty(s));
        dmel::mbar_arrive(v_empty(sp));
      }
      softmax_tile(sc, pa, o, rw, j * BK, t, sl2);
    }

    const int sl = (n_tiles - 1) % STAGES;
    dmel::mbar_wait(v_full(sl), ((n_tiles - 1) / STAGES) & 1);
    turn_wait(grp);
    dmel::wgmma_fence();
    issue_values(o, pa, v_sm + sl * V_BYTES);
    dmel::wgmma_commit();
    if (grp == 0) turn_pass(grp);  // group 1's last pass would open no turn
    dmel::wgmma_wait<0>();
    dmel::fence_operands(o);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = rw.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float inv = 1.f / l;
      __nv_bfloat16* dst = out + ((static_cast<long long>(b) * S + row) * H + h) * DV + 2 * t;
#pragma unroll
      for (int jn = 0; jn < DV / 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jn) =
            __floats2bfloat162_rn(o[4 * jn + 2 * r] * inv, o[4 * jn + 2 * r + 1] * inv);
    }
  }
}

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

// A bf16 map of `rank` dims (dims[0] the contiguous columns; strides in
// elements, of dims 1..) in boxes of 64 columns x box[1..] under the
// 128-byte swizzle; what lies outside reads as zero.
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const long long* strides,
              const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t bytes[3];
  for (int i = 0; i + 1 < rank; ++i) bytes[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, bytes, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q_nope [B, S, H, 128], q_pe [B, S, H, 64], k_nope [B, T, H, 128], k_pe
// [B, T, 64] (the heads' shared rope key), v [B, T, H, 128]: bf16, each row
// contiguous and starting on 16 bytes, laid out by `strides` (elements:
// q_nope's batch, position and head strides, q_pe's, k_nope's, k_pe's batch
// and position strides, v's batch, position and head strides; 14, each a
// multiple of 8); pos: int32 [B, S] contiguous, each >= 0 (a position past
// T - 1 sees every key); out: bf16 [B, S, H, 128] contiguous. nope, rope and
// v_dim must be 128, 64 and 128; B and H at most 65535. scale multiplies
// q . k. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for sizes it was not built for or a layout TMA does not take).
extern "C" int dmel_mla_attention(const void* q_nope, const void* q_pe, const void* k_nope, const void* k_pe,
                                  const void* v, const void* pos, void* out, const long long* strides, int B,
                                  int S, int T, int H, int nope, int rope, int v_dim, float scale, void* stream) {
  if (nope != NOPE || rope != ROPE || v_dim != DV || B < 1 || S < 1 || T < 1 || H < 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = strides;  // qn b, s, h; qp b, s, h; kn b, t, h; kp b, t; v b, t, h
  const cuuint64_t ub = B, us = S, ut = T, uh = H;
  Maps m;
  const cuuint64_t qn_dims[4] = {NOPE, uh, us, ub}, qp_dims[4] = {ROPE, uh, us, ub};
  const cuuint64_t kn_dims[4] = {NOPE, uh, ut, ub}, kp_dims[3] = {ROPE, ut, ub}, v_dims[4] = {DV, uh, ut, ub};
  const long long qn_st[3] = {st[2], st[1], st[0]}, qp_st[3] = {st[5], st[4], st[3]};
  const long long kn_st[3] = {st[8], st[7], st[6]}, kp_st[2] = {st[10], st[9]}, v_st[3] = {st[13], st[12], st[11]};
  const cuuint32_t q_box[4] = {BOX, 1, BQ, 1}, k_box[4] = {BOX, 1, BK, 1}, kp_box[3] = {BOX, BK, 1};
  if (!make_map(&m.qn, q_nope, 4, qn_dims, qn_st, q_box) || !make_map(&m.qp, q_pe, 4, qp_dims, qp_st, q_box) ||
      !make_map(&m.kn, k_nope, 4, kn_dims, kn_st, k_box) || !make_map(&m.kp, k_pe, 3, kp_dims, kp_st, kp_box) ||
      !make_map(&m.v, v, 4, v_dims, v_st, k_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(mla_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((S + BQ * GROUPS - 1) / (BQ * GROUPS)), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  mla_attention_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), S, T, H, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
