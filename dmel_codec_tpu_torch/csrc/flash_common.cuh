// Tiling shared by the flash-attention kernels: the forward
// (flash_attention.cu) and the two backward kernels (flash_attention_bwd.cu).
//
// CUDA-core tiles (FA-dKV's float32 path): a block of 128 threads works on
// 64 x 64 tiles of the [queries, keys] score matrix. The threads form a
// 16 x 8 grid: thread (ty, tx) owns rows ty + 16 i (i < 4) and columns
// tx + 8 j (j < 8) of a tile, so the 8 lanes that share a row sit in one
// warp. Operand tiles lie in shared memory as float32 rows of HD + 4
// floats: the float4 reads along a row (a product over the head dimension)
// and the float2 reads across rows (a product over the tile's other index)
// are both free of bank conflicts.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace dmel_flash {

constexpr int BM = 64;       // rows of a tile
constexpr int BN = 64;       // columns of a tile (== BM: the diagonal tile shows each row a key)
constexpr int THREADS = 128;
constexpr int TX = 8;        // threads across a tile's columns
constexpr int TY = 16;       // threads down its rows
constexpr int RI = BM / TY;  // rows per thread, r = ty + TY * i
constexpr int CJ = BN / TX;  // columns per thread, c = tx + TX * j
constexpr int PS = BN + 4;   // row stride of a [64, 64] tile in shared memory

// Rows [row0, row0 + 64) of head `head` of a float32 [B, S, NH, HD] tensor
// into dst[r * stride + d]; rows at or beyond S are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src,
                                          long long b, int S, int NH, int head,
                                          int row0) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int s = row0 + r;
    dst[r * stride + d] = s < S ? src[((b * S + s) * NH + head) * HD + d] : 0.f;
  }
}

// ---- bf16 tensor-core tiles (the bf16 paths of FA and FA-dKV) -------------
//
// Operand tiles stay bf16 in shared memory as rows of HD + 8 values: a row
// is 16-byte aligned, and the 8 rows an ldmatrix phase reads start 4 banks
// apart, so `cp.async` stores and `ldmatrix` loads are free of bank
// conflicts. Products run on mma.sync.m16n8k16 (bf16 in, float32 sums).
// Fragments (g = lane / 4, t = lane % 4): A 16 x 16 row-major {(g, 2t..),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)}, B 16 x 8 {(2t.., g),
// (2t + 8.., g)}, C 16 x 8 {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of head `head` of a bf16 [B, S, NH, HD] tensor
// into dst (row stride HD + 8), asynchronously; rows at or beyond S are
// zero. The caller commits and waits.
template <int HD, int NT>
__device__ __forceinline__ void stage_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long b, int S, int NH, int head,
                                                int row0) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int s = row0 + r;
    const bool valid = s < S;
    const __nv_bfloat16* from = src + (((b * S + (valid ? s : 0)) * NH + head) * HD + 8 * c);
    cp_async16(dst + r * (HD + 8) + 8 * c, from, valid);
  }
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives one 32-bit register of each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a row-major
// tile (row stride ld bf16): the matrix is the A operand as stored.
__device__ __forceinline__ void ldsm_a(unsigned (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int c0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  ldsm_x4(a, tile + (r0 + (mi & 1) * 8 + l % 8) * ld + c0 + (mi >> 1) * 8);
}

// B fragments of two 8-column tiles whose columns are rows [n0, n0 + 16)
// of a row-major tile and whose depth is its columns [k0, k0 + 16)
// (B = tile^T: K for Q K^T). b[0], b[1] for n0; b[2], b[3] for n0 + 8.
__device__ __forceinline__ void ldsm_bt(unsigned (&b)[4], const __nv_bfloat16* tile, int ld,
                                        int n0, int k0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  ldsm_x4(b, tile + (n0 + (mi >> 1) * 8 + l % 8) * ld + k0 + (mi & 1) * 8);
}

// B fragments of two 8-column tiles that are columns [n0, n0 + 16) of a
// row-major tile, depth its rows [k0, k0 + 16) (B = tile: V for P V).
// b[0], b[1] for n0; b[2], b[3] for n0 + 8.
__device__ __forceinline__ void ldsm_b(unsigned (&b)[4], const __nv_bfloat16* tile, int ld,
                                       int k0, int n0) {
  const int l = threadIdx.x % 32, mi = l / 8;
  ldsm_x4_trans(b, tile + (k0 + (mi & 1) * 8 + l % 8) * ld + n0 + (mi >> 1) * 8);
}

// The A fragments of P (16 rows x 16 k) from two C tiles of a 16 x 64 score
// block, rounded to bf16: k-step kk takes score tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void c_to_a(unsigned (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ---- float32 tensor-core tiles (the float32 paths of FA and FA-dQ) --------
//
// Split-TF32: each float32 operand x = hi + lo + r with hi = tf32(x), lo =
// tf32(x - hi) and |r| <= 2^-22 |x| (dmel::split_tf32), and a product A B
// runs as A_lo B_hi + A_hi B_lo + A_hi B_hi, small terms first, on
// mma.sync.m16n8k8 .tf32 with float32 sums (A_lo B_lo, 2^-22 relative, is
// left out). A warp owns 16 rows; its A fragments of a static operand (Q,
// dO) are read from a float32 tile and split per k-step, where one split
// feeds 8 column tiles. K and V change per key tile and each of their
// values feeds every warp, so the block splits a tile once into hi and lo
// tiles (`stage_tiles_f32`). Every tile is float32 rows of HD + 4 (TS,
// 4 or 20 banks apart): the reads of an A fragment and of a B fragment
// along a row, (n = g, k = t), hit banks 4g + t (or 20g + t), and those
// down two rows, (k = 2t / 2t + 1, n = g), banks 8t + g and 8t + 4 + g (mod
// 32): free of conflicts both ways.
// Fragments (g = lane / 4, t = lane % 4): A 16 x 8 {(g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)}, B 8 x 8 {(t, g), (t + 4, g)}, C 16 x 8 as
// m16n8k16's. So a C tile of scores is no A fragment of P as it stands;
// it is one if the tile's 8 keys take the k order {0, 2, 4, 6, 1, 3, 5, 7}
// (k slot t holds key 2t, slot t + 4 key 2t + 1): then a = (c0, c2, c1, c3)
// and the B operand (V in P V, K in dS K) reads keys 2t and 2t + 1. A sum
// does not depend on its order, so this is exact.

constexpr int TF32_THREADS = 128;  // a warp per 16 query rows: 64 rows per block

// c += a . b, TF32 operands, float32 sums
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                              unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b as the three split-TF32 products, small terms first
__device__ __forceinline__ void mma_split(float (&c)[4], const unsigned (&ah)[4],
                                          const unsigned (&al)[4], const unsigned (&bh)[2],
                                          const unsigned (&bl)[2]) {
  mma_1688_tf32(c, al, bh[0], bh[1]);
  mma_1688_tf32(c, ah, bl[0], bl[1]);
  mma_1688_tf32(c, ah, bh[0], bh[1]);
}

template <int N>
__device__ __forceinline__ void split_n(const float (&x)[N], unsigned (&hi)[N], unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) dmel::split_tf32(x[i], hi[i], lo[i]);
}

// The split A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 8) of a
// float32 tile with row stride ld.
__device__ __forceinline__ void lds_a_split(unsigned (&hi)[4], unsigned (&lo)[4], const float* tile,
                                            int ld, int r0, int c0) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  const float* p = tile + (r0 + g) * ld + c0 + t;
  const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
  split_n(x, hi, lo);
}

// B fragment of an 8 x 8 block whose columns n are rows [n0, n0 + 8) of a
// tile and whose depth k is its columns [k0, k0 + 8) (B = tile^T: K in
// Q K^T, V in dO V^T).
__device__ __forceinline__ void lds_bt(unsigned (&b)[2], const float* tile, int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  const float* p = tile + (n0 + l / 4) * ld + k0 + l % 4;
  b[0] = __float_as_uint(p[0]);
  b[1] = __float_as_uint(p[4]);
}

// B fragment of an 8 x 8 block whose depth k is rows [k0, k0 + 8) of a
// tile in the permuted order (slot t: row 2t, slot t + 4: row 2t + 1) and
// whose columns n are its columns [n0, n0 + 8) (B = tile: V in P V, K in
// dS K).
__device__ __forceinline__ void lds_b_perm(unsigned (&b)[2], const float* tile, int ld, int k0,
                                           int n0) {
  const int l = threadIdx.x % 32;
  const float* p = tile + (k0 + 2 * (l % 4)) * ld + n0 + l / 4;
  b[0] = __float_as_uint(p[0]);
  b[1] = __float_as_uint(p[ld]);
}

// The A fragment of a 16 x 8 C tile (scores of 8 keys) in the permuted k
// order, split.
__device__ __forceinline__ void c_to_a_split(unsigned (&hi)[4], unsigned (&lo)[4],
                                             const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split_n(a, hi, lo);
}

// Rows [row0, row0 + 64) of head `head` of N (1 or 2) float32 [B, S, NH,
// HD] tensors src0, src1 into dst0, dst1 (row stride HD + 4) by 16-byte
// loads, the loads of both in flight before the first store; rows at or
// beyond S are zero. SPLIT: each value is split, its hi part to dst, its lo
// part to lo0 / lo1.
template <int HD, int N, bool SPLIT>
__device__ __forceinline__ void stage_tiles_f32(float* dst0, float* lo0, const float* src0,
                                                float* dst1, float* lo1, const float* src1,
                                                long long b, int S, int NH, int head, int row0) {
  constexpr int C4 = HD / 4, TS = HD + 4;
  constexpr int PER = 64 * C4 / TF32_THREADS;  // 16-byte chunks per thread and tensor
  // loads of a tensor in flight before the stores: at most 8 (HD 80, 96, 112: 5, 6, 7)
  constexpr int BATCH = PER <= 8 ? PER : PER % 8 == 0 ? 8 : PER / 2;
  static_assert(PER % BATCH == 0 && BATCH <= 8 && (N == 1 || N == 2), "HD a multiple of 16 up to 128");
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    float4 x[N][BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int idx = threadIdx.x + (i0 + i) * TF32_THREADS, r = idx / C4, c = idx % C4;
      const int s = row0 + r;
      const long long at = ((b * S + s) * NH + head) * HD;
#pragma unroll
      for (int n = 0; n < N; ++n)
        x[n][i] = s < S ? __ldg(reinterpret_cast<const float4*>((n == 0 ? src0 : src1) + at) + c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int idx = threadIdx.x + (i0 + i) * TF32_THREADS, r = idx / C4, c = idx % C4;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float* at = (n == 0 ? dst0 : dst1) + r * TS + 4 * c;
        if constexpr (SPLIT) {
          uint32_t h[4], l[4];
          dmel::split_tf32(x[n][i].x, h[0], l[0]);
          dmel::split_tf32(x[n][i].y, h[1], l[1]);
          dmel::split_tf32(x[n][i].z, h[2], l[2]);
          dmel::split_tf32(x[n][i].w, h[3], l[3]);
          *reinterpret_cast<uint4*>(at) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>((n == 0 ? lo0 : lo1) + r * TS + 4 * c) = make_uint4(l[0], l[1], l[2], l[3]);
        } else {
          *reinterpret_cast<float4*>(at) = x[n][i];
        }
      }
    }
  }
}

}  // namespace dmel_flash
