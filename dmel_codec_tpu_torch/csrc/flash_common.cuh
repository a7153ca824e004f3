// Tiling shared by the flash-attention kernels: the forward
// (flash_attention.cu) and the two backward kernels (flash_attention_bwd.cu).
//
// A block of 128 threads works on 64 x 64 tiles of the [queries, keys] score
// matrix. The threads form a 16 x 8 grid: thread (ty, tx) owns rows
// ty + 16 i (i < 4) and columns tx + 8 j (j < 8) of a tile, so the 8 lanes
// that share a row sit in one warp. Operand tiles lie in shared memory as
// float32 rows of HD + 4 floats: the float4 reads along a row (a product
// over the head dimension) and the float2 reads across rows (a product over
// the tile's other index) are both free of bank conflicts.
#pragma once

#include "common.cuh"

namespace dmel_flash {

constexpr int BM = 64;       // rows of a tile
constexpr int BN = 64;       // columns of a tile (== BM: the diagonal tile shows each row a key)
constexpr int THREADS = 128;
constexpr int TX = 8;        // threads across a tile's columns
constexpr int TY = 16;       // threads down its rows
constexpr int RI = BM / TY;  // rows per thread, r = ty + TY * i
constexpr int CJ = BN / TX;  // columns per thread, c = tx + TX * j
constexpr int PS = BN + 4;   // row stride of a [64, 64] tile in shared memory

// Rows [row0, row0 + 64) of head `head` of a [B, S, NH, HD] tensor into
// dst[r * stride + d] as float32; rows at or beyond S are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride, const void* src,
                                          long long b, int S, int NH, int head,
                                          int row0, int bf16) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int s = row0 + r;
    float val = 0.f;
    if (s < S) val = dmel::load_f(src, ((b * S + s) * NH + head) * HD + d, bf16);
    dst[r * stride + d] = val;
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

}  // namespace dmel_flash
