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

}  // namespace dmel_flash
