// The four probe kernels (probes/cf_act.py, probes/sublane_ops.py).
//
// They replace the Pallas TPU probes `cf_act_kernel` (scripts/exp_cf_act.py,
// launched by cf_act_windowed) and `k_slice`, `k_roll`, `k_matmul`
// (scripts/exp_sublane_ops.py). Each computes what its TPU kernel computes;
// the plain PyTorch versions are cf_act_reference, slice_reference,
// roll_reference and tap_matmul_reference beside the wrappers.
//
// P1 dmel_cf_act: one anti-aliased snake on channels-first [B, C, T] with
//   interior semantics (x replicate-clamped, no post-snake edge rule),
//   float32 taps and v in both dtypes, and the window `w` as a run-time
//   argument: the probe of K1's tiling. Bound: instruction issue, as K1's
//   (probes/k1_floor.py counts both from the SASS); on paper by operations
//   (24 FIR FMAs, the gain, two snakes and two sines per output sample at
//   the float32 rate) ahead of bytes. Design: K1's (snake_units.cuh) without
//   its edge rule and v rounding: warps walk tasks of 256-output units of a
//   row, 8 outputs a lane, 16-byte loads and stores on each row's aligned
//   body and element by element at its head and tail, register windows
//   filled by shuffles, the down FIR a unit late, sin_reduced under a
//   warp-uniform test with sinf's slow path out of line, a grid-stride loop
//   over as many blocks as the card holds (3 of 256 threads an SM). A task
//   spans ceil(w / 256) units of a row, so w still sets the tiling and the
//   result does not depend on it. No shared memory, no barrier. The sums run
//   in the first-port design's order and sin_reduced has sinf's bits, so
//   the outputs keep that design's bits.
// P2 dmel_rows_slice / P3 dmel_rows_roll: y[i] = sum over off in
//   (0, 1, 3, 5, 7, 9) of x[i + off] (P2, misaligned row reads) or of
//   x[(i - off) mod rows] (P3, np.roll's whole-plane rotate), i < out_rows,
//   on [P, rows, cols] float32 planes. Bound: bytes (the out_rows + 9 rows
//   a plane's result reads, once, and the result). The TPU kernels held the
//   whole plane in VMEM and P3 rotated all of it. Here a thread owns 16
//   bytes of columns (a float4) and 16 consecutive output rows: it loads
//   the 25 rows those read (P3: by modular index) as float4s on the
//   read-only path, all before its first sum, adds in the order of OFFSETS
//   (the plain version's bits) and stores float4s. Threads run over (row
//   tile, column vector, plane) in one flat grid of 64-thread blocks, so one
//   plane spreads over several SMs; neighbouring row tiles share 9 rows
//   through L1 / L2. Where cols is no multiple of 4 or x or y is off a
//   16-byte boundary, the same kernel takes one float a thread. No shared
//   memory.
// P4 dmel_tap_matmul: y = sum_{i < taps} x[step*i : step*i + M, :] @ w, an
//   11-tap conv in tap-matmul form, bf16 operands, float32 accumulation.
//   Bound at the probe's shapes: operations on the tensor cores for the
//   taps x 2 M K N flops, bytes close behind (the float32 y is most of
//   them). Two kernels, chosen by the wrapper from the shape alone:
//   * tap_wgmma_kernel (K, N multiples of 32 up to 256, step a multiple of
//     8, 128 + step * (taps - 1) <= 256: the flagship C = 96 and C = 192).
//     A tile is 128 output rows x all of N of one plane; persistent blocks
//     walk the (plane, tile) list. One producer warp stages, by TMA, w once
//     (N / 32 boxes of K rows x 64 bytes) and each tile's 128 + step *
//     (taps - 1) rows of x once, as K / 32 column blocks of 64-byte rows,
//     into a ring of shared-memory slots (full / empty mbarriers), so the
//     next tile's rows load while this one's products run. Both operands
//     lie in the 64-byte swizzle, whose atom is 8 rows: tap i's A operand
//     is the staged block shifted by step * i rows, a whole number of
//     atoms, so only the wgmma descriptor's start address moves (no copy).
//     Two consumer warpgroups each own 64 rows x N float32 sums in
//     registers and run wgmma.mma_async m64nNk16 (A K-major, B = w in its
//     own [K, N] layout, MN-major), one commit group per column block; the
//     epilogue trades halves between lane pairs and stores 16 bytes per
//     thread, masking rows at or beyond M. At C = 192 the ring holds 11 of
//     the 12 column blocks of two tiles (w takes 72 KB); at C <= 96 two
//     blocks share an SM (at most 113 KB and 112 registers a thread each).
//   * tap_matmul_kernel (every other shape: K a multiple of 16, N of 8, up
//     to 256): one block = 64 output rows of one plane; it stages the 64 +
//     step * (taps - 1) rows of x it reads and w (transposed, so that a B
//     fragment's two k-neighbours are one 32-bit word) in shared memory
//     with rows padded by 8 bf16 against bank conflicts; each of its 4 warps
//     owns 16 rows x N columns of float32 accumulators and runs
//     mma.sync.m16n8k16 over taps x K / 16 steps.
#include <cuda.h>
#include <stdint.h>

#include <algorithm>

#include "snake_units.cuh"
#include "hopper.cuh"

namespace {

using dmel::mbar_arrive;
using dmel::mbar_expect_tx;
using dmel::mbar_init;
using dmel::mbar_wait;
using dmel::sw64_desc;
using dmel::tma_load;
using dmel::wgmma_commit;
using dmel::wgmma_fence;
using dmel::wgmma_wait;

constexpr int SMEM = 227 * 1024;  // dynamic shared memory one block may ask for on sm_90

// ---- P1 -------------------------------------------------------------------
// K1's warps over register windows (snake_units.cuh) with P1's contract:
// interior semantics, float32 taps and v; alpha and 1 / (beta + eps) as
// they are used, one load of each per task.
template <bool BF16>
__global__ void __launch_bounds__(dmel::units::THREADS, dmel::units::MIN_BLOCKS)
cf_act_kernel(const void* __restrict__ x, void* __restrict__ y, const float* __restrict__ alpha,
              const float* __restrict__ inv_beta, int C, int n_rows, dmel::units::Plan pl, dmel::Taps taps) {
  dmel::units::walk<dmel::units::FULL, BF16, false, false>(x, y, alpha, inv_beta, C, n_rows, pl, taps);
}

template <bool BF16>
int launch_cf_act(const void* x, void* y, const float* alpha, const float* inv_beta, int B, int C, int T, int w,
                  const dmel::Taps& taps, cudaStream_t stream) {
  using namespace dmel::units;
  const long long n_rows = static_cast<long long>(B) * C;
  if (n_rows >= MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl = make_plan(x, y, T, BF16 ? 2 : 4);
  pl.segu = (w + UNIT - 1) / UNIT;  // the window: the span of a row one task covers, in whole units
  static const long long cap = resident_blocks(cf_act_kernel<BF16>, 0);
  const int grid = grid_of(pl, n_rows, cap);
  cf_act_kernel<BF16><<<grid, THREADS, 0, stream>>>(x, y, alpha, inv_beta, C, static_cast<int>(n_rows), pl, taps);
  return static_cast<int>(cudaGetLastError());
}

// ---- P2, P3 ---------------------------------------------------------------
constexpr int ROWS_THREADS = 64;
constexpr int ROWS_R = 16;  // output rows per thread
constexpr int NOFF = 6;
constexpr int MAXOFF = 9;

// OFFSETS = (0, 1, 3, 5, 7, 9)
__host__ __device__ constexpr int offset(int k) { return k == 0 ? 0 : 2 * k - 1; }

__device__ __forceinline__ float4 ldg(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

// One thread: a column vector c (V = float4: 4 columns; float: 1) of rows
// [i0, i0 + ROWS_R) of one plane. Its window w[j] holds plane row i0 + j
// (slice) or (i0 - 9 + j) mod rows (roll), all loaded before any sum.
template <bool ROLL, typename V>
__global__ void __launch_bounds__(ROWS_THREADS)
rows_kernel(const V* __restrict__ x, V* __restrict__ y, int rows, int nv, int out_rows, int tiles,
            long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * ROWS_THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long per_plane = static_cast<long long>(tiles) * nv;
  const long long plane = idx / per_plane;
  const int rest = static_cast<int>(idx - plane * per_plane);
  const int tile = rest / nv, c = rest - tile * nv;
  const int i0 = tile * ROWS_R;
  const int n = min(ROWS_R, out_rows - i0);  // this thread's output rows
  const V* xp = x + plane * rows * nv + c;
  V* yp = y + (plane * out_rows + i0) * nv + c;

  V w[ROWS_R + MAXOFF];
#pragma unroll
  for (int j = 0; j < ROWS_R + MAXOFF; ++j) {
    if (j < n + MAXOFF) {
      int r = ROLL ? i0 - MAXOFF + j : i0 + j;
      if (ROLL && r < 0) r += rows;
      w[j] = ldg(xp + static_cast<long long>(r) * nv);
    }
  }
#pragma unroll
  for (int q = 0; q < ROWS_R; ++q) {
    if (q < n) {
      // the additions in the order of OFFSETS, as the plain version's
      V acc = w[ROLL ? q + MAXOFF : q];
#pragma unroll
      for (int k = 1; k < NOFF; ++k) acc = add(acc, w[ROLL ? q + MAXOFF - offset(k) : q + offset(k)]);
      yp[static_cast<long long>(q) * nv] = acc;
    }
  }
}

template <bool ROLL>
int launch_rows(const float* x, float* y, int P, int rows, int cols, int out_rows, void* stream) {
  if (P < 1 || cols < 1 || out_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  // slice reads rows [0, out_rows + 9); roll needs the 9 wrapped rows to be distinct from those
  if (out_rows + MAXOFF > rows) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte vectors where every row of every plane starts on a 16-byte boundary
  const bool vec = cols % 4 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const int nv = vec ? cols / 4 : cols;
  const int tiles = (out_rows + ROWS_R - 1) / ROWS_R;
  const long long total = static_cast<long long>(P) * tiles * nv;
  const long long grid = (total + ROWS_THREADS - 1) / ROWS_THREADS;
  if (grid > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    rows_kernel<ROLL, float4><<<static_cast<unsigned>(grid), ROWS_THREADS, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), rows, nv, out_rows, tiles, total);
  } else {
    rows_kernel<ROLL, float><<<static_cast<unsigned>(grid), ROWS_THREADS, 0, st>>>(
        x, y, rows, nv, out_rows, tiles, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- P4, general path: mma.sync ------------------------------------------
constexpr int MM_WARPS = 4;
constexpr int MM_BM = 16 * MM_WARPS;  // output rows per block
constexpr int MM_PAD = 8;             // bf16 of padding per staged row
constexpr int MM_MAXN = 256;          // N / 8 * 4 accumulators per thread

__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(32 * MM_WARPS)
tap_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  float* __restrict__ y, int rows, int M, int K, int N, int taps, int step) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int ld = K + MM_PAD;                      // staged row stride, in bf16
  const int nxs = MM_BM + step * (taps - 1);      // rows of x this block reads
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(raw);  // [nxs][ld]
  __nv_bfloat16* wt = xs + nxs * ld;                          // [N][ld], wt[n][k] = w[k][n]

  const int m0 = blockIdx.x * MM_BM;
  const __nv_bfloat16* xp = x + static_cast<long long>(blockIdx.y) * rows * K;
  float* yp = y + static_cast<long long>(blockIdx.y) * M * N;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int idx = threadIdx.x; idx < nxs * K; idx += blockDim.x) {
    const int r = idx / K, k = idx - r * K;
    xs[r * ld + k] = m0 + r < rows ? xp[static_cast<long long>(m0 + r) * K + k] : zero;
  }
  for (int idx = threadIdx.x; idx < K * N; idx += blockDim.x) {
    const int k = idx / N, n = idx - k * N;
    wt[n * ld + k] = w[idx];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = N / 8;
  float acc[MM_MAXN / 8][4];
#pragma unroll
  for (int j = 0; j < MM_MAXN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int tap = 0; tap < taps; ++tap) {
    const __nv_bfloat16* a_lo = xs + (warp * 16 + tap * step + g) * ld + 2 * t;
    const __nv_bfloat16* a_hi = a_lo + 8 * ld;
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned a[4];
      a[0] = *reinterpret_cast<const unsigned*>(a_lo + k0);
      a[1] = *reinterpret_cast<const unsigned*>(a_hi + k0);
      a[2] = *reinterpret_cast<const unsigned*>(a_lo + k0 + 8);
      a[3] = *reinterpret_cast<const unsigned*>(a_hi + k0 + 8);
#pragma unroll
      for (int j = 0; j < MM_MAXN / 8; ++j) {
        if (j < ntiles) {
          const __nv_bfloat16* b = wt + (j * 8 + g) * ld + k0 + 2 * t;
          mma_bf16_16x8x16(acc[j], a, *reinterpret_cast<const unsigned*>(b),
                           *reinterpret_cast<const unsigned*>(b + 8));
        }
      }
    }
  }

  const int r_lo = m0 + warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < MM_MAXN / 8; ++j) {
    if (j < ntiles) {
      const int col = j * 8 + 2 * t;
      if (r_lo < M) *reinterpret_cast<float2*>(yp + static_cast<long long>(r_lo) * N + col) = make_float2(acc[j][0], acc[j][1]);
      if (r_hi < M) *reinterpret_cast<float2*>(yp + static_cast<long long>(r_hi) * N + col) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// ---- P4, Hopper path: TMA + wgmma -----------------------------------------
constexpr int WG_CONSUMERS = 2;                      // consumer warpgroups, 64 output rows each
constexpr int WG_BM = 64 * WG_CONSUMERS;             // output rows per tile
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;  // and one producer warp
constexpr int WG_KB = 32;                            // bf16 per 64-byte swizzled row: a column block of x, of w
constexpr int WG_MAX_ROWS = 256;                     // TMA's largest box: WG_BM + step * (taps - 1)
constexpr int WG_PAIR_SMEM = 115712;                 // per block when two share an SM (228 KB less 2 x 1 KB reserved)
constexpr int WG_PAIR_N = 96;                        // two blocks an SM up to this N (at 128 the 112 registers spill)


// Shared memory: w (N / 32 boxes of K rows x 64 bytes), then a ring of
// `slots` column blocks of x (R rows x 64 bytes each, R = WG_BM + step *
// (taps - 1)), then the ring's full / empty barriers and w's.
struct WgLayout {
  uint32_t w_bytes, slot_bytes, ring, bars, total;
};

__host__ __device__ inline WgLayout wg_layout(int K, int N, int R, int slots) {
  WgLayout l;
  l.w_bytes = static_cast<uint32_t>(K) * N * 2;
  l.slot_bytes = (static_cast<uint32_t>(R) * 64 + 1023) & ~1023u;
  l.ring = (l.w_bytes + 1023) & ~1023u;
  l.bars = l.ring + slots * l.slot_bytes;
  l.total = l.bars + 8 * (2 * slots + 1) + 1024;  // + the alignment of the base to 1024 bytes
  return l;
}

template <int N>
__global__ void __launch_bounds__(WG_THREADS, N <= WG_PAIR_N ? 2 : 1)
tap_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 float* __restrict__ y, int P, int M, int K, int taps, int step, int slots) {
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  const int R = WG_BM + step * (taps - 1);
  const WgLayout lay = wg_layout(K, N, R, slots);
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(wg_raw)) + 1023) & ~1023u;
  const uint32_t ws = base, ring = base + lay.ring, bars = base + lay.bars;
  const uint32_t wbar = bars + 16 * slots;
  const int kblocks = K / WG_KB;
  const int per_plane = (M + WG_BM - 1) / WG_BM;
  const int n_tiles = P * per_plane;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(bars + 8 * s, 1);                        // full: the producer's expect_tx + the bytes
      mbar_init(bars + 8 * (slots + s), WG_CONSUMERS);  // empty: one arrival per consumer warpgroup
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * WG_CONSUMERS) {  // the producer warp: one lane issues every copy
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(wbar, lay.w_bytes);
      for (int nb = 0; nb < N / WG_KB; ++nb) tma_load(ws + nb * K * 64, &wmap, wbar, nb * WG_KB, 0, 0);
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int plane = tile / per_plane, m0 = (tile % per_plane) * WG_BM;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % slots;
          mbar_wait(bars + 8 * (slots + s), ((it / slots) & 1) ^ 1);  // the slot's last readers are done
          mbar_expect_tx(bars + 8 * s, static_cast<uint32_t>(R) * 64);
          tma_load(ring + s * lay.slot_bytes, &xmap, bars + 8 * s, kb * WG_KB, m0, plane);
        }
      }
    }
    return;
  }

  // consumer warpgroup c: rows [64 c, 64 c + 64) of every tile
  const int c = warp / 4, tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4, t = tid % 4, odd = t & 1;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  mbar_wait(wbar, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int plane = tile / per_plane, m0 = (tile % per_plane) * WG_BM;
    int held = -1;  // the slot whose products may still be in flight
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % slots;
      mbar_wait(bars + 8 * s, (it / slots) & 1);
      const uint32_t xa = ring + s * lay.slot_bytes + c * 64 * 64;
      const uint32_t wb = ws + kb * WG_KB * 64;
      wgmma_fence();
      for (int i = 0; i < taps; ++i) {
        // tap i reads the staged rows shifted by step * i: a multiple of 8
        // rows, one swizzle atom, so only the descriptor's start moves
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dmel::wgmma<N, 1>(d, sw64_desc(xa + i * step * 64 + h * 32, 16, 512),
                            sw64_desc(wb + h * 16 * 64, K * 64, 512), (kb | i | h) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous column block's products are done: free its slot
      if (held >= 0 && tid == 0) mbar_arrive(bars + 8 * (slots + held));
      held = s;
    }
    wgmma_wait<0>();
    if (tid == 0) mbar_arrive(bars + 8 * (slots + held));

    // epilogue: lanes t and t ^ 1 trade halves so that each stores 4
    // consecutive floats of one row (even t: row g, odd t: row g + 8)
    const int row = m0 + c * 64 + (tid / 32) * 16 + g + 8 * odd;
    float* yrow = y + (static_cast<long long>(plane) * M + row) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float s0 = odd ? d[4 * j] : d[4 * j + 2], s1 = odd ? d[4 * j + 1] : d[4 * j + 3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1), r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const float4 v = odd ? make_float4(r0, r1, d[4 * j + 2], d[4 * j + 3])
                           : make_float4(d[4 * j], d[4 * j + 1], r0, r1);
      if (row < M) *reinterpret_cast<float4*>(yrow + 8 * j + 2 * (t & 2)) = v;
    }
  }
}

// The tensor maps: x as [P, rows, K] in boxes of R rows x 32 columns, w as
// [K, N] in boxes of K rows x 32 columns, both with the 64-byte swizzle
// that the wgmma descriptors read. Rows beyond a plane's end read as zero.
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

bool make_map(CUtensorMap* map, const void* base, cuuint64_t d0, cuuint64_t d1, cuuint64_t d2, cuuint32_t box1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {WG_KB, box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch_wgmma(const void* x, const void* w, float* y, int P, int rows, int M, int K, int taps, int step,
                 cudaStream_t stream) {
  const int R = WG_BM + step * (taps - 1);
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, x, K, rows, P, R) || !make_map(&wmap, w, N, K, 1, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // as many ring slots as fit, up to two tiles' column blocks; half the
  // SM's shared memory where two blocks share it (N <= WG_PAIR_N)
  const int kblocks = K / WG_KB;
  const int budget = N <= WG_PAIR_N ? WG_PAIR_SMEM : SMEM;
  const WgLayout none = wg_layout(K, N, R, 0);
  const int fit = (budget - static_cast<int>(none.total) - 16) / static_cast<int>(none.slot_bytes + 16);
  const int slots = std::min(fit, 2 * kblocks);
  if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(wg_layout(K, N, R, slots).total);
  cudaError_t err = cudaFuncSetAttribute(tap_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tap_wgmma_kernel<N>, WG_THREADS, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = P * ((M + WG_BM - 1) / WG_BM);
  const int grid = std::min(tiles, std::max(per_sm, 1) * sms);
  tap_wgmma_kernel<N><<<grid, WG_THREADS, bytes, stream>>>(xmap, wmap, y, P, M, K, taps, step, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P1. x, y: [B, C, T] contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// alpha, inv_beta: [C] float32 on the device, used as they are (not
// log-scale); w: the window length, 1 .. 16384 (a task spans ceil(w / 256)
// units of 256 outputs); taps: 12 host floats.
extern "C" int dmel_cf_act(const void* x, void* y, const float* alpha, const float* inv_beta,
                           int B, int C, int T, int w, int bf16, const float* taps, void* stream) {
  if (B < 1 || C < 1 || T < 1 || w < 1 || w > 16384) return static_cast<int>(cudaErrorInvalidValue);
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_cf_act<true>(x, y, alpha, inv_beta, B, C, T, w, tp, st)
              : launch_cf_act<false>(x, y, alpha, inv_beta, B, C, T, w, tp, st);
}

// P2. x: [P, rows, cols] float32, y: [P, out_rows, cols] float32, contiguous;
// out_rows + 9 <= rows.
extern "C" int dmel_rows_slice(const float* x, float* y, int P, int rows, int cols, int out_rows, void* stream) {
  return launch_rows<false>(x, y, P, rows, cols, out_rows, stream);
}

// P3. As P2, with np.roll's circular row index.
extern "C" int dmel_rows_roll(const float* x, float* y, int P, int rows, int cols, int out_rows, void* stream) {
  return launch_rows<true>(x, y, P, rows, cols, out_rows, stream);
}

// P4. x: [P, rows, K] bfloat16, w: [K, N] bfloat16, y: [P, M, N] float32,
// contiguous; step * (taps - 1) + M <= rows; K a multiple of 16 and N of 8,
// both up to 256. path 0: the general mma.sync kernel; path 1: the TMA +
// wgmma kernel, which also needs K and N multiples of 32, step a multiple of
// 8, 128 + step * (taps - 1) <= 256, and x, w and y on 16-byte boundaries.
extern "C" int dmel_tap_matmul(const void* x, const void* w, void* y, int P, int rows, int M, int K, int N,
                               int taps, int step, int path, void* stream) {
  if (P < 1 || M < 1 || taps < 1 || step < 0 || K < 16 || K % 16 || K > 256 || N < 8 || N % 8 ||
      N > MM_MAXN || step * (taps - 1) + M > rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  if (path == 1) {
    if (K % WG_KB || N % WG_KB || step % 8 || WG_BM + step * (taps - 1) > WG_MAX_ROWS ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) % 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (N) {
      case 32: return launch_wgmma<32>(x, w, yf, P, rows, M, K, taps, step, st);
      case 64: return launch_wgmma<64>(x, w, yf, P, rows, M, K, taps, step, st);
      case 96: return launch_wgmma<96>(x, w, yf, P, rows, M, K, taps, step, st);
      case 128: return launch_wgmma<128>(x, w, yf, P, rows, M, K, taps, step, st);
      case 160: return launch_wgmma<160>(x, w, yf, P, rows, M, K, taps, step, st);
      case 192: return launch_wgmma<192>(x, w, yf, P, rows, M, K, taps, step, st);
      case 224: return launch_wgmma<224>(x, w, yf, P, rows, M, K, taps, step, st);
      case 256: return launch_wgmma<256>(x, w, yf, P, rows, M, K, taps, step, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (path != 0 || P > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = K + MM_PAD;
  const int bytes = (MM_BM + step * (taps - 1) + N) * ld * static_cast<int>(sizeof(__nv_bfloat16));
  if (bytes > SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tap_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + MM_BM - 1) / MM_BM, P);
  tap_matmul_kernel<<<grid, 32 * MM_WARPS, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), yf, rows, M, K, N, taps, step);
  return static_cast<int>(cudaGetLastError());
}
