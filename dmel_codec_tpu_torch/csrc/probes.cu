// The four probe kernels (probes/cf_act.py, probes/sublane_ops.py).
//
// They replace the Pallas TPU probes `cf_act_kernel` (scripts/exp_cf_act.py,
// launched by cf_act_windowed) and `k_slice`, `k_roll`, `k_matmul`
// (scripts/exp_sublane_ops.py). Each computes what its TPU kernel computes;
// the plain PyTorch versions are cf_act_reference, slice_reference,
// roll_reference and tap_matmul_reference beside the wrappers.
//
// P1 dmel_cf_act: one anti-aliased snake on channels-first [B, C, T] with
//   interior semantics (x replicate-clamped, no post-snake edge rule), and
//   the time tile `w` as a run-time argument: the probe of K1's tiling.
//   Bound: bytes (one element in, one out per sample, ~58 flops and two
//   sinf). One block = (window of w samples, tile of channels, batch row);
//   it stages x[t0-8, t0+w+8) of its channels in shared memory as float32,
//   then both snake phases at [t0-3, t0+w+3), then the down FIR. Shared
//   memory (12 w + 112 bytes per channel) decides how many channels a
//   block takes: 73 at w = 256, 4 at w = 4096.
// P2 dmel_rows_slice / P3 dmel_rows_roll: y[i] = sum over off in
//   (0, 1, 3, 5, 7, 9) of x[i + off] (P2, misaligned row reads) or of
//   x[(i - off) mod rows] (P3, np.roll's whole-plane rotate), i < out_rows,
//   on [P, rows, cols] float32 planes. Bound: bytes. The TPU kernels held
//   the whole plane in VMEM and P3 rotated all of it; here a block stages
//   only the out_rows + 9 rows its outputs read (P3: the last 9 rows of the
//   plane first, by modular index, then the leading rows) and every thread
//   sums six rows of shared memory at the odd offsets, in the TPU kernels'
//   order of additions, so the results agree to the bit.
// P4 dmel_tap_matmul: y = sum_{i < taps} x[step*i : step*i + M, :] @ w, an
//   11-tap conv in tap-matmul form, bf16 operands, float32 accumulation.
//   Bound at the probe's shape: operations on the tensor cores for the
//   taps x 2 M K N flops, bytes close behind. One block = 64 output rows of
//   one plane: it stages the 64 + step*(taps-1) rows of x it reads and w
//   (transposed, so that a B fragment's two k-neighbours are one 32-bit
//   word) in shared memory with rows padded by 8 bf16 against bank
//   conflicts; each of its 4 warps owns 16 rows x N columns of float32
//   accumulators and runs mma.sync.m16n8k16 over taps x K/16 steps.
//   wgmma and TMA are left to the stage kernel's redesign.
#include "common.cuh"

namespace {

constexpr int SMEM = 227 * 1024;  // dynamic shared memory one block may ask for on sm_90

// ---- P1 -------------------------------------------------------------------
constexpr int P1_THREADS = 512;
constexpr int XH = 8;  // input halo per side (the chain reaches 6)
constexpr int VH = 3;  // half-rate snake halo per side

__host__ __device__ constexpr int p1_floats_per_channel(int w) {
  return (w + 2 * XH) + 2 * (w + 2 * VH);
}

__global__ void __launch_bounds__(P1_THREADS)
cf_act_kernel(const void* __restrict__ x, void* __restrict__ y, const float* __restrict__ alpha,
              const float* __restrict__ inv_beta, int C, int T, int w, int ct, int bf16,
              dmel::Taps taps) {
  extern __shared__ float smem[];
  const int nx = w + 2 * XH, nv = w + 2 * VH;
  float* xs = smem;            // [ct][nx]
  float* ve = xs + ct * nx;    // [ct][nv]
  float* vo = ve + ct * nv;    // [ct][nv]

  const int t0 = blockIdx.x * w;
  const int c0 = blockIdx.y * ct;
  const int nc = min(ct, C - c0);
  const long long plane = (static_cast<long long>(blockIdx.z) * C + c0) * T;
  const int xbase = t0 - XH;

  for (int idx = threadIdx.x; idx < nc * nx; idx += P1_THREADS) {
    const int c = idx / nx, i = idx - c * nx;
    xs[idx] = dmel::load_f(x, plane + static_cast<long long>(c) * T + dmel::clampi(xbase + i, 0, T - 1), bf16);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nc * nv; idx += P1_THREADS) {
    const int c = idx / nv, i = idx - c * nv;
    const int s = t0 - VH + i;
    const float a = alpha[c0 + c], ib = inv_beta[c0 + c];
    const float* row = xs + c * nx;
    ve[idx] = dmel::snake(dmel::up_even(row, xbase, s, taps), a, ib);
    vo[idx] = dmel::snake(dmel::up_odd(row, xbase, s, taps), a, ib);
  }
  __syncthreads();

  const int nt = min(w, T - t0);
  for (int idx = threadIdx.x; idx < nc * w; idx += P1_THREADS) {
    const int c = idx / w, i = idx - c * w;
    if (i < nt) {
      dmel::store_f(y, plane + static_cast<long long>(c) * T + t0 + i,
                    dmel::down(ve + c * nv + i, vo + c * nv + i, taps), bf16);
    }
  }
}

// ---- P2, P3 ---------------------------------------------------------------
constexpr int ROWS_THREADS = 256;
constexpr int NOFF = 6;
constexpr int MAXOFF = 9;
__constant__ int OFFS[NOFF] = {0, 1, 3, 5, 7, 9};

template <bool ROLL>
__global__ void __launch_bounds__(ROWS_THREADS)
rows_kernel(const float* __restrict__ x, float* __restrict__ y, int rows, int cols, int out_rows, int ct) {
  extern __shared__ float smem[];  // [out_rows + MAXOFF][ct]
  const int c0 = blockIdx.x * ct;
  const int nc = min(ct, cols - c0);
  const float* xp = x + static_cast<long long>(blockIdx.y) * rows * cols + c0;
  float* yp = y + static_cast<long long>(blockIdx.y) * out_rows * cols + c0;
  const int ns = out_rows + MAXOFF;

  // slice: staged row j is plane row j; roll: plane row (j - MAXOFF) mod rows
  for (int idx = threadIdx.x; idx < ns * nc; idx += ROWS_THREADS) {
    const int j = idx / nc, c = idx - j * nc;
    int r = ROLL ? (j - MAXOFF) % rows : j;
    if (r < 0) r += rows;
    smem[j * ct + c] = xp[static_cast<long long>(r) * cols + c];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < out_rows * nc; idx += ROWS_THREADS) {
    const int i = idx / nc, c = idx - i * nc;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NOFF; ++k) {
      const int j = ROLL ? i + MAXOFF - OFFS[k] : i + OFFS[k];
      const float v = smem[j * ct + c];
      acc = k == 0 ? v : acc + v;
    }
    yp[static_cast<long long>(i) * cols + c] = acc;
  }
}

template <bool ROLL>
int launch_rows(const float* x, float* y, int P, int rows, int cols, int out_rows, void* stream) {
  if (P < 1 || P > 65535 || cols < 1 || out_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  // slice reads rows [0, out_rows + 9); roll needs the 9 wrapped rows to be distinct from those
  if (out_rows + MAXOFF > rows) return static_cast<int>(cudaErrorInvalidValue);
  const int ns = out_rows + MAXOFF;
  const int ct_max = SMEM / (ns * static_cast<int>(sizeof(float)));
  if (ct_max < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (cols + ct_max - 1) / ct_max;
  const int ct = (cols + tiles - 1) / tiles;
  const int bytes = ns * ct * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(rows_kernel<ROLL>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_kernel<ROLL><<<dim3(tiles, P), ROWS_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, y, rows, cols, out_rows, ct);
  return static_cast<int>(cudaGetLastError());
}

// ---- P4 -------------------------------------------------------------------
constexpr int MM_WARPS = 4;
constexpr int MM_BM = 16 * MM_WARPS;  // output rows per block
constexpr int MM_PAD = 8;             // bf16 of padding per staged row
constexpr int MM_MAXN = 128;          // N / 8 * 4 accumulators per thread

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

}  // namespace

// P1. x, y: [B, C, T] contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// alpha, inv_beta: [C] float32 on the device, used as they are (not
// log-scale); w: the window length, 1 .. 16384; taps: 12 host floats.
extern "C" int dmel_cf_act(const void* x, void* y, const float* alpha, const float* inv_beta,
                           int B, int C, int T, int w, int bf16, const float* taps, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || T < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_channel = p1_floats_per_channel(w) * static_cast<int>(sizeof(float));
  const int ct_max = SMEM / per_channel;
  if (ct_max < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C + ct_max - 1) / ct_max;
  const int ct = (C + tiles - 1) / tiles;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = ct * per_channel;
  cudaError_t err = cudaFuncSetAttribute(cf_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dmel::Taps tp;
  for (int i = 0; i < 12; ++i) tp.f[i] = taps[i];
  const dim3 grid((T + w - 1) / w, tiles, B);
  cf_act_kernel<<<grid, P1_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, y, alpha, inv_beta, C, T, w, ct, bf16, tp);
  return static_cast<int>(cudaGetLastError());
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
// contiguous; K a multiple of 16 and N of 8, both up to 128;
// step * (taps - 1) + M <= rows.
extern "C" int dmel_tap_matmul(const void* x, const void* w, void* y, int P, int rows, int M, int K, int N,
                               int taps, int step, void* stream) {
  if (P < 1 || P > 65535 || M < 1 || taps < 1 || step < 0 || K < 16 || K % 16 || K > 128 || N < 8 || N % 8 ||
      N > MM_MAXN || step * (taps - 1) + M > rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ld = K + MM_PAD;
  const int bytes = (MM_BM + step * (taps - 1) + N) * ld * static_cast<int>(sizeof(__nv_bfloat16));
  if (bytes > SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tap_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + MM_BM - 1) / MM_BM, P);
  tap_matmul_kernel<<<grid, 32 * MM_WARPS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<float*>(y),
      rows, M, K, N, taps, step);
  return static_cast<int>(cudaGetLastError());
}
