// Exact bidirectional patch nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel nct_tpu/ops/pallas_nn.py::_nn_bidir_kernel
// (pallas_call at pallas_nn.py:221, entry exact_nn_pallas_bidir), which the
// pipeline runs at pyramid levels L0-L3.  For bf16 patch tables Fa [Na, KC]
// and Fb [Nb, KC] (KC = 9 * channels) and 9-bit validity masks, it computes
//
//     d(a, b) = -(Fa[a] . Fb[b]) / max(cnt(a, b), 1),  +inf where cnt == 0,
//     cnt(a, b) = popcount(Ma[a] & Mb[b])   (= the f32 product of 0/1 masks)
//
// and folds, from the same tile, the row argmin (a -> b) and the column
// argmin (b -> a), both first-match on ties.  The [Na, Nb] matrix is never
// stored (44 GB in f32 at L3 of the 452x680 / 600x960 pair).
//
// Bound: compute.  A pair runs about 29 TFLOP of bf16 products over about
// 0.9 GB of patch tables, some 30,000 operations per byte, far above the
// card's ~295 FLOP/byte ridge.  The design therefore puts the products on
// the tensor cores (nvcuda::wmma bf16 16x16x16, f32 accumulation), keeps a
// 128x128 output tile per block so each operand byte loaded into shared
// memory feeds 128 products, and keeps every reduction on chip:
//
//   * grid (A tiles, B splits); a block owns one 128-row A tile and walks
//     its B split's 128-column tiles in ascending order (the TPU's
//     sequential j axis becomes that loop), keeping each row's (min, argmin)
//     in registers with strict < across tiles and the lowest column within
//     a tile;
//   * rows across splits and columns across A tiles are combined with one
//     64-bit atomicMin on key = (order-preserving bits of d) << 32 | index.
//     The minimum key is the smallest distance with the lowest index, so
//     the result is JAX's first match exactly, whatever order blocks run in.
//     -0.0 is canonicalised to +0.0 first (JAX compares them equal; an
//     all-zero post-ReLU patch gives dots = 0 and d = -0.0).
//
// Division is IEEE (-dots / fmaxf(cnt, 1)); do not build with fast math.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TA = 128;        // A rows per block
constexpr int TB = 128;        // B columns per tile
constexpr int TK = 32;         // depth per shared-memory stage
constexpr int LDS = TK + 8;    // operand row stride in smem (bf16 elements)
constexpr int LDC = TB + 4;    // f32 tile row stride in smem
constexpr int NTHREADS = 256;  // 8 warps: 4 (rows) x 2 (columns)

constexpr size_t CTILE_BYTES = sizeof(float) * TA * LDC;
constexpr size_t SMEM_BYTES = CTILE_BYTES + sizeof(int) * (TA + TB) +
                              (sizeof(float) + sizeof(int)) * TB;
static_assert(2 * sizeof(__nv_bfloat16) * TA * LDS <= CTILE_BYTES,
              "operand stages must fit inside the aliased f32 tile");

__device__ __forceinline__ unsigned long long make_key(float d, int idx) {
  if (d == 0.0f) d = 0.0f;  // -0.0 -> +0.0
  unsigned int u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned int>(idx);
}

__global__ void __launch_bounds__(NTHREADS)
nn_bidir_kernel(const __nv_bfloat16* __restrict__ fa,
                const int* __restrict__ ma,
                const __nv_bfloat16* __restrict__ fb,
                const int* __restrict__ mb,
                int kc, int nb_tiles, int tiles_per_split,
                unsigned long long* __restrict__ row_keys,
                unsigned long long* __restrict__ col_keys) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ctile = reinterpret_cast<float*>(smem);
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);  // aliases ctile
  __nv_bfloat16* sb = sa + TA * LDS;
  int* sma = reinterpret_cast<int*>(smem + CTILE_BYTES);
  int* smb = sma + TA;
  float* half_d = reinterpret_cast<float*>(smb + TB);
  int* half_i = reinterpret_cast<int*>(half_d + TB);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // rows wr*32 .. +32
  const int wc = warp & 1;   // columns wc*64 .. +64
  const int a0 = blockIdx.x * TA;
  const int j_begin = blockIdx.y * tiles_per_split;
  const int j_end = min(j_begin + tiles_per_split, nb_tiles);

  if (tid < TA) sma[tid] = ma[a0 + tid];

  // Row state: threads 2r and 2r+1 scan halves of row r; the even one keeps
  // the running (min, argmin) across this block's B tiles.
  const int my_row = tid >> 1;
  const int my_half = tid & 1;
  float best_d = INFINITY;
  int best_i = 0;

  // Each stage copies 128 rows x 64 bytes per operand: 512 16-byte chunks,
  // two per thread, prefetched into registers one stage ahead.
  uint4 ra[2], rb[2];

  for (int j = j_begin; j < j_end; ++j) {
    const int b0 = j * TB;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[i][n], 0.0f);

#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = tid + c * NTHREADS;
      const int row = idx >> 2, part = idx & 3;
      ra[c] = *reinterpret_cast<const uint4*>(
          fa + static_cast<size_t>(a0 + row) * kc + part * 8);
      rb[c] = *reinterpret_cast<const uint4*>(
          fb + static_cast<size_t>(b0 + row) * kc + part * 8);
    }

    for (int k0 = 0; k0 < kc; k0 += TK) {
      __syncthreads();  // previous stage (or previous tile's epilogue) done
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int idx = tid + c * NTHREADS;
        const int row = idx >> 2, part = idx & 3;
        *reinterpret_cast<uint4*>(sa + row * LDS + part * 8) = ra[c];
        *reinterpret_cast<uint4*>(sb + row * LDS + part * 8) = rb[c];
      }
      __syncthreads();
      if (k0 + TK < kc) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = tid + c * NTHREADS;
          const int row = idx >> 2, part = idx & 3;
          ra[c] = *reinterpret_cast<const uint4*>(
              fa + static_cast<size_t>(a0 + row) * kc + k0 + TK + part * 8);
          rb[c] = *reinterpret_cast<const uint4*>(
              fb + static_cast<size_t>(b0 + row) * kc + k0 + TK + part * 8);
        }
      }
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], sa + (wr * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::load_matrix_sync(bf[n], sb + (wc * 64 + n * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            wmma::mma_sync(acc[i][n], af[i], bf[n], acc[i][n]);
      }
    }
    __syncthreads();  // every warp is done with sa/sb before ctile overwrites them

    if (tid < TB) smb[tid] = mb[b0 + tid];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(ctile + (wr * 32 + i * 16) * LDC + wc * 64 + n * 16,
                                acc[i][n], LDC, wmma::mem_row_major);
    __syncthreads();

    // dots -> masked distance, in place
    for (int e = tid; e < TA * TB; e += NTHREADS) {
      const int r = e / TB, c = e % TB;
      const float cnt = static_cast<float>(__popc(sma[r] & smb[c]));
      const float dots = ctile[r * LDC + c];
      ctile[r * LDC + c] = cnt > 0.0f ? -dots / fmaxf(cnt, 1.0f) : INFINITY;
    }
    __syncthreads();

    // a -> b: lowest column of the row minimum, strict < across tiles
    {
      const float* rowp = ctile + my_row * LDC + my_half * (TB / 2);
      float dmin = INFINITY;
      int cmin = my_half * (TB / 2);
      for (int c = 0; c < TB / 2; ++c) {
        const float v = rowp[c];
        if (v < dmin) { dmin = v; cmin = my_half * (TB / 2) + c; }
      }
      const float od = __shfl_xor_sync(0xffffffffu, dmin, 1);
      const int oc = __shfl_xor_sync(0xffffffffu, cmin, 1);
      if (my_half == 0) {
        if (od < dmin) { dmin = od; cmin = oc; }  // upper half only if strictly smaller
        if (dmin < best_d) { best_d = dmin; best_i = b0 + cmin; }
      }
    }

    // b -> a: lowest row of the column minimum, then one atomic per column
    {
      const int c = tid % TB, h = tid / TB;
      float dmin = INFINITY;
      int rmin = h * (TA / 2);
      for (int r = 0; r < TA / 2; ++r) {
        const float v = ctile[(h * (TA / 2) + r) * LDC + c];
        if (v < dmin) { dmin = v; rmin = h * (TA / 2) + r; }
      }
      if (h == 1) { half_d[c] = dmin; half_i[c] = rmin; }
      __syncthreads();
      if (h == 0) {
        if (half_d[c] < dmin) { dmin = half_d[c]; rmin = half_i[c]; }
        atomicMin(col_keys + b0 + c, make_key(dmin, a0 + rmin));
      }
    }
  }
  if (my_half == 0) atomicMin(row_keys + a0 + my_row, make_key(best_d, best_i));
}

}  // namespace

extern "C" {

// Tile geometry the Python wrapper pads and checks against.
int nn_bidir_tile_rows() { return TA; }
int nn_bidir_tile_depth() { return TK; }

// fa/fb: bf16 [na_pad, kc] / [nb_pad, kc]; ma/mb: int32 9-bit validity masks;
// row_keys [na_pad] / col_keys [nb_pad]: uint64, initialised by the caller to
// the key of (+inf, 0).  Launches on `stream` and returns cudaGetLastError().
int nn_bidir_launch(const void* fa, const void* ma, const void* fb,
                    const void* mb, int na_pad, int nb_pad, int kc,
                    int tiles_per_split, void* row_keys, void* col_keys,
                    void* stream) {
  if (na_pad <= 0 || nb_pad <= 0 || na_pad % TA || nb_pad % TB || kc <= 0 ||
      kc % TK || tiles_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      nn_bidir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb_tiles = nb_pad / TB;
  dim3 grid(na_pad / TA, (nb_tiles + tiles_per_split - 1) / tiles_per_split);
  nn_bidir_kernel<<<grid, NTHREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(fa), static_cast<const int*>(ma),
      static_cast<const __nv_bfloat16*>(fb), static_cast<const int*>(mb), kc,
      nb_tiles, tiles_per_split, static_cast<unsigned long long*>(row_keys),
      static_cast<unsigned long long*>(col_keys));
  return static_cast<int>(cudaGetLastError());
}

const char* nn_bidir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
