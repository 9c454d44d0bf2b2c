// Exact patch nearest-neighbour search for Hopper (sm_90a), bidirectional
// and directed.
//
// Replaces the two TPU kernels of nct_tpu/ops/pallas_nn.py:
//   * _nn_bidir_kernel (pallas_call at pallas_nn.py:221, entry
//     exact_nn_pallas_bidir), which the pipeline runs at pyramid levels
//     L0-L3: instance nn_kernel<true>, entry nn_bidir_launch;
//   * _nn_kernel (pallas_call at pallas_nn.py:299, entry exact_nn_pallas),
//     the directed a -> b search the per-stage profiler times: instance
//     nn_kernel<false>, entry nn_directed_launch.  It is the same kernel
//     with the column fold compiled out, so its tile arithmetic and
//     accumulation order are those of the bidirectional instance and its
//     row result is bitwise the same.
//
// For bf16 patch tables Fa [Na, KC] and Fb [Nb, KC] (KC = 9 * channels) and
// 9-bit validity masks, it computes
//
//     d(a, b) = -(Fa[a] . Fb[b]) / max(cnt(a, b), 1),  +inf where cnt == 0,
//     cnt(a, b) = popcount(Ma[a] & Mb[b])   (= the f32 product of 0/1 masks)
//
// and folds, from the same tile, the row argmin (a -> b) and (bidirectional
// instance only) the column argmin (b -> a), both first-match on ties.  The
// [Na, Nb] matrix is never stored (44 GB in f32 at L3 of the 452x680 /
// 600x960 pair).
//
// Bound: operations.  The work is 2 Na Nb (KC + 9) operations: a pair runs
// about 29 TFLOP of bf16 products over about 0.9 GB of patch tables, some
// 30,000 operations per byte, far above the card's ~295 FLOP/byte ridge, so
// the design keeps the tensor cores fed and everything else off their path:
//
//   1. Block and tile.  256 threads in 2 warpgroups own one 128-row A tile
//      and walk their B split's 128-column tiles in ascending order (the
//      TPU's sequential j axis).  Warpgroup g computes rows 64g..64g+63 x
//      all 128 columns with one wgmma.mma_async m64n128k16 (bf16 in, f32
//      accumulators in 64 registers a thread) per 16 of depth, both
//      operands read from shared memory.  The grid is (B splits, A tiles)
//      with the split fastest: the ~264 blocks resident at once cover a few
//      A tiles times all splits, whose operand rows fit the 50 MB L2
//      together, so A and B come from HBM about once per wave.
//   2. Operand ring.  Depth steps of 64 bf16 (one 128-byte row): A 128 x 64
//      and B 128 x 64, 32 KB a stage, 3 stages.  All 256 threads copy each
//      stage with 8 cp.async of 16 B apiece, as one sequence over (B tile,
//      depth step) across the whole split, 2 stages ahead: the next tile's
//      first stages are in flight during this tile's epilogue and the ring
//      never drains at a tile boundary.  About 100-107 KB of shared memory
//      and at most 128 registers (__launch_bounds__(256, 2)) let two blocks
//      share an SM, so one block's epilogue overlaps the other's products.
//   3. Layout.  Both tables are K-major, so both operands are
//      non-transposed.  Chunk c (16 B) of row r of a stage sits at chunk
//      c ^ (r & 7) (the 128-byte swizzle) on a 1024-byte-aligned base, which
//      smem_desc describes; cp.async writes through the generic proxy and
//      wgmma reads through the async proxy, hence fence.proxy.async between
//      the landed stage and the products.
//   4. Epilogue in registers, on keys.  Each accumulator becomes
//      key = ordered_bits(d) << 32 | index (-0.0 canonicalised to +0.0
//      first, so JAX's equal zeros tie), and the minimum key is the
//      smallest distance at the lowest index: JAX's first match, whatever
//      the order of the folds.  Rows: a running min per thread across its
//      B tiles, a quad shuffle and one 64-bit atomicMin per row at the end.
//      Columns (bidirectional instance only): a butterfly over the warp's
//      16 rows, a [8 warps][128] table in shared memory, and one atomicMin
//      per column per tile.  The [Na, Nb] tile never touches shared memory.
//
//   5. Batch.  A bucket of pairs that share a geometry runs as one launch:
//      grid z is the item, and each z slice reads its own Fa, Ma, Fb and Mb
//      and writes its own row and column keys at a fixed stride (every item
//      pads to the same na_pad and nb_pad).  Indices stay item-local, so an
//      item's keys are those of its own launch.  This is the batch grid
//      axis that jax.vmap prepends to the Pallas grid.
//
// Division is IEEE (-dots / fmaxf(cnt, 1)); do not build with fast math, and
// do not swap it for a reciprocal (x * (1/3) is not x / 3 bitwise).  Left for
// later work: TMA copies with tensor maps, warp-specialised producer and
// consumer warpgroups, and a persistent grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TA = 128;        // A rows per block
constexpr int TB = 128;        // B columns per tile
constexpr int TK = 64;         // depth per stage: one 128-byte row of bf16
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int NTHREADS = 256;  // 2 warpgroups: rows 0-63 and 64-127

constexpr int OPERAND_BYTES = TA * TK * 2;        // one operand of a stage
constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;    // A then B
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int SWIZZLE_ALIGN = 1024;               // 8 rows of 128 bytes
static_assert(TA == TB, "A and B stages share one layout");

constexpr int MASK_RING_BYTES = STAGES * TB * 4;   // B masks per stage
// Ring (aligned up in the kernel), the B masks of each stage and, for the
// column fold only, the per-warp column minima: 100,864 B (directed) /
// 109,056 B (bidirectional), so two blocks fit on an SM.
template <bool kColumns>
constexpr size_t smem_bytes() {
  return SWIZZLE_ALIGN + RING_BYTES + MASK_RING_BYTES +
         (kColumns ? sizeof(unsigned long long) * (NTHREADS / 32) * TB : 0);
}

// Order-preserving bits of d: unsigned order of the result is float order,
// with -0.0 canonicalised to +0.0 first.
__device__ __forceinline__ unsigned int ordered_bits(float d) {
  if (d == 0.0f) d = 0.0f;
  const unsigned int u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_key(float d, int idx) {
  return (static_cast<unsigned long long>(ordered_bits(d)) << 32) |
         static_cast<unsigned int>(idx);
}

__device__ __forceinline__ unsigned long long key_min(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: this makes the landed stage visible to the latter.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major, 128-byte-swizzled operand
// whose 8-row groups lie 1024 bytes apart: start address >> 4 (bits 0-13),
// LBO 1 (16 B, ignored for swizzled K-major), SBO 64 (1024 B), layout 1
// (128B swizzle, bits 62-63).  +2 advances K by 16 bf16 (32 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64] += A (64 x 16, desc a) . B (128 x 16, desc b)^T, both K-major; d is
// overwritten instead when accumulate is 0.  Thread (warp w of the
// warpgroup, lane l) holds rows 16w + l/4 (d[4i], d[4i+1]) and 16w + l/4 + 8
// (d[4i+2], d[4i+3]) at columns 8i + 2(l%4) + {0, 1}, i = 0..15.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Butterfly fold of 8 column minima over the 8 lanes of equal lane % 4 (a
// warp's 16 rows): at each step lanes l and l ^ 4 HALF swap half of their
// values, the lane keeping the half that bit 4 HALF of l selects.  Lane l
// ends with the minimum of value (l / 4) in v[0].
template <int HALF>
__device__ __forceinline__ void fold_columns(unsigned long long (&v)[8],
                                             int lane) {
  const bool upper = lane & (4 * HALF);
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const unsigned long long send = upper ? v[k] : v[k + HALF];
    const unsigned long long keep = upper ? v[k + HALF] : v[k];
    v[k] = key_min(keep, __shfl_xor_sync(0xffffffffu, send, 4 * HALF));
  }
  if constexpr (HALF > 1) fold_columns<HALF / 2>(v, lane);
}

// One stage: A rows a0.. and B rows b0.. at depth k0..k0+63.  Chunk c (16 B)
// of row r goes to physical chunk c ^ (r & 7) of the row's 128 bytes.
__device__ __forceinline__ void load_stage(
    uint32_t slot, const __nv_bfloat16* __restrict__ fa,
    const __nv_bfloat16* __restrict__ fb, int a0, int b0, int k0, int kc,
    int tid) {
#pragma unroll
  for (int n = 0; n < TA * TK / 8 / NTHREADS; ++n) {
    const int q = tid + n * NTHREADS;
    const int row = q >> 3, c = q & 7;
    const uint32_t dst = slot + row * (TK * 2) + ((c ^ (row & 7)) << 4);
    cp_async16(dst, fa + static_cast<size_t>(a0 + row) * kc + k0 + c * 8);
    cp_async16(dst + OPERAND_BYTES,
               fb + static_cast<size_t>(b0 + row) * kc + k0 + c * 8);
  }
}

// kColumns: also fold the column argmin into col_keys (unused, and may be
// null, when false).
template <bool kColumns>
__global__ void __launch_bounds__(NTHREADS, 2)
nn_kernel(const __nv_bfloat16* __restrict__ fa, const int* __restrict__ ma,
          const __nv_bfloat16* __restrict__ fb, const int* __restrict__ mb,
          int kc, int nb_tiles, int tiles_per_split,
          unsigned long long* __restrict__ row_keys,
          unsigned long long* __restrict__ col_keys) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle needs 1024-byte-aligned stages
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (SWIZZLE_ALIGN - (raw & (SWIZZLE_ALIGN - 1))) &
                       (SWIZZLE_ALIGN - 1);
  const uint32_t ring = raw + pad;
  const uint32_t mask_ring = ring + RING_BYTES;  // B masks per stage
  const int* smb_ring =
      reinterpret_cast<const int*>(smem_raw + pad + RING_BYTES);
  unsigned long long* col_table = reinterpret_cast<unsigned long long*>(
      smem_raw + pad + RING_BYTES + MASK_RING_BYTES);  // [8 warps][TB]

  // this z slice's item of the batch: its tables and keys at fixed strides
  {
    const size_t item = blockIdx.z;
    const size_t na_pad = static_cast<size_t>(gridDim.y) * TA;
    const size_t nb_pad = static_cast<size_t>(nb_tiles) * TB;
    fa += item * na_pad * kc;
    ma += item * na_pad;
    fb += item * nb_pad * kc;
    mb += item * nb_pad;
    row_keys += item * na_pad;
    if constexpr (kColumns) col_keys += item * nb_pad;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int a0 = blockIdx.y * TA;
  const int j_begin = blockIdx.x * tiles_per_split;
  const int j_end = min(j_begin + tiles_per_split, nb_tiles);

  // This thread's two accumulator rows (warpgroup tid / 128 holds rows
  // 64 (tid / 128) .. +64), their masks and their running best keys.
  int rows[2], row_mask[2];
  unsigned long long best[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] =
        a0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2) + 8 * h;
    row_mask[h] = ma[rows[h]];
    best[h] = make_key(INFINITY, 0);
  }

  const int nk = kc / TK;
  const int total = (j_end - j_begin) * nk;
  // next stage to load, as (B tile, K step); a tile's B masks ride with
  // its last K step, whose slot stays untouched until its epilogue is done
  int load_j = j_begin, load_k = 0;
  auto load_next = [&](int s) {
    load_stage(ring + (s % STAGES) * STAGE_BYTES, fa, fb, a0, load_j * TB,
               load_k * TK, kc, tid);
    if (load_k == nk - 1 && tid < TB / 4)
      cp_async16(mask_ring + (s % STAGES) * TB * 4 + tid * 16,
                 mb + load_j * TB + tid * 4);
    if (++load_k == nk) { load_k = 0; ++load_j; }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_next(s);
    cp_async_commit();
  }

  float acc[64] = {};
  int j = j_begin, kstep = 0;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage s landed
    fence_proxy_async();
    __syncthreads();  // everyone's copies landed; stage s-1 fully consumed
    fence_proxy_async();
    if (s + STAGES - 1 < total) load_next(s + STAGES - 1);  // into s-1's slot
    cp_async_commit();

    const uint32_t slot = ring + (s % STAGES) * STAGE_BYTES;
    const uint64_t da = smem_desc(slot + (tid >> 7) * 64 * TK * 2);
    const uint64_t db = smem_desc(slot + OPERAND_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, kstep | kk);
    wgmma_commit();
    wgmma_wait_all();

    if (++kstep < nk) continue;
    kstep = 0;
    const int b0 = j * TB;
    ++j;

    // Epilogue from the accumulators: every (distance, index) becomes a
    // key, and the minimum key is the first match, so each fold is a min.
    const int* smb = smb_ring + (s % STAGES) * TB;
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int g = 0; g < 4; ++g) {  // columns 32g .. 32g + 31 of the tile
      unsigned long long col_min[8];  // [2 ii + e]: column 8 (4g + ii) + c0 + e
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * g + ii;
        const int2 mb2 = *reinterpret_cast<const int2*>(smb + 8 * i + c0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cnt = __popc(row_mask[h] & (e ? mb2.y : mb2.x));
            const float d = cnt > 0 ? -acc[4 * i + 2 * h + e] /
                                          fmaxf(static_cast<float>(cnt), 1.0f)
                                    : INFINITY;
            const unsigned long long hi =
                static_cast<unsigned long long>(ordered_bits(d)) << 32;
            best[h] = key_min(best[h], hi | static_cast<unsigned int>(
                                                  b0 + 8 * i + c0 + e));
            if constexpr (kColumns) {
              const unsigned long long k =
                  hi | static_cast<unsigned int>(rows[h]);
              col_min[2 * ii + e] = h ? key_min(col_min[2 * ii + e], k) : k;
            }
          }
        }
      }
      // b -> a: fold the warp's 16 rows; lane l then holds t = l / 4 and
      // writes it to its warp's row of the table
      if constexpr (kColumns) {
        fold_columns<4>(col_min, lane);
        const int t = lane >> 2;
        col_table[(tid >> 5) * TB + 32 * g + 8 * (t >> 1) + c0 + (t & 1)] =
            col_min[0];
      }
    }
    // Compiled out of the directed instance, barrier included; the branch
    // is uniform, so every thread meets the same barriers.
    if constexpr (kColumns) {
      __syncthreads();
      if (tid < TB) {
        unsigned long long k = col_table[tid];
#pragma unroll
        for (int w = 1; w < NTHREADS / 32; ++w)
          k = key_min(k, col_table[w * TB + tid]);
        atomicMin(col_keys + b0 + tid, k);
      }
    }
  }
  // a -> b: the row over the quad's 4 x 32 columns, one atomic per row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned long long k = best[h];
    k = key_min(k, __shfl_xor_sync(0xffffffffu, k, 1));
    k = key_min(k, __shfl_xor_sync(0xffffffffu, k, 2));
    if ((lane & 3) == 0) atomicMin(row_keys + rows[h], k);
  }
}

// Opt the instance into its dynamic shared memory (above the 48 KB default).
template <bool kColumns>
cudaError_t prepare() {
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&nn_kernel<kColumns>),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<kColumns>()));
}

template <bool kColumns>
cudaError_t occupancy(int* blocks_per_sm, int* smem) {
  *smem = static_cast<int>(smem_bytes<kColumns>());
  cudaError_t err = prepare<kColumns>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, &nn_kernel<kColumns>, NTHREADS, *smem);
}

template <bool kColumns>
cudaError_t launch(const void* fa, const void* ma, const void* fb,
                   const void* mb, int na_pad, int nb_pad, int kc,
                   int tiles_per_split, int batch, void* row_keys,
                   void* col_keys, void* stream) {
  if (na_pad <= 0 || nb_pad <= 0 || na_pad % TA || nb_pad % TB || kc <= 0 ||
      kc % TK || tiles_per_split <= 0 || na_pad / TA > 65535 || batch <= 0 ||
      batch > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare<kColumns>();
  if (err != cudaSuccess) return err;
  // B split fastest: the blocks resident at once cover a few A tiles times
  // all splits, whose operands fit the 50 MB L2 together
  const int nb_tiles = nb_pad / TB;
  dim3 grid((nb_tiles + tiles_per_split - 1) / tiles_per_split, na_pad / TA,
            batch);
  nn_kernel<kColumns><<<grid, NTHREADS, smem_bytes<kColumns>(),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(fa), static_cast<const int*>(ma),
      static_cast<const __nv_bfloat16*>(fb), static_cast<const int*>(mb), kc,
      nb_tiles, tiles_per_split, static_cast<unsigned long long*>(row_keys),
      static_cast<unsigned long long*>(col_keys));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry the Python wrapper pads and checks against.
int nn_bidir_tile_rows() { return TA; }
int nn_bidir_tile_depth() { return TK; }

// fa/fb: bf16 [batch, na_pad, kc] / [batch, nb_pad, kc]; ma/mb: int32 9-bit
// validity masks [batch, na_pad] / [batch, nb_pad]; row_keys [batch, na_pad] /
// col_keys [batch, nb_pad]: uint64, initialised by the caller to the key of
// (+inf, 0).  batch = 1 is one pair.  Launches on `stream` and returns
// cudaGetLastError().
int nn_bidir_launch(const void* fa, const void* ma, const void* fb,
                    const void* mb, int na_pad, int nb_pad, int kc,
                    int tiles_per_split, int batch, void* row_keys,
                    void* col_keys, void* stream) {
  return static_cast<int>(launch<true>(fa, ma, fb, mb, na_pad, nb_pad, kc,
                                       tiles_per_split, batch, row_keys,
                                       col_keys, stream));
}

// The directed search: as nn_bidir_launch without the column keys.
int nn_directed_launch(const void* fa, const void* ma, const void* fb,
                       const void* mb, int na_pad, int nb_pad, int kc,
                       int tiles_per_split, int batch, void* row_keys,
                       void* stream) {
  return static_cast<int>(launch<false>(fa, ma, fb, mb, na_pad, nb_pad, kc,
                                        tiles_per_split, batch, row_keys,
                                        nullptr, stream));
}

// Resident blocks per SM and dynamic shared memory of one instance
// (columns != 0: nn_bidir); returns a cudaError_t.
int nn_kernel_occupancy(int columns, int* blocks_per_sm, int* smem) {
  return static_cast<int>(columns ? occupancy<true>(blocks_per_sm, smem)
                                  : occupancy<false>(blocks_per_sm, smem));
}

const char* nn_bidir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
