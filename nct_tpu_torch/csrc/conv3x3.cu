// VGG-19's 3x3, stride-1 float32 convolution plus bias (and, on request,
// the ReLU that follows it), for Hopper's CUDA cores (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions
// (nct_tpu/models/vgg19.py, lax.conv_general_dilated) to XLA.  It exists
// for one property that cuDNN does not promise: every output's sum runs
// over (ci, ky, kx) in an order that depends on nothing but those indices.
// cuDNN picks its algorithm, and so its order of addition, by the tensor's
// shape; a row band of an image convolved on its own may then differ in
// the last bits from the same rows of the whole image, and a row-sharded
// pair drifts from the single process's (models/vgg19.py,
// parallel/mesh.py).  Here each output is ONE float32 fmaf chain,
//
//     acc = 0;  for ci in 0..Cin-1, ky in 0..2, kx in 0..2:
//         acc = fmaf(w[co][ci][ky][kx], x[ci][y + ky][x + kx - 1], acc);
//     y[co][y][x] = acc + bias[co]          (then max(., 0) with relu)
//
// (the input rows already padded by the caller: row y + ky of the input is
// output row y's tap ky; columns -1 and W read zero), so a band's outputs
// are the whole image's rows bit for bit, whatever the band's height, the
// image's width or the tile that computes them.  What depends on the shape
// is the tile, never the order.  So no split of Cin (no sum of partial
// chains), no tensor cores (TF32 rounds the operands; Hopper has no
// float32 wgmma), no Winograd or FFT, no fast math and no atomics.
// ops/conv3x3.py's conv3x3_chain is the same chain written out in
// correctly rounded float64 steps: the tests hold every tile to it bit for
// bit.
//
// Bound: operations.  2 H W Cin Cout 9 float32 operations against
// (Cin (H+2) W + Cout H W + 9 Cin Cout) * 4 bytes: conv1_2 of the 452x680
// image does 22.7 GFLOP over 158 MB, ~140 FLOP/byte against the card's
// ~20 FLOP/byte ridge in float32 (67 TFLOP/s, no tensor cores, over 3.35
// TB/s), so the kernel lives on the FFMA issue rate: one warp instruction a
// cycle per SM sub-partition.  Parallelism comes only from the outputs.
// What the design does about each loss of the first version (one 8 x 32 x
// 64 tile for every layer, interleaved columns, synchronous staging):
//
//   * kx reuse in registers.  A thread owns RPY rows x RPX = 4 consecutive
//     columns x RCO output channels.  For each input channel it reads the
//     RPY + 2 input rows it needs, 6 values each (LDS.128 + LDS.64: the
//     staged row starts at column -1, so its run starts on a 16-byte
//     boundary), and runs every (ky, kx) from registers; each tap's
//     weights are RCO / 4 float4 reads that every lane of the warp shares
//     (a broadcast), used for RPY x 4 pixels.  Tile 1 (1 x 4 x 8): 6 pixel
//     and 18 weight loads per 288 fmaf an input channel; tile 0 (2 x 4 x
//     8): 8 and 18 per 576 (the first version: 72 per 576).  A
//     quarter-warp reads one row's 128 bytes (8 column threads) or two
//     64-byte runs 4 rows apart, whose 20-float row stride puts them 16
//     banks apart (4 column threads, one row each), so pixel reads have
//     no bank conflicts.
//   * an asynchronous ring.  STAGES = 2 buffers of (input chunk of CI_C = 8
//     channels x (TH + 2) rows x (TW + 2) columns, weight chunk [CI_C][9]
//     [CO_T]) in dynamic shared memory; cp.async fills chunk k + 1 while
//     the block computes chunk k, with one cp.async.wait_group and one
//     __syncthreads per chunk (a third stage measured no faster and cost
//     occupancy).  The input takes 4-byte copies with zero-fill (the -1
//     and W columns, rows past the tensor, the ragged tile edge, widths
//     that are not a multiple of 4: 170, 85, 43, 250, 125, 63 among VGG's),
//     so any width and any band of rows work; the weights ([Cin][3][3]
//     [Cout], Cout a multiple of 4 at every VGG layer) take 16-byte copies.
//     Each thread's copy offsets are computed once, before the loop, so a
//     chunk costs a copy instruction and an address add per position and
//     channel; the last, partial pass is a predicated copy, not a branch.
//     TMA is not used: its global strides must be multiples of 16 bytes,
//     which the input's rows are not at most of VGG's widths, and the
//     weights alone would gain little.
//   * tiles that fill the card.  Three compile-time tiles (Tile0..Tile2
//     below); the wrapper (ops/conv3x3.py, pick_config) picks one per
//     launch by a fixed rule on (n, h, w, cout): the largest when its grid
//     fills its resident slots well, else the smaller ones, whose
//     128-thread blocks spread the deep layers' few outputs over every SM.
//   * the epilogue adds the bias after the chain, applies the ReLU when
//     asked (the VGG forward asks; x < 0 ? 0 : x, as torch.relu: NaN stays
//     NaN, and an output is never -0), and stores 4 columns as one float4
//     where the row allows it.
//
// ptxas (-Xptxas -v, printed by chip_smoke.py's build phase) reports each
// instance's registers: the launch bounds hold each tile at its designed
// resident blocks without spills.  Measured times, shares of the bound and
// cuDNN's times per layer: PERF.md (chip_smoke.py phase 3c).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RPX = 4;    // consecutive output columns a thread owns
constexpr int CI_C = 8;   // input channels per staged chunk

// A tile: TX column threads (RPX columns each) x TY row threads (RPY rows
// each) x TC channel groups (RCO channels each); a warp holds one channel
// group, so its weight reads are broadcasts.
template <int TX_, int TY_, int RPY_, int TC_, int RCO_, int STAGES_,
          int MINB_>
struct Tile {
  static constexpr int TX = TX_, TY = TY_, RPY = RPY_, TC = TC_, RCO = RCO_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int TH = TY * RPY, TW = TX * RPX, CO_T = TC * RCO;
  static constexpr int THREADS = TX * TY * TC;
  static constexpr int WPG = TX * TY / 32;          // warps per channel group
  static constexpr int IN_ROWS = TH + 2, IN_COLS = TW + 2;
  // a multiple of 4 >= TW + 2; 8 column threads: a quarter-warp reads one
  // row, so any such stride is free of bank conflicts; 4 (one row each): a
  // quarter-warp reads rows ty and ty + 4, 4 * 20 floats = 16 banks apart
  static constexpr int IN_STRIDE = TX == 8 ? TW + 4 : 20;
  static constexpr int IN_CH = IN_ROWS * IN_STRIDE;
  static constexpr int IN_STAGE = CI_C * IN_CH;
  static constexpr int W_STAGE = CI_C * 9 * CO_T;
  static constexpr int STAGE = IN_STAGE + W_STAGE;    // floats
  static constexpr int SMEM = STAGES * STAGE * 4;     // bytes
  static constexpr int POS = (IN_ROWS * IN_COLS + THREADS - 1) / THREADS;
  static constexpr int W_ROW4 = CO_T / 4;             // float4 per weight row
  static constexpr int W_ITERS = (CI_C * 9 * W_ROW4 + THREADS - 1) / THREADS;
  static_assert(TX == 8 || (TX == 4 && TY == 8 && RPY == 1),
                "lane layouts: 8 x 4k threads, or 4 x 8 of one row each");
  static_assert((TX * TY) % 32 == 0 && RCO % 4 == 0, "tile shape");
  static_assert(THREADS % W_ROW4 == 0, "whole weight rows per pass");
  static_assert(STAGES >= 2, "a ring has two stages at least");
};

// The three tiles, in the order of ops/conv3x3.py's CONFIGS (output rows x
// columns x channels of a block; a thread's rows x columns x channels).
using Tile0 = Tile<8, 4, 2, 4, 8, 2, 4>;   // 8 x 32 x 32, 128 thr, 2 x 4 x 8
using Tile1 = Tile<4, 8, 1, 4, 8, 2, 5>;   // 8 x 16 x 32, 128 thr, 1 x 4 x 8
using Tile2 = Tile<4, 8, 1, 4, 4, 2, 6>;   // 8 x 16 x 16, 128 thr, 1 x 4 x 4

constexpr int FLAG_RELU = 1;     // max(., 0) after the bias
constexpr int FLAG_VEC_Y = 2;    // w % 4 == 0 and y 16-byte aligned
constexpr int FLAG_VEC_W = 4;    // cout % 4 == 0 and wt 16-byte aligned

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte copy; bytes 0 zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// the same, issued only where `on` (a predicated copy: no branch)
__device__ __forceinline__ void cp_async4_if(bool on, unsigned dst,
                                             const float* src, int bytes) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
               " @p cp.async.ca.shared.global [%0], [%1], 4, %2;\n}\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(static_cast<int>(on))
               : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
conv3x3_kernel(const float* __restrict__ x,      // [n, cin, h + 2, w]
               const float* __restrict__ wt,     // [cin, 9, cout]
               const float* __restrict__ bias,   // [cout]
               float* __restrict__ y,            // [n, cout, h, w]
               int cin, int cout, int h, int w, int co_blocks, int flags) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = warp / T::WPG;                      // channel group
  int tx, ty;                                        // ty: thread row
  if constexpr (T::TX == 8) {
    tx = lane & 7;
    ty = (warp % T::WPG) * 4 + (lane >> 3);
  } else {                                          // quarter: ty, ty + 4
    tx = lane & 3;
    ty = ((lane >> 2) & 1) * 4 + (lane >> 3);
  }
  const int x0 = blockIdx.x * T::TW;
  const int y0 = blockIdx.y * T::TH;
  const int n = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z - n * co_blocks) * T::CO_T;
  const int hp = h + 2;
  const size_t plane = static_cast<size_t>(hp) * w;
  const float* xn = x + static_cast<size_t>(n) * cin * plane;

  // Staging offsets, computed once, so a chunk is copied with address
  // increments alone.  Input: this thread's positions p = tid + i * THREADS
  // of a channel's (TH + 2) x (TW + 2) tile, as a byte offset in the stage
  // and an element offset in the channel plane with its copy size (0:
  // zero-fill, which reads nothing); only the last pass may fall past the
  // tile (last_on false: no copy).
  const unsigned s_base = smem_u32(smem);
  int in_dst[T::POS], in_src[T::POS], in_bytes[T::POS];
#pragma unroll
  for (int i = 0; i < T::POS; ++i) {
    const int p = tid + i * T::THREADS;
    const int r = p / T::IN_COLS;
    const int col = p - r * T::IN_COLS;
    const int gy = y0 + r;                          // row of the padded input
    const int gx = x0 - 1 + col;                    // columns -1 and w: zero
    const bool inside = gy < hp && gx >= 0 && gx < w;
    in_dst[i] = 4 * (r * T::IN_STRIDE + col);
    in_src[i] = inside ? gy * w + gx : 0;
    in_bytes[i] = inside ? 4 : 0;
  }
  const bool last_on =
      tid + (T::POS - 1) * T::THREADS < T::IN_ROWS * T::IN_COLS;
  // Weights: this thread's float4 of rows w_row0 + i * W_RSTEP of a chunk's
  // [CI_C * 9][CO_T] block, at byte 16 * (tid + i * THREADS) of the stage's
  // weights.
  constexpr int W_RSTEP = T::THREADS / T::W_ROW4;
  const int w_row0 = tid / T::W_ROW4;
  const int w_co = co0 + 4 * (tid % T::W_ROW4);
  const bool w_vec = flags & FLAG_VEC_W;

  auto load = [&](int chunk, int stage) {
    const int c0 = chunk * CI_C;
    const int nc = min(CI_C, cin - c0);
    const unsigned sb = s_base + stage * (T::STAGE * 4);
    const float* xc = xn + static_cast<size_t>(c0) * plane;
#pragma unroll
    for (int c = 0; c < CI_C; ++c) {
      if (c < nc) {
#pragma unroll
        for (int i = 0; i < T::POS - 1; ++i)
          cp_async4(sb + c * (T::IN_CH * 4) + in_dst[i], xc + in_src[i],
                    in_bytes[i]);
        constexpr int L = T::POS - 1;
        cp_async4_if(last_on, sb + c * (T::IN_CH * 4) + in_dst[L],
                     xc + in_src[L], in_bytes[L]);
      }
      xc += plane;
    }
    const int rows = nc * 9;
    const float* wc = wt + (static_cast<size_t>(c0) * 9 + w_row0) * cout + w_co;
#pragma unroll
    for (int i = 0; i < T::W_ITERS; ++i) {
      const int row = w_row0 + i * W_RSTEP;
      const unsigned dst = sb + T::IN_STAGE * 4 + 16 * (tid + i * T::THREADS);
      if (row < CI_C * 9) {
        if (w_vec) {
          const bool ok = row < rows && w_co < cout;
          cp_async16(dst, ok ? wc : wt, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = row < rows && w_co + e < cout;
            cp_async4(dst + 4 * e, ok ? wc + e : wt, ok ? 4 : 0);
          }
        }
      }
      wc += static_cast<size_t>(W_RSTEP) * cout;
    }
  };

  float acc[T::RPY][T::RCO][RPX];
#pragma unroll
  for (int o = 0; o < T::RPY; ++o)
#pragma unroll
    for (int q = 0; q < T::RCO; ++q)
#pragma unroll
      for (int p = 0; p < RPX; ++p) acc[o][q][p] = 0.0f;

  const int chunks = (cin + CI_C - 1) / CI_C;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  int st = 0;                                       // stage of chunk k
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<T::STAGES - 2>();                 // chunk k has landed
    __syncthreads();                                // ... for every thread,
    {                                               // and chunk k - 1 is done
      const int nk = k + T::STAGES - 1;
      const int ns = st == 0 ? T::STAGES - 1 : st - 1;
      if (nk < chunks) load(nk, ns);
      cp_async_commit();
    }
    const float* s_in =
        smem + st * T::STAGE + ty * T::RPY * T::IN_STRIDE + RPX * tx;
    const float* s_w = smem + st * T::STAGE + T::IN_STAGE + g * T::RCO;
    const int nc = min(CI_C, cin - k * CI_C);
    // one fmaf chain per output, over (ci, ky, kx) in ascending order
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      float xv[T::RPY + 2][RPX + 2];                // the rows' 6 values each
#pragma unroll
      for (int r = 0; r < T::RPY + 2; ++r) {
        const float* xr = s_in + c * T::IN_CH + r * T::IN_STRIDE;
        const float4 a = *reinterpret_cast<const float4*>(xr);
        const float2 b = *reinterpret_cast<const float2*>(xr + 4);
        xv[r][0] = a.x; xv[r][1] = a.y; xv[r][2] = a.z; xv[r][3] = a.w;
        xv[r][4] = b.x; xv[r][5] = b.y;
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp = reinterpret_cast<const float4*>(
              s_w + (c * 9 + ky * 3 + kx) * T::CO_T);
#pragma unroll
          for (int j = 0; j < T::RCO / 4; ++j) {
            const float4 wv = wp[j];
#pragma unroll
            for (int o = 0; o < T::RPY; ++o) {
#pragma unroll
              for (int p = 0; p < RPX; ++p) {
                const float xi = xv[o + ky][p + kx];
                acc[o][4 * j][p] = fmaf(wv.x, xi, acc[o][4 * j][p]);
                acc[o][4 * j + 1][p] = fmaf(wv.y, xi, acc[o][4 * j + 1][p]);
                acc[o][4 * j + 2][p] = fmaf(wv.z, xi, acc[o][4 * j + 2][p]);
                acc[o][4 * j + 3][p] = fmaf(wv.w, xi, acc[o][4 * j + 3][p]);
              }
            }
          }
        }
      }
    }
    st = st == T::STAGES - 1 ? 0 : st + 1;
  }
  cp_async_wait<0>();                               // no copy left in flight

  const int ox = x0 + RPX * tx;
  if (ox >= w) return;
  const bool relu = flags & FLAG_RELU;
  const bool vec = (flags & FLAG_VEC_Y) && ox + RPX <= w;
#pragma unroll
  for (int o = 0; o < T::RPY; ++o) {
    const int oy = y0 + ty * T::RPY + o;
    if (oy >= h) break;
#pragma unroll
    for (int q = 0; q < T::RCO; ++q) {
      const int co = co0 + g * T::RCO + q;
      if (co >= cout) break;
      const float b = __ldg(bias + co);
      float v[RPX];
#pragma unroll
      for (int p = 0; p < RPX; ++p) {
        v[p] = acc[o][q][p] + b;
        if (relu) v[p] = v[p] < 0.0f ? 0.0f : v[p];
      }
      float* dst =
          y + ((static_cast<size_t>(n) * cout + co) * h + oy) * w + ox;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int p = 0; p < RPX; ++p)
          if (ox + p < w) dst[p] = v[p];
      }
    }
  }
}

template <class T>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(conv3x3_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              T::SMEM);
}

template <class T>
int launch(const float* x, const float* wt, const float* bias, float* y,
           int n, int cin, int cout, int h, int w, int flags,
           cudaStream_t stream) {
  const cudaError_t err = set_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int co_blocks = (cout + T::CO_T - 1) / T::CO_T;
  dim3 grid((w + T::TW - 1) / T::TW, (h + T::TH - 1) / T::TH, n * co_blocks);
  conv3x3_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(
      x, wt, bias, y, cin, cout, h, w, co_blocks, flags);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int occupancy(int* blocks) {
  cudaError_t err = set_smem<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, conv3x3_kernel<T>, T::THREADS, T::SMEM);
  return static_cast<int>(err);
}

template <class T>
void info(int* out) {
  out[0] = T::THREADS;
  out[1] = T::TH;
  out[2] = T::TW;
  out[3] = T::CO_T;
  out[4] = T::STAGES;
  out[5] = T::SMEM;
  out[6] = T::MINB;
}

constexpr int N_CONFIGS = 3;

}  // namespace

extern "C" {

// x: float32 [n, cin, h + 2, w] (rows padded by the caller); wt: float32
// [cin, 3, 3, cout]; bias: float32 [cout]; y: float32 [n, cout, h, w].
// All contiguous on one device.  config: the tile (0..2, ops/conv3x3.py's
// rule picks it); relu: max(., 0) after the bias.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for an unknown config).
int conv3x3_launch(const void* x, const void* wt, const void* bias, void* y,
                   int n, int cin, int cout, int h, int w, int relu,
                   int config, void* stream) {
  const int flags =
      (relu ? FLAG_RELU : 0) |
      (w % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 ? FLAG_VEC_Y
                                                              : 0) |
      (cout % 4 == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0
           ? FLAG_VEC_W : 0);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wt);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0: return launch<Tile0>(xf, wf, bf, yf, n, cin, cout, h, w, flags, s);
    case 1: return launch<Tile1>(xf, wf, bf, yf, n, cin, cout, h, w, flags, s);
    case 2: return launch<Tile2>(xf, wf, bf, yf, n, cin, cout, h, w, flags, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int conv3x3_configs() { return N_CONFIGS; }

// out[7]: threads, tile rows, tile columns, tile channels, stages, dynamic
// shared memory bytes, designed resident blocks per SM (launch bounds).
int conv3x3_config_info(int config, int* out) {
  switch (config) {
    case 0: info<Tile0>(out); return 0;
    case 1: info<Tile1>(out); return 0;
    case 2: info<Tile2>(out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM of a config (the occupancy API).
int conv3x3_occupancy(int config, int* blocks) {
  switch (config) {
    case 0: return occupancy<Tile0>(blocks);
    case 1: return occupancy<Tile1>(blocks);
    case 2: return occupancy<Tile2>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
