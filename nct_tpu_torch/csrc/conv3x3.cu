// VGG-19's 3x3, stride-1 float32 convolution plus bias, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions
// (nct_tpu/models/vgg19.py, lax.conv_general_dilated) to XLA.  It exists
// for one property that cuDNN does not give: every output's sum runs over
// (ci, ky, kx) in an order that depends on nothing but those indices.
// cuDNN picks its algorithm, and so its order of addition, by the tensor's
// shape; a row band of an image convolved on its own then differs in the
// last bits from the same rows of the whole image, and a row-sharded pair
// drifts from the single process's (models/vgg19.py, parallel/mesh.py).
// Here each output is ONE float32 fmaf chain,
//
//     acc = 0;  for ci in 0..Cin-1, ky in 0..2, kx in 0..2:
//         acc = fmaf(w[co][ci][ky][kx], x[ci][y + ky][x + kx - 1], acc);
//     y[co][y][x] = acc + bias[co]
//
// (the input rows already padded by the caller: row y + ky of the input is
// output row y's tap ky; columns -1 and W read zero), so a band's outputs
// are the whole image's rows bit for bit, whatever the band's height, the
// image's width or the tile that computes them.  No TF32, no tensor cores.
//
// Bound: operations.  2 H W Cin Cout 9 float32 operations against
// (Cin (H+2) W + Cout H W + 9 Cin Cout) * 4 bytes: conv1_2 of the 452x680
// image does 22.7 GFLOP over 158 MB, ~140 FLOP/byte against the card's
// ~20 FLOP/byte ridge in float32 (67 TFLOP/s over 3.35 TB/s).  A simple
// register-blocked design:
//
//   * a block of 256 threads owns an 8-row x 32-column output tile for 64
//     output channels, and walks Cin in chunks of 8: the input tile
//     (10 x 34 x 8, rows padded to a stride of 40 floats so that a warp's
//     4 rows x 8 columns hit 32 banks) and the weight chunk
//     ([8 ci][9 taps][64 co], from weights the wrapper transposes to
//     [Cin][3][3][Cout]) are staged in shared memory;
//   * thread (g, ty, tx) accumulates 16 output channels (group g) x 4
//     pixels (row ty, columns tx, tx + 8, tx + 16, tx + 24) in 64
//     registers; a warp shares g, so each weight read is one broadcast
//     float4, and the 4 pixel reads are conflict-free;
//   * per (ci, ky, kx): 4 + 4 shared-memory reads for 64 fmaf;
//   * __launch_bounds__(256, 2): at most 128 registers, so two blocks
//     share an SM (ptxas spills 80 bytes; unbounded it took 141 registers
//     and one block per SM, and the 16 layers of the 452x680 image took
//     16.8 ms on an H100 against 14.4 bounded, bitwise the same).
//
// Left for later work: double-buffered cp.async staging, wider tiles for
// the deep layers (conv5_1 of the 452x680 image has 64 blocks for 132
// SMs), and the ReLU and the next pool fused in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;             // output rows per block
constexpr int TW = 32;            // output columns per block
constexpr int CO_T = 64;          // output channels per block
constexpr int CI_C = 8;           // input channels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int PX = 4;             // pixels per thread (columns tx + 8p)
constexpr int CO = 16;            // output channels per thread
constexpr int IN_ROWS = TH + 2;
constexpr int IN_COLS = TW + 2;
constexpr int IN_STRIDE = 40;     // >= IN_COLS; 40 % 32 = 8 spreads 4 rows

__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const float* __restrict__ x,      // [n, cin, h + 2, w]
               const float* __restrict__ wt,     // [cin, 9, cout]
               const float* __restrict__ bias,   // [cout]
               float* __restrict__ y,            // [n, cout, h, w]
               int cin, int cout, int h, int w, int co_blocks) {
  __shared__ float s_in[CI_C][IN_ROWS][IN_STRIDE];
  __shared__ __align__(16) float s_w[CI_C][9][CO_T];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = warp >> 1;                          // output channel group
  const int ty = ((warp & 1) << 2) + (lane >> 3);   // tile row 0..7
  const int tx = lane & 7;                          // tile column 0..7
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int co0 = (blockIdx.z % co_blocks) * CO_T;
  const int n = blockIdx.z / co_blocks;
  const int hp = h + 2;
  const float* xn = x + static_cast<size_t>(n) * cin * hp * w;

  float acc[CO][PX];
#pragma unroll
  for (int q = 0; q < CO; ++q)
#pragma unroll
    for (int p = 0; p < PX; ++p) acc[q][p] = 0.0f;

  for (int c0 = 0; c0 < cin; c0 += CI_C) {
    const int nc = min(CI_C, cin - c0);
    __syncthreads();                    // the previous chunk is consumed
    for (int i = tid; i < CI_C * IN_ROWS * IN_COLS; i += THREADS) {
      const int c = i / (IN_ROWS * IN_COLS);
      const int r = (i / IN_COLS) % IN_ROWS;
      const int col = i % IN_COLS;
      const int gy = y0 + r;            // row of the padded input
      const int gx = x0 - 1 + col;      // column -1 and w are the padding
      float v = 0.0f;
      if (c < nc && gy < hp && gx >= 0 && gx < w)
        v = xn[(static_cast<size_t>(c0 + c) * hp + gy) * w + gx];
      s_in[c][r][col] = v;
    }
    for (int i = tid; i < CI_C * 9 * CO_T; i += THREADS) {
      const int c = i / (9 * CO_T);
      const int k = (i / CO_T) % 9;
      const int co = i % CO_T;
      float v = 0.0f;
      if (c < nc && co0 + co < cout)
        v = wt[(static_cast<size_t>(c0 + c) * 9 + k) * cout + co0 + co];
      s_w[c][k][co] = v;
    }
    __syncthreads();
    // one fmaf chain per output, over (ci, ky, kx) in ascending order
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float xv[PX];
#pragma unroll
          for (int p = 0; p < PX; ++p) xv[p] = s_in[c][ty + ky][tx + 8 * p + kx];
          const float4* wp =
              reinterpret_cast<const float4*>(&s_w[c][ky * 3 + kx][g * CO]);
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 wv = wp[q];
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              acc[4 * q + 0][p] = fmaf(wv.x, xv[p], acc[4 * q + 0][p]);
              acc[4 * q + 1][p] = fmaf(wv.y, xv[p], acc[4 * q + 1][p]);
              acc[4 * q + 2][p] = fmaf(wv.z, xv[p], acc[4 * q + 2][p]);
              acc[4 * q + 3][p] = fmaf(wv.w, xv[p], acc[4 * q + 3][p]);
            }
          }
        }
      }
    }
  }

  const int oy = y0 + ty;
  if (oy >= h) return;
#pragma unroll
  for (int q = 0; q < CO; ++q) {
    const int co = co0 + g * CO + q;
    if (co >= cout) break;
    const float b = bias[co];
    float* row = y + ((static_cast<size_t>(n) * cout + co) * h + oy) * w;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int ox = x0 + tx + 8 * p;
      if (ox < w) row[ox] = acc[q][p] + b;
    }
  }
}

}  // namespace

extern "C" {

// x: float32 [n, cin, h + 2, w] (rows padded by the caller); wt: float32
// [cin, 3, 3, cout]; bias: float32 [cout]; y: float32 [n, cout, h, w].
// All contiguous on one device.  Launches on `stream` and returns
// cudaGetLastError().
int conv3x3_launch(const void* x, const void* wt, const void* bias, void* y,
                   int n, int cin, int cout, int h, int w, void* stream) {
  const int co_blocks = (cout + CO_T - 1) / CO_T;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n * co_blocks);
  conv3x3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(y), cin, cout, h,
      w, co_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM (the occupancy API).
int conv3x3_occupancy(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, conv3x3_kernel, THREADS, 0));
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
