// 5x5 convolution of the SAVi decoder tail for Hopper (sm_90a), float32,
// forward only: out = [relu](conv(x, w) + b) with zero "same" padding of 2,
// on NHWC frames (N, H, W, 64) with HWIO weights (5, 5, 64, 64).
//
// Replaces the TPU kernel bench_pallas_conv.py::_conv5_kernel (launched by
// conv5_pallas, pallas_call at :97): one 5x5 64->64 layer of SAVi's
// ConvDecoder tail, written there as 15 (2048, 128) @ (128, 128) matmuls per
// frame with two image columns packed into the TPU's 128 lanes. The packing
// serves the TPU's lanes only and is not carried over.
//
// What bounds it on an H100: operations. A launch does 2 * 25 * 64 * 64 FLOPs
// per output pixel: at the eval shape (N = 9728 maps of 64 x 64) 8.16 TFLOP,
// 121.8 ms at 67 TFLOP/s float32, against 20.4 GB of input and output, 6.1 ms
// at 3.35 TB/s. The port runs float32 with TF32 off, so the products run on
// the CUDA cores (FFMA), not the tensor cores.
//
// Design: an implicit GEMM (M = output pixels, N = 64 output channels,
// K = 25 * 64 = 1600) with the weights resident in shared memory. All of them
// (400 KB) do not fit in an SM's 227 KB, and reloading them for every output
// tile would read some 60 TB out of L2 at the eval shape. So each block owns
// one half of the output channels (32 of them: 200 KB of weights), loads that
// half once, and walks a strided sequence of output tiles: one block per SM,
// even blocks take channels 0..31 and odd blocks 32..63. A tile is 16 rows by
// 64 columns of one frame. For each chunk of 4 input channels the block stages
// the tile's input halo (20 x 68 pixels, channel-major) in shared memory; the
// zero-padded border and the ragged edge of the frame are zeros written by the
// load, so the inner loop masks nothing. Thread (pixel group, channel group)
// of a 128 x 4 grid owns 8 consecutive pixels of one row times 8 output
// channels, 64 float32 accumulators; per input channel and kernel row it
// reads its 12 halo values once (3 float4) and reuses them across the 5 kernel
// columns, and each tap's 8 weights as 2 float4 that the lanes of a warp
// share: 13 shared loads for 320 FMAs. Offsets into the activations are
// 64-bit: at the eval shape one activation holds 2.55e9 floats, past int32.
// The grid is the SM count on x, whatever N is (no gridDim.y/z limit).
// Tensor cores (TF32 or bf16 wgmma) and TMA loads are later work.

#include <cuda_runtime.h>

namespace {

constexpr int C = 64;            // input and output channels
constexpr int KS = 5;            // kernel size
constexpr int PAD = KS / 2;
constexpr int HALF = 32;         // output channels per block
constexpr int TH = 16;           // tile rows
constexpr int TW = 64;           // tile columns
constexpr int HR = TH + KS - 1;  // 20 halo rows
constexpr int HC = TW + KS - 1;  // 68 halo columns (a multiple of 4: rows stay 16-byte aligned)
constexpr int CK = 4;            // input channels per staged chunk
constexpr int PX = 8;            // pixels per thread
constexpr int THREADS = 512;     // 128 pixel groups x 4 channel groups
constexpr int W_FLOATS = KS * KS * C * HALF;  // 51200
constexpr int HALO_FLOATS = CK * HR * HC;     // 5440
constexpr int SMEM_BYTES = (W_FLOATS + HALO_FLOATS) * (int)sizeof(float);  // 226560

static_assert(THREADS == (TH * TW / PX) * 4, "one thread per (pixel group, channel group)");
static_assert(TW / PX == 8 && THREADS / 32 == TH, "a warp owns one tile row");

__global__ void __launch_bounds__(THREADS, 1)
conv5_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out,
             long long n, int h, int wd, int relu) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // (25 taps, 64 in, 32 out): this block's half
  float* halo = ws + W_FLOATS;                   // (CK, HR, HC)

  const int half = blockIdx.x & 1;
  for (int i = threadIdx.x; i < W_FLOATS / 4; i += THREADS) {
    const int row = i >> 3, q = i & 7;  // row = tap * 64 + input channel; 8 float4 a row
    reinterpret_cast<float4*>(ws)[i] =
        __ldg(reinterpret_cast<const float4*>(w + (size_t)row * C + half * HALF) + q);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane & 3;              // local output channels 4g..4g+3 and 16+4g..16+4g+3
  const int py = warp;                 // tile row
  const int px0 = (lane >> 2) * PX;    // first tile column
  const int co = half * HALF + 4 * g;  // global output channel of the first float4
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + co));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + co + 16));
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};

  const int tiles_x = (wd + TW - 1) / TW;
  const long long tiles_per_frame = (long long)((h + TH - 1) / TH) * tiles_x;
  const long long ntiles = n * tiles_per_frame;
  const long long frame_floats = (long long)h * wd * C;

  for (long long t = blockIdx.x >> 1; t < ntiles; t += gridDim.x >> 1) {
    const long long frame = t / tiles_per_frame;
    const int rem = (int)(t - frame * tiles_per_frame);
    const int ty0 = (rem / tiles_x) * TH, tx0 = (rem % tiles_x) * TW;
    const float* xf = x + frame * frame_floats;

    float acc[PX][8];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += CK) {
      __syncthreads();  // the weights are in; the previous chunk's halo is read
      for (int i = threadIdx.x; i < HR * HC; i += THREADS) {
        const int r = i / HC, j = i - r * HC;
        const int iy = ty0 - PAD + r, ix = tx0 - PAD + j;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd)
          v = __ldg(reinterpret_cast<const float4*>(xf + ((long long)iy * wd + ix) * C + c0));
        halo[0 * HR * HC + i] = v.x;
        halo[1 * HR * HC + i] = v.y;
        halo[2 * HR * HC + i] = v.z;
        halo[3 * HR * HC + i] = v.w;
      }
      __syncthreads();

#pragma unroll 1
      for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const float4* hp =
              reinterpret_cast<const float4*>(halo + (c * HR + py + dy) * HC + px0);
          const float4 a0 = hp[0], a1 = hp[1], a2 = hp[2];
          const float xv[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y,
                                a1.z, a1.w, a2.x, a2.y, a2.z, a2.w};
          const float* wrow = ws + (dy * KS * C + c0 + c) * HALF;
#pragma unroll
          for (int dx = 0; dx < KS; ++dx) {
            const float4* wp = reinterpret_cast<const float4*>(wrow + dx * C * HALF);
            const float4 w0 = wp[g], w1 = wp[4 + g];
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int j = 0; j < PX; ++j)
#pragma unroll
              for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xv[j + dx], wv[k], acc[j][k]);
          }
        }
      }
    }

    const int oy = ty0 + py;
    if (oy < h) {
      float* orow = out + frame * frame_floats + (long long)oy * wd * C;
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int ox = tx0 + px0 + j;
        if (ox < wd) {
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            v[k] = acc[j][k] + bv[k];
            if (relu) v[k] = fmaxf(v[k], 0.f);
          }
          float4* op = reinterpret_cast<float4*>(orow + (long long)ox * C + co);
          op[0] = make_float4(v[0], v[1], v[2], v[3]);
          op[4] = make_float4(v[4], v[5], v[6], v[7]);  // channel co + 16
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: (n, h, w, 64), out: the same shape, weight: (5, 5, 64, 64) HWIO, bias:
// (64,); float32, contiguous, 16-byte aligned. Launches on `stream` without
// synchronising; returns a cudaError_t, 0 on success.
int conv5_forward(const float* x, const float* weight, const float* bias, float* out,
                  long long n, int h, int w, int relu, void* stream) {
  if (n < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long ntiles =
      n * (long long)((h + TH - 1) / TH) * (long long)((w + TW - 1) / TW);
  // two blocks (one per channel half) for each tile walker, one block per SM
  const long long walkers = ntiles < sms / 2 ? ntiles : (sms / 2 > 0 ? sms / 2 : 1);
  const dim3 grid((unsigned)(2 * walkers));
  conv5_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, weight, bias, out, n, h, w, relu);
  return cudaGetLastError();
}

}  // extern "C"
