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
// per output pixel: at the eval shape (N = 9728 maps of 64 x 64) 8.16 TFLOP
// on 20.4 GB of input and output (6.1 ms at 3.35 TB/s). The port runs
// float32 with TF32 off, so the products run as 3xTF32 on the tensor cores
// (tf32x3.cuh): float32 accuracy at 3 x 8.16 TFLOP / 495 TFLOP/s = 49.5 ms,
// against 121.8 ms for FFMA on the CUDA cores.
//
// Design: an implicit GEMM (M = output pixels, N = 64 output channels,
// K = 25 taps x 64 input channels) with the weights resident in shared
// memory. All of them (400 KB) do not fit in an SM's 227 KB, and reloading
// them for every output tile would read some 60 TB out of L2 at the eval
// shape. So each block owns one half of the output channels (32 of them,
// 200 KB of weights), loads that half once, and walks a strided sequence of
// output tiles: one block per SM, even blocks take channels 0..31 and odd
// blocks 32..63, the two halves of a tile side by side so its input is read
// from HBM about once. A tile is 16 rows by 64 columns of one frame. For each
// chunk of 4 input channels the block stages the tile's input halo (20 x 68
// pixels, one plane per channel, planes 1384 floats apart, 8 mod 32 banks)
// in shared memory; the zero-padded border and the ragged edge of the frame
// are zeros written by the load, so the inner loop masks nothing. The next
// chunk's halo is fetched into registers while this one computes (the
// weights leave no room for a second shared buffer). Warp w owns tile rows
// 2w and 2w + 1: 8 A fragments of 16 consecutive pixels of one row, times 4
// B fragments of 8 output channels, 128 float32 accumulators a lane. A k8
// step takes two taps times the chunk's 4 channels (columns t and t + 4 of a
// fragment are channel t at taps 2s and 2s + 1): 12 steps for taps 0..23
// and one m16n8k4 step for tap 24. The weights are stored in fragment order,
// so a lane reads its (b0, b1) of one step as one 8-byte load; each operand
// is split into its TF32 parts in registers as it is loaded (three
// instructions, tf32x3.cuh), and each product is three mma.sync. Offsets
// into the activations are 64-bit: at the eval shape one activation holds
// 2.55e9 floats, past int32. The grid is the SM count on x, whatever N is.

#include "tf32x3.cuh"

namespace {

using tf32x3::Frag;

constexpr int C = 64;            // input and output channels
constexpr int KS = 5;            // kernel size
constexpr int PAD = KS / 2;
constexpr int TAPS = KS * KS;
constexpr int HALF = 32;         // output channels per block
constexpr int NT = HALF / 8;     // B fragments (n tiles) per k step
constexpr int TH = 16;           // tile rows
constexpr int TW = 64;           // tile columns
constexpr int HR = TH + KS - 1;  // 20 halo rows
constexpr int HC = TW + KS - 1;  // 68 halo columns
constexpr int PLANE = 1384;      // floats per staged channel plane: >= HR * HC, 8 mod 32
constexpr int CK = 4;            // input channels per staged chunk
constexpr int CHUNKS = C / CK;
constexpr int PAIRS = TAPS / 2;  // k8 steps of two taps; tap 24 is a k4 step
constexpr int THREADS = 256;     // 8 warps, 2 tile rows each
constexpr int MT = 2 * TW / 16;  // A fragments (m tiles) per warp
constexpr int FETCH = (HR * HC + THREADS - 1) / THREADS;  // float4 per thread per chunk
constexpr int W_PAIRS = PAIRS * NT * 64;                  // 3072 floats of k8 steps a chunk
constexpr int W_CHUNK = TAPS * CK * HALF;                 // 3200 floats a chunk
constexpr int W_FLOATS = CHUNKS * W_CHUNK;                // 51200
constexpr int SMEM_BYTES = (W_FLOATS + CK * PLANE) * (int)sizeof(float);  // 226944

static_assert(PLANE >= HR * HC && PLANE % 32 == 8, "conflict-free A fragment loads");
static_assert(THREADS / 32 * 2 == TH, "a warp owns two tile rows");
static_assert(TAPS == 2 * PAIRS + 1, "one k4 step after the pairs");
static_assert(W_PAIRS + NT * 32 == W_CHUNK, "the k4 step stores one float a lane");

// Tap q = (dy, dx) as an offset in a halo plane.
__device__ __forceinline__ int tap_offset(int q) { return (q / KS) * HC + q % KS; }

// Weights in fragment order, per chunk c, with lane = 4g + t, the lane's
// input channel 4c + t and output channel 8j + g of the block's half: for
// k8 step s and n tile j, 64 floats, the lane holding (w[2s], w[2s + 1]);
// then tap 24: for n tile j, 32 floats, the lane holding w[24].
__device__ __forceinline__ void load_weights(const float* __restrict__ w, int half, float* ws) {
  for (int i = threadIdx.x; i < W_FLOATS; i += THREADS) {
    const int c = i / W_CHUNK, r = i - c * W_CHUNK;
    int tap, j, lane;
    if (r < W_PAIRS) {
      tap = 2 * (r >> 8) + (r & 1);
      j = (r >> 6) & (NT - 1);
      lane = (r >> 1) & 31;
    } else {
      const int r2 = r - W_PAIRS;
      tap = TAPS - 1;
      j = r2 >> 5;
      lane = r2 & 31;
    }
    const int cin = CK * c + (lane & 3), cout = half * HALF + 8 * j + (lane >> 2);
    ws[i] = __ldg(w + (tap * C + cin) * C + cout);
  }
}

struct Tile {
  const float* xf;  // the frame's first pixel
  long long frame;
  int ty0, tx0;
};

__device__ __forceinline__ Tile tile_at(const float* x, long long t, long long tiles_per_frame,
                                        int tiles_x, long long frame_floats) {
  Tile tl;
  tl.frame = t / tiles_per_frame;
  const int rem = (int)(t - tl.frame * tiles_per_frame);
  tl.ty0 = (rem / tiles_x) * TH;
  tl.tx0 = (rem % tiles_x) * TW;
  tl.xf = x + tl.frame * frame_floats;
  return tl;
}

// The halo of input channels c0..c0 + 3 of a tile, one float4 a pixel, into
// registers; zeros outside the frame.
__device__ __forceinline__ void fetch(float4 (&pre)[FETCH], const Tile& tl, int c0, int h,
                                      int wd) {
#pragma unroll
  for (int it = 0; it < FETCH; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / HC, j = i - r * HC;
    const int iy = tl.ty0 - PAD + r, ix = tl.tx0 - PAD + j;
    pre[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < HR * HC && iy >= 0 && iy < h && ix >= 0 && ix < wd)
      pre[it] = __ldg(reinterpret_cast<const float4*>(tl.xf + ((long long)iy * wd + ix) * C + c0));
  }
}

__device__ __forceinline__ void put(const float4 (&pre)[FETCH], float* halo) {
#pragma unroll
  for (int it = 0; it < FETCH; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (i < HR * HC) {
      halo[0 * PLANE + i] = pre[it].x;
      halo[1 * PLANE + i] = pre[it].y;
      halo[2 * PLANE + i] = pre[it].z;
      halo[3 * PLANE + i] = pre[it].w;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
conv5_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out,
             long long n, int h, int wd, int relu) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // this block's half, fragment order
  float* halo = ws + W_FLOATS;                   // (CK, PLANE): the chunk's halo

  const int half = blockIdx.x & 1;
  load_weights(w, half, ws);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float bv[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + half * HALF + 8 * j + 2 * t));
    bv[j][0] = b2.x;
    bv[j][1] = b2.y;
  }
  // this lane's A elements: channel t, halo row 2 * warp + (m tile's row) +
  // dy, column 16 * (m tile's column block) + g (+ 8) + dx
  const float* hl = halo + t * PLANE + 2 * warp * HC + g;

  const int tiles_x = (wd + TW - 1) / TW;
  const long long tiles_per_frame = (long long)((h + TH - 1) / TH) * tiles_x;
  const long long ntiles = n * tiles_per_frame;
  const long long frame_floats = (long long)h * wd * C;
  const long long stride = gridDim.x >> 1;

  long long tile = blockIdx.x >> 1;
  if (tile >= ntiles) return;
  Tile tl = tile_at(x, tile, tiles_per_frame, tiles_x, frame_floats);
  float4 pre[FETCH];
  fetch(pre, tl, 0, h, wd);

  for (; tile < ntiles; tile += stride) {
    const Tile cur = tl;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll 1
    for (int c = 0; c < CHUNKS; ++c) {
      __syncthreads();  // the weights are in; the previous chunk's halo is read
      put(pre, halo);
      __syncthreads();
      if (c + 1 < CHUNKS) {
        fetch(pre, cur, CK * (c + 1), h, wd);
      } else if (tile + stride < ntiles) {
        tl = tile_at(x, tile + stride, tiles_per_frame, tiles_x, frame_floats);
        fetch(pre, tl, 0, h, wd);
      }

      const float* wc = ws + c * W_CHUNK;
#pragma unroll 1
      for (int s = 0; s < PAIRS; ++s) {
        const int off0 = tap_offset(2 * s), off1 = tap_offset(2 * s + 1);
        Frag<2> bf[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 b2 = *reinterpret_cast<const float2*>(wc + (s * NT + j) * 64 + 2 * lane);
          const float b[2] = {b2.x, b2.y};
          bf[j] = tf32x3::split(b);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* p = hl + (mt / 4) * HC + 16 * (mt % 4);
          const float a[4] = {p[off0], p[off0 + 8], p[off1], p[off1 + 8]};
          const Frag<4> af = tf32x3::split(a);
#pragma unroll
          for (int j = 0; j < NT; ++j) tf32x3::mma3_k8(acc[mt][j], af, bf[j]);
        }
      }
      {  // tap 24 = (4, 4): a k4 step, columns t only
        const int off = tap_offset(TAPS - 1);
        Frag<1> bf[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float b[1] = {wc[W_PAIRS + j * 32 + lane]};
          bf[j] = tf32x3::split(b);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* p = hl + (mt / 4) * HC + 16 * (mt % 4);
          const float a[2] = {p[off], p[off + 8]};
          const Frag<2> af = tf32x3::split(a);
#pragma unroll
          for (int j = 0; j < NT; ++j) tf32x3::mma3_k4(acc[mt][j], af, bf[j]);
        }
      }
    }

    // epilogue: rows g and g + 8 of an m tile are columns 16 * (mt % 4) + g (+ 8)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int oy = cur.ty0 + 2 * warp + mt / 4;
      if (oy >= h) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ox = cur.tx0 + 16 * (mt % 4) + g + 8 * e;
        if (ox >= wd) continue;
        float* op = out + cur.frame * frame_floats + ((long long)oy * wd + ox) * C + half * HALF +
                    2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float v0 = acc[mt][j][2 * e] + bv[j][0], v1 = acc[mt][j][2 * e + 1] + bv[j][1];
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<float2*>(op + 8 * j) = make_float2(v0, v1);
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
