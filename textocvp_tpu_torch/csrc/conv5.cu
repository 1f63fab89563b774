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

#include <cuda_bf16.h>

#include "hopper.cuh"
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

// ---------------------------------------------------------------------------
// The bfloat16 variant (tpu.compute_dtype "bfloat16"): x and w bf16, the bias
// float32, out bf16. The contract of the TPU kernel in bf16
// (bench_pallas_conv.py:81-84, its weights packed bf16 at :32): bf16 operands,
// float32 accumulation, the float32 bias, the ReLU, one rounding to bf16.
//
// What bounds it: operations. 8.16 TFLOP at N = 9728 is 8.25 ms at the bf16
// dense rate of 989 TFLOP/s; its 10.2 GB of input and output take 3.04 ms.
//
// Design (Hopper: TMA, mbarriers, wgmma, persistent CTAs), an implicit GEMM
// with the roles of conv_int8.cu's swapped:
// * The weights are wgmma's A (M = the 64 output channels, K = input
//   channels) and the input halo is B (N = 256 output positions). A frame's
//   outputs lie in rows of wp = W + 4 "padded positions", the first W of
//   each pixels, so that output position o reads, at tap (dy, dx), halo
//   position o + dy * wp + dx: every tap of 256 consecutive positions is a
//   window of 256 consecutive halo positions. The halo of a 16-channel chunk
//   is staged in a channel-blocked layout [8-channel block][position][16
//   bytes], where 8 consecutive positions of a block are one 8 x 16-byte core
//   matrix of a K-major operand without swizzle: a tap moves B's descriptor
//   start by 16 bytes a position (no copy, no mask), the second 8-channel
//   block is LBO away, the next 8 positions SBO = 128 bytes. The weights come
//   from the wrapper tiled [chunk][tap][8-channel block][64][8]
//   (ops/conv5.py::bf16_weight_tiles): a tap's A is 2 KB, LBO 1024, SBO 128.
// * Why this way round: SAVi's bf16 weights (200 KB) and a halo do not both
//   fit in an SM's 227 KB, so the weights stream; with N = 256 positions a
//   wgmma m64n256k16 reads 2 KB of A and 8 KB of B over 128 clocks of
//   products, about 80 bytes of shared memory a clock against the SM's 128
//   (32 output channels a CTA as N would need 192; 64 positions as M, 128).
// * A tile is 512 padded positions of one frame (9 rows a 64 x 64 frame, the
//   ninth half used), two consumer warpgroups of 256 positions each, both
//   reading each weight chunk from the same stage; a warpgroup whose 256
//   positions all lie past the frame's last row issues no wgmma and stores
//   nothing. A chunk (16 input channels) needs its halo (rows x wp padded
//   positions from the tile's first row - 2: 13 x 68 at 64 x 64, 28,416
//   bytes), two TMA boxes of a 5-D tensor map (8 channels, channel block, x,
//   y, frame), zero-filled outside the frame, and its weights (25 x 16 x 64
//   bf16, 51,200 bytes), one bulk copy. They ride in two rings: 3 halo
//   stages, asked for two chunks ahead (they come from device memory), and
//   2 weight stages, one chunk ahead (L2). One producer thread keeps both
//   full (mbarriers "full", by bytes, and "empty", by the 8 consumer warps);
//   each consumer warpgroup runs a chunk's 25 taps as 25 wgmma, unrolled at
//   compile time into one commit group, and releases the chunk before once
//   this one's products are issued. setmaxnreg gives the consumers 232
//   registers (128 float32 accumulators a thread) and the producer
//   warpgroup 40. Persistent CTAs, one an SM, walk the tiles in the order
//   frame, strip, tile. 220,544 bytes of dynamic shared memory at 64 x 64.
//   (The rings are split, and the epilogue runs in two passes, so that the
//   halo can be asked for a chunk earlier: one ring of two stages of halo
//   and weights together left the products waiting for the halo.)
// * Weight traffic: the 200 KB of weights are read from L2 once a tile. At
//   N = 9728 that is 87,552 tiles x 204,800 bytes = 17.9 GB, about 1.3
//   TB/s over 13.5 ms, inside the L2's rate; the halos add 10 GB (each
//   input position staged about twice).
// * Padded positions cost 4 of 68 products at 64 x 64 and the half-used
//   ninth tile of a frame costs none (its second warpgroup idles while the
//   first runs alone). Frames wider than the rings' room (79 pixels) go in
//   strips, each with its own 2-column borders (make_bf16_plan).
// * The epilogue: wgmma's accumulators are (output channel, position); each
//   warpgroup adds the float32 bias, applies the ReLU, rounds once to bf16
//   and transposes through 16 KB of shared memory of its own by stmatrix
//   .trans, 128 positions a pass ([position][64 channels], the 16-byte
//   chunks of a position XOR-swizzled by its low 3 bits), then stores each
//   valid position's 128 bytes with 16-byte stores; the pad positions are
//   never stored. Offsets into the activations are 64-bit.

namespace {

constexpr int BF_BM = 512;                        // padded positions a tile
constexpr int BF_WG_N = 256;                      // positions a consumer warpgroup
constexpr int BF_CONSUMERS = BF_BM / BF_WG_N;     // 2
constexpr int BF_THREADS = 128 * (BF_CONSUMERS + 1);  // + the producer warpgroup
constexpr int BF_CK = 16;                         // input channels a chunk (wgmma's K)
constexpr int BF_CHUNKS = C / BF_CK;              // 4
constexpr int BF_HALO_STAGES = 3;                // the halo ring, two chunks ahead
constexpr int BF_W_STAGES = 2;                   // the weight ring, one chunk ahead
constexpr int BF_A_TAP = C * BF_CK * 2;           // 2048 bytes of weights a tap
constexpr int BF_W_CHUNK = TAPS * BF_A_TAP;       // 51200 bytes of weights a chunk
constexpr int BF_EPI_N = BF_WG_N / 2;             // positions an epilogue pass
constexpr int BF_EPI = BF_EPI_N * C * 2;          // 16384 bytes a warpgroup's epilogue
constexpr int BF_SMEM_MAX = 232448 - 1024;        // an SM's, less the static part, with room
constexpr int BF_BOX_MAX = 256;                   // a TMA box's largest extent

struct Bf16Plan {
  int n, h, w, relu;
  int ws;            // pixels a strip
  int strips;        // strips a frame
  int wp;            // ws + 4: a padded row
  int rows;          // input rows of a halo box
  int plane;         // bytes of one 8-channel block of a stage's halo
  int mtiles;        // tiles a strip
  long long tiles;   // n * strips * mtiles
  int halo_tx;       // bytes the two TMA boxes write into a halo stage
  int halo;          // bytes a halo stage: two planes
  int smem;          // dynamic shared memory
};

// The halo geometry for strips of ws pixels: rows of a box and bytes of a plane.
void bf16_geometry(Bf16Plan* p, int ws) {
  p->ws = ws;
  p->wp = ws + KS - 1;
  // the padded rows BF_BM consecutive positions touch from any start in a row, + the taps'
  p->rows = (BF_BM + p->wp - 2) / p->wp + 1 + KS - 1;
  // + the KS - 1 positions the last row's pad positions reach
  p->plane = ((p->rows * p->wp + KS - 1) * 16 + 127) / 128 * 128;
  p->halo = 2 * p->plane;
  // 128: the alignment
  p->smem = 128 + BF_HALO_STAGES * p->halo + BF_W_STAGES * BF_W_CHUNK + BF_CONSUMERS * BF_EPI;
}

int make_bf16_plan(Bf16Plan* p, long long n, int h, int w) {
  if (n < 1 || h < 1 || w < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  p->n = static_cast<int>(n), p->h = h, p->w = w, p->relu = 0;
  // the widest strip whose stages fit beside the epilogue buffers, strips as even as can be
  for (int cap = w < BF_BOX_MAX - (KS - 1) ? w : BF_BOX_MAX - (KS - 1); cap >= 1; --cap) {
    const int strips = (w + cap - 1) / cap;
    bf16_geometry(p, (w + strips - 1) / strips);
    if (p->smem <= BF_SMEM_MAX && p->rows <= BF_BOX_MAX) {
      p->strips = strips;
      p->mtiles = (h * p->wp + BF_BM - 1) / BF_BM;
      p->tiles = n * p->strips * p->mtiles;
      p->halo_tx = 2 * p->rows * p->wp * 16;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

#define D8F(d, i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A B: A (64 x 16) and B (16 x 256), both K-major from shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : D8F(d, 0), D8F(d, 8), D8F(d, 16), D8F(d, 24), D8F(d, 32), D8F(d, 40), D8F(d, 48),
        D8F(d, 56), D8F(d, 64), D8F(d, 72), D8F(d, 80), D8F(d, 88), D8F(d, 96), D8F(d, 104),
        D8F(d, 112), D8F(d, 120)
      : "l"(a), "l"(b), "r"(1));
}

#undef D8F

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bar.sync on barrier `id` among `count` threads (a warpgroup's 128).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

struct Bf16Tile {
  int frame, strip, mt;
};

__device__ __forceinline__ Bf16Tile bf16_decode(long long tile, const Bf16Plan& p) {
  Bf16Tile t;
  t.mt = static_cast<int>(tile % p.mtiles);
  tile /= p.mtiles;
  t.strip = static_cast<int>(tile % p.strips);
  t.frame = static_cast<int>(tile / p.strips);
  return t;
}

// The C fragment of a wgmma m64n256: this lane holds, for each 8-column
// chunk j, rows r0 = 16 * warp + lane / 4 and r0 + 8 (output channels) at
// columns 8j + 2 (lane % 4) and + 1 (positions), as d[4j] (r0), d[4j + 1]
// (r0), d[4j + 2] (r0 + 8), d[4j + 3].
__global__ void __launch_bounds__(BF_THREADS, 1)
conv5_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                  const Bf16Plan p) {
  extern __shared__ uint8_t bf_raw[];
  __shared__ __align__(8) uint64_t full_h[BF_HALO_STAGES], empty_h[BF_HALO_STAGES],
      full_w[BF_W_STAGES], empty_w[BF_W_STAGES];
  uint8_t* halo = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bf_raw) + 127) & ~static_cast<uintptr_t>(127));
  uint8_t* wring = halo + BF_HALO_STAGES * p.halo;
  uint8_t* epi = wring + BF_W_STAGES * BF_W_CHUNK;  // the warpgroups' epilogue buffers

  if (threadIdx.x == 0) {
    for (int s = 0; s < BF_HALO_STAGES; ++s) {
      hopper::mbar_init(&full_h[s], 1);
      hopper::mbar_init(&empty_h[s], 4 * BF_CONSUMERS);  // one arrival a consumer warp
    }
    for (int s = 0; s < BF_W_STAGES; ++s) {
      hopper::mbar_init(&full_w[s], 1);
      hopper::mbar_init(&empty_w[s], 4 * BF_CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * BF_CONSUMERS) {  // the producer warpgroup: one thread issues
    hopper::regs_dec<40>();
    if (threadIdx.x == 128 * BF_CONSUMERS) {
      int it = 0;
      for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Bf16Tile tl = bf16_decode(tile, p);
        const int y0 = tl.mt * BF_BM / p.wp;
        for (int c = 0; c < BF_CHUNKS; ++c, ++it) {
          // the halo first: it comes from device memory and is asked for two
          // chunks ahead; the weights, from L2, one chunk ahead
          const int hs = it % BF_HALO_STAGES, ws = it % BF_W_STAGES;
          if (it >= BF_HALO_STAGES)
            hopper::mbar_wait(&empty_h[hs], (it / BF_HALO_STAGES - 1) & 1);
          uint8_t* st = halo + hs * p.halo;
          hopper::mbar_expect_tx(&full_h[hs], p.halo_tx);
          for (int q = 0; q < 2; ++q)
            hopper::tma_load_5d(st + q * p.plane, &xmap, &full_h[hs], 0, 2 * c + q,
                                tl.strip * p.ws - PAD, y0 - PAD, tl.frame);
          if (it >= BF_W_STAGES) hopper::mbar_wait(&empty_w[ws], (it / BF_W_STAGES - 1) & 1);
          hopper::mbar_expect_tx(&full_w[ws], BF_W_CHUNK);
          hopper::bulk_load(wring + ws * BF_W_CHUNK,
                            w + static_cast<long long>(c) * (BF_W_CHUNK / 2), BF_W_CHUNK,
                            &full_w[ws]);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: positions 256 wg .. 256 wg + 255 of each tile
  hopper::regs_inc<232>();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const float bias0 = bias[16 * warp + g], bias1 = bias[16 * warp + g + 8];
  const uint32_t halo_addr = hopper::smem_u32(halo), w_addr = hopper::smem_u32(wring);
  uint8_t* my_epi = epi + wg * BF_EPI;
  const uint32_t epi_addr = hopper::smem_u32(my_epi);
  const int frame_positions = p.h * p.wp;
  using hopper::gmma_desc;
  using hopper::kLayoutInterleave;

  float acc[128];
  int it = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Bf16Tile tl = bf16_decode(tile, p);
    const int o0 = tl.mt * BF_BM + BF_WG_N * wg;  // this group's first position
    const int y0 = tl.mt * BF_BM / p.wp;
    const int base = o0 - y0 * p.wp;              // its halo position at tap (0, 0)
    if (o0 >= frame_positions) {  // no position of this group lies in the frame
      // it passes the tile's stages on without a product: a wgmma under a
      // branch that other warpgroups skip made ptxas serialise every wgmma (C7518)
      for (int c = 0; c < BF_CHUNKS; ++c, ++it) {
        const int hs = it % BF_HALO_STAGES, ws = it % BF_W_STAGES;
        hopper::mbar_wait(&full_h[hs], (it / BF_HALO_STAGES) & 1);
        hopper::mbar_wait(&full_w[ws], (it / BF_W_STAGES) & 1);
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_arrive(&empty_h[hs]);
          hopper::mbar_arrive(&empty_w[ws]);
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    for (int c = 0; c < BF_CHUNKS; ++c, ++it) {
      const int hs = it % BF_HALO_STAGES, ws = it % BF_W_STAGES;
      hopper::mbar_wait(&full_h[hs], (it / BF_HALO_STAGES) & 1);
      hopper::mbar_wait(&full_w[ws], (it / BF_W_STAGES) & 1);
      const uint32_t b_st = halo_addr + hs * p.halo;
      const uint32_t a_st = w_addr + ws * BF_W_CHUNK;
      const uint64_t b0 = gmma_desc(b_st + 16 * base, p.plane, 128, kLayoutInterleave);
      const uint64_t a0 = gmma_desc(a_st, 1024, 128, kLayoutInterleave);
      hopper::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        const int dy = tap / KS, dx = tap % KS;
        // descriptors count 16-byte units in their low bits: a shift is an add
        wgmma_m64n256k16(acc, a0 + tap * (BF_A_TAP / 16), b0 + (dy * p.wp + dx));
      }
      hopper::wgmma_commit();
      if (c > 0) {  // the chunk before is done: its stages go back to the producer
        hopper::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_arrive(&empty_h[(it - 1) % BF_HALO_STAGES]);
          hopper::mbar_arrive(&empty_w[(it - 1) % BF_W_STAGES]);
        }
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive(&empty_h[(it - 1) % BF_HALO_STAGES]);
      hopper::mbar_arrive(&empty_w[(it - 1) % BF_W_STAGES]);
    }

    // bias, ReLU, one rounding, in two passes of 128 positions; stmatrix
    // .trans puts each 8 x 8 block of (channel, position) as 8 rows of
    // positions, 16 bytes of channels each; matrix m of an x4 is (position
    // block j + m / 2, channel half m % 2), its row r addressed by lane 8m + r
    const int m = lane >> 3, r = lane & 7;
    const uint32_t row_addr = epi_addr + (8 * (m >> 1) + r) * 128 +
                              (((2 * warp + (m & 1)) ^ r) << 4);
    const int t = threadIdx.x & 127;
    const long long frame_pixels = static_cast<long long>(tl.frame) * p.h * p.w;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (half) named_barrier(1 + wg, 128);  // the first pass's stores have read the buffer
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const float* d = acc + 4 * (16 * half + j);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = d[e] + ((e & 2) ? bias1 : bias0);
          if (p.relu) v[e] = fmaxf(v[e], 0.f);
        }
        asm volatile(
            "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
                row_addr + j * 8 * 128),
            "r"(pack_bf16(v[0], v[1])), "r"(pack_bf16(v[2], v[3])), "r"(pack_bf16(v[4], v[5])),
            "r"(pack_bf16(v[6], v[7]))
            : "memory");
      }
      named_barrier(1 + wg, 128);
#pragma unroll 4
      for (int i = 0; i < BF_EPI_N * 8 / 128; ++i) {
        const int idx = i * 128 + t, pos = idx >> 3, ch = idx & 7;
        const int o = o0 + BF_EPI_N * half + pos, y = o / p.wp, xs = o - y * p.wp;
        const int x = tl.strip * p.ws + xs;
        if (y < p.h && xs < p.ws && x < p.w) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(my_epi + pos * 128 + ((ch ^ (pos & 7)) << 4));
          *reinterpret_cast<uint4*>(out + (frame_pixels + static_cast<long long>(y) * p.w + x) * C +
                                    8 * ch) = v;
        }
      }
    }
    named_barrier(1 + wg, 128);  // the buffer is free for the next tile's epilogue
  }
}

// The 5-D tensor map (8 channels, 8-channel block, x, y, frame) of the bf16
// NHWC input whose boxes are one channel block of `rows` x `wp` pixels.
cudaError_t bf16_input_map(CUtensorMap* map, const void* x, const Bf16Plan& p) {
  const uint64_t dims[5] = {8, static_cast<uint64_t>(C / 8), static_cast<uint64_t>(p.w),
                            static_cast<uint64_t>(p.h), static_cast<uint64_t>(p.n)};
  const uint64_t strides[4] = {16, static_cast<uint64_t>(C) * 2,
                               static_cast<uint64_t>(p.w) * C * 2,
                               static_cast<uint64_t>(p.h) * p.w * C * 2};
  const uint32_t box[5] = {8, 1, static_cast<uint32_t>(p.wp), static_cast<uint32_t>(p.rows), 1};
  return hopper::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, x, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
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

// The bf16 variant's halo geometry at this frame size (make_bf16_plan):
// strip width, strips, padded row, box rows, plane bytes, dynamic shared
// memory. Returns a cudaError_t: cudaErrorInvalidValue for a shape it does
// not take.
int conv5_bf16_plan(int h, int w, int* ws, int* strips, int* wp, int* rows, int* plane,
                    int* smem) {
  Bf16Plan p;
  const int err = make_bf16_plan(&p, 1, h, w);
  if (err == cudaSuccess)
    *ws = p.ws, *strips = p.strips, *wp = p.wp, *rows = p.rows, *plane = p.plane, *smem = p.smem;
  return err;
}

// The bf16 variant: x, out (n, h, w, 64) bf16, weight the (5, 5, 64, 64) HWIO
// bf16 weights tiled [chunk of 16 input channels][tap][8-channel block][64
// output channels][8] (ops/conv5.py::bf16_weight_tiles), bias (64,) float32;
// contiguous, 16-byte aligned. Launches on `stream` without synchronising;
// returns a cudaError_t, 0 on success.
int conv5_bf16_forward(const void* x, const void* weight, const float* bias, void* out,
                       long long n, int h, int w, int relu, void* stream) {
  Bf16Plan p;
  cudaError_t err = static_cast<cudaError_t>(make_bf16_plan(&p, n, h, w));
  if (err != cudaSuccess) return err;
  p.relu = relu;
  CUtensorMap xmap;
  err = bf16_input_map(&xmap, x, p);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv5_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (err != cudaSuccess) return err;
  const long long grid = p.tiles < sms ? p.tiles : sms;  // persistent: one CTA an SM
  conv5_bf16_kernel<<<static_cast<unsigned>(grid), BF_THREADS, p.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const __nv_bfloat16*>(weight), bias, static_cast<__nv_bfloat16*>(out),
      p);
  return cudaGetLastError();
}

}  // extern "C"
