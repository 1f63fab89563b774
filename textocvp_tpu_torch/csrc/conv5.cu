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
// Each product is one mma.sync.m16n8k16.bf16 (no split, unlike 3xTF32).
//
// Design: the float32 kernel's implicit GEMM and its walk (a block per SM,
// even blocks owning output channels 0..31 and odd ones 32..63, tiles of 16
// rows by 64 columns, warp w owning tile rows 2w and 2w + 1: 8 m tiles of 16
// pixels times 4 n tiles of 8 channels, 128 float32 accumulators a lane), at
// bf16: a k16 step is one tap times 16 input channels, 25 x 4 of them a
// tile. The half's weights (100 KB bf16) stay in shared memory in fragment
// order, a lane's B fragments of two n tiles one 16-byte load. The input
// halo of 16 channels (20 x 68 pixels, 32 bytes a pixel) is staged with
// 16-byte cp.async copies (zero-filled outside the frame) into one of two
// buffers while the other is read, so a chunk loads while the one before it
// computes; the A fragments are ldmatrix.x4 loads. The two 16-byte halves of
// a pixel swap places when bit 2 of its halo index is set, which puts the 8
// rows of each ldmatrix phase in 8 distinct bank groups. 189 KB of dynamic
// shared memory.

namespace {

constexpr int BF_PIX = 16;                           // bf16 channels of a pixel in a halo buffer
constexpr int BF_HALO = HR * HC * BF_PIX;            // bf16 elements of a halo buffer
constexpr int BF_CHUNKS = C / BF_PIX;                // 4 chunks of 16 input channels
constexpr int BF_W_STEP = 2 * 32 * 8;                // bf16 a k16 step: 2 n-tile pairs x 32 lanes x 8
constexpr int BF_W = BF_CHUNKS * TAPS * BF_W_STEP;   // 51200 bf16 of a half
constexpr int BF_SMEM_BYTES = (BF_W + 2 * BF_HALO) * 2;  // 189440
constexpr int BF_COPIES = HR * HC * 2;               // 16-byte copies a chunk

static_assert(BF_SMEM_BYTES <= 232448, "fits an SM's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bf_cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// The element offset of 16-byte half `half` of halo pixel `p` in a buffer.
__device__ __forceinline__ int bf_slot(int p, int half) {
  return p * BF_PIX + 8 * (half ^ ((p >> 2) & 1));
}

// Weights in fragment order: for chunk c, tap q, n-tile pair jp and lane
// 4g + t, 8 bf16 (b0, b1 of n tile 2jp, then of 2jp + 1), with b0 = input
// channels 16c + 2t, 2t + 1 and b1 = 16c + 2t + 8, 2t + 9, output channel
// 8j + g of the block's half.
__device__ __forceinline__ void bf_load_weights(const __nv_bfloat16* __restrict__ w, int half,
                                                __nv_bfloat16* ws) {
  for (int i = threadIdx.x; i < BF_W; i += THREADS) {
    const int e = i & 7, lane = (i >> 3) & 31, jp = (i >> 8) & 1, step = i >> 9;
    const int c = step / TAPS, q = step - c * TAPS;
    const int j = 2 * jp + (e >> 2), r = e & 3;
    const int t = lane & 3, g = lane >> 2;
    const int cin = BF_PIX * c + 2 * t + (r & 1) + 8 * (r >> 1);
    const int cout = half * HALF + 8 * j + g;
    ws[i] = w[(q * C + cin) * C + cout];
  }
}

// cp.async the 16 channels of chunk c of a tile's halo into a buffer.
__device__ __forceinline__ void bf_stage(const __nv_bfloat16* __restrict__ x, const Tile& tl,
                                         long long frame_elems, int c, int h, int wd,
                                         __nv_bfloat16* buf) {
  const __nv_bfloat16* xf = x + tl.frame * frame_elems;
  for (int i = threadIdx.x; i < BF_COPIES; i += THREADS) {
    const int p = i >> 1, hf = i & 1;
    const int r = p / HC, col = p - r * HC;
    const int iy = tl.ty0 - PAD + r, ix = tl.tx0 - PAD + col;
    const bool in = iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const __nv_bfloat16* src =
        in ? xf + ((long long)iy * wd + ix) * C + BF_PIX * c + 8 * hf : x;
    bf_cp_async16(smem_addr(buf + bf_slot(p, hf)), src, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 1)
conv5_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                  long long n, int h, int wd, int relu) {
  extern __shared__ uint4 bf_smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(bf_smem);
  __nv_bfloat16* halo = ws + BF_W;  // two buffers of BF_HALO

  const int half = blockIdx.x & 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  const int tiles_x = (wd + TW - 1) / TW;
  const long long tiles_per_frame = (long long)((h + TH - 1) / TH) * tiles_x;
  const long long ntiles = n * tiles_per_frame;
  const long long frame_elems = (long long)h * wd * C;
  const long long stride = gridDim.x >> 1;
  long long tile = blockIdx.x >> 1;
  if (tile >= ntiles) return;

  // the first chunk's copy runs while the weights are loaded
  Tile tl = tile_at(nullptr, tile, tiles_per_frame, tiles_x, 0);  // its frame, rows, columns
  bf_stage(x, tl, frame_elems, 0, h, wd, halo);
  bf_load_weights(w, half, ws);

  float bv[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + half * HALF + 8 * j + 2 * t));
    bv[j][0] = b2.x;
    bv[j][1] = b2.y;
  }
  // this lane's ldmatrix row: pixel (lane & 15) of an m tile, 16-byte half (lane >> 4)
  const int lrow = lane & 15, lhalf = lane >> 4;
  const uint4* wv = reinterpret_cast<const uint4*>(ws);

  int step = 0;  // (tile, chunk) steps so far: the buffer of a step is step & 1
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
    for (int c = 0; c < BF_CHUNKS; ++c, ++step) {
      __nv_bfloat16* nxt = halo + ((step + 1) & 1) * BF_HALO;
      if (c + 1 < BF_CHUNKS) {
        bf_stage(x, cur, frame_elems, c + 1, h, wd, nxt);
      } else if (tile + stride < ntiles) {
        tl = tile_at(nullptr, tile + stride, tiles_per_frame, tiles_x, 0);
        bf_stage(x, tl, frame_elems, 0, h, wd, nxt);
      } else {
        asm volatile("cp.async.commit_group;" ::: "memory");  // keeps the wait below uniform
      }
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      __syncthreads();  // this step's halo (and, at the first, the weights) are in

      const __nv_bfloat16* buf = halo + (step & 1) * BF_HALO;
#pragma unroll 1
      for (int q = 0; q < TAPS; ++q) {
        const int dy = q / KS, dx = q - dy * KS;
        const uint4 bw0 = wv[((c * TAPS + q) * 2 + 0) * 32 + lane];
        const uint4 bw1 = wv[((c * TAPS + q) * 2 + 1) * 32 + lane];
        const uint32_t bfr[NT][2] = {{bw0.x, bw0.y}, {bw0.z, bw0.w}, {bw1.x, bw1.y},
                                     {bw1.z, bw1.w}};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int p = (2 * warp + mt / 4 + dy) * HC + 16 * (mt % 4) + lrow + dx;
          uint32_t a[4];
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                       : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                       : "r"(smem_addr(buf + bf_slot(p, lhalf))));
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][j], a, bfr[j][0], bfr[j][1]);
        }
      }
      __syncthreads();  // this buffer is refilled by the step after next's copy
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
        __nv_bfloat16* op = out + cur.frame * frame_elems + ((long long)oy * wd + ox) * C +
                            half * HALF + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float v0 = acc[mt][j][2 * e] + bv[j][0], v1 = acc[mt][j][2 * e + 1] + bv[j][1];
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(v0, v1);
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

// The bf16 variant: x, out (n, h, w, 64) bf16, weight (5, 5, 64, 64) HWIO
// bf16, bias (64,) float32; contiguous, 16-byte aligned. Launches on `stream`
// without synchronising; returns a cudaError_t, 0 on success.
int conv5_bf16_forward(const void* x, const void* weight, const float* bias, void* out,
                       long long n, int h, int w, int relu, void* stream) {
  if (n < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv5_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BF_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long ntiles =
      n * (long long)((h + TH - 1) / TH) * (long long)((w + TW - 1) / TW);
  const long long walkers = ntiles < sms / 2 ? ntiles : (sms / 2 > 0 ? sms / 2 : 1);
  const dim3 grid((unsigned)(2 * walkers));
  conv5_bf16_kernel<<<grid, THREADS, BF_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(weight), bias,
      static_cast<__nv_bfloat16*>(out), n, h, w, relu);
  return cudaGetLastError();
}

}  // extern "C"
