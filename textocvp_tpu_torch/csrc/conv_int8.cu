// int8 k x k stride-1 "same" convolution, NHWC, with the dequantizing
// epilogue of the JAX package's opt-in int8 decode (tpu.decode_quant).
//
// Replaces no TPU kernel: the JAX package computes this conv with XLA
// (textocvp_tpu/nn/decoders.py::ConvDecoder._quantize_conv, an int8 x int8 ->
// int32 conv_general_dilated, then y * (a_scale * w_scale) + bias in float32).
// PyTorch has no int8 convolution on CUDA, and an im2col through an int8 GEMM
// would write k*k copies of the activations (25x at SAVi's tail), so the port
// computes it here. It runs SAVi's three 5x5 64->64 tail convs and the four
// BatchNorm-folded 3x3 convs of ExtendedDINOSAUR's CNN head when the decode is
// quantized.
//
// What it computes, per output pixel p and channel co:
//   acc = sum over taps (dy, dx) and ci of x_q[p + (dy - pad, dx - pad), ci] *
//         w_q[co][dy][dx][ci]  (int32; a pixel outside the frame reads 0)
//   y   = float(acc) * (a_scale * w_scale[co]) + bias[co]   (float32, rounded
//         after the product and after the sum: no fused multiply-add, so the
//         result equals the plain PyTorch version bit for bit)
//   y   = max(y, 0) if relu.
// x_q is (N, H, W, Cin) int8, a_scale one float32 on the device, w_scale and
// bias (Cout,) float32, out (N, H, W, Cout) float32. The weights come tiled by
// the wrapper (ops/conv_int8.py) as [Cout / BN][Cin / CK][k*k][CK / 16][BN]
// [16] int8 for the plan's BN and CK (conv_int8_plan).
//
// What bounds it on an H100 (the SXM part's published peaks at 700 W): at
// SAVi's 05 shape (N = 9728 maps of 64 x 64, 64 -> 64, k = 5) it does 8.2
// TOP against 2.6 GB of int8 input and 10.2 GB of float32 output, so
// operations (1,979 TOP/s of int8 tensor cores) and bytes (3.35 TB/s) bound
// it about equally, near 4 ms.
//
// Design (Hopper: TMA, mbarriers, wgmma, persistent CTAs):
// * The conv is an implicit GEMM over "padded positions": a frame's outputs
//   are laid out in rows of wp = W + k - 1 positions, of which the first W
//   are pixels (a frame wider than 257 - k goes in strips of 257 - k
//   columns, each with its own halo, since a TMA box is at most 256 wide).
//   Output position o then reads, at tap (dy, dx), halo position
//   o + dy * wp + dx of the zero-padded input, so each of the k*k taps of 64
//   consecutive positions is 64 consecutive halo positions: one shifted
//   window. Positions past W in a row are computed and never stored (k - 1
//   of every wp).
// * A tile is 256 consecutive positions of one frame (4 wgmma M-blocks) x BN
//   output channels (64, or 128 where Cout allows and the stages fit). Its
//   input halo, the padded rows that the 256 positions and their taps reach,
//   is staged ONCE a chunk of CK input channels, in a channel-blocked layout
//   [CK / 16][position][16 bytes]: 8 consecutive positions of a 16-channel
//   block are one 8 x 16-byte core matrix of a K-major wgmma operand without
//   swizzle, and the tap's shift moves the descriptor's start by 16 bytes a
//   position. One TMA box a 16-channel block loads it from a 5-D tensor map
//   (16 bytes, channel block, x, y, frame); the pad columns and rows outside
//   the frame are TMA's zero fill.
// * The weights: where all of them fit beside the ring (one output tile, as
//   SAVi's 100 KB of 5 x 5 x 64 x 64) they are loaded once a CTA by one bulk
//   copy and stay; else each chunk's weights (k*k x CK x BN) ride in the
//   ring beside its halo, one bulk copy each. Both consumer warpgroups share
//   each tile, 2 M-blocks each. (Tiles of 128 positions, one a warpgroup, so
//   that one's epilogue runs beside the other's products, took 8.94-9.03 ms
//   at SAVi's N = 9728 against 8.0-8.2 for shared tiles of 256: the taller
//   halo a position, 3.7 input positions staged per output against 2.4,
//   cost more than the overlap gave.)
// * Persistent CTAs, one an SM (up to 227 KB of shared memory), walk the
//   tiles. One producer thread issues the TMA loads into a ring of 2-4
//   stages (mbarriers "full", by bytes, and "empty", by the consumer warps);
//   two consumer warpgroups each run wgmma m64nBNk32 .s8 with int32
//   accumulators over 2 M-blocks (128 positions), both operands from shared
//   memory, a chunk's k*k taps unrolled into one commit group (compile-time
//   k, BN and CK: 8 instantiations), releasing a stage as soon as the next
//   chunk's products are issued. setmaxnreg gives the consumers 232
//   registers and the producer warpgroup 40.
// * The epilogue: a_scale * w_scale and the bias sit in shared memory; lanes
//   swap accumulator pairs so that each holds 4 consecutive channels of one
//   position, and write float32 with 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 256;          // output positions a tile: 4 wgmma M-blocks
constexpr int CONSUMERS = 2;     // warpgroups of wgmma, 2 M-blocks each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int MAX_STAGES = 4;
constexpr int CI_TILE = 64;      // Cin a multiple of this
constexpr int CO_TILE = 64;      // Cout a multiple of this
constexpr int SMEM_MAX = 232448;  // shared memory a block can have on an H100
constexpr int SMEM_RESERVED = 1024;  // the static barriers and the alignment, with room

struct Plan {
  int n, h, w, cin, cout, ks, relu;
  int ws;           // pixels a strip: frames wider than a TMA box allows go in strips
  int strips;       // strips a frame
  int wp;           // ws + ks - 1: a padded row of output positions
  int rows;         // input rows of a halo box
  int plane;        // bytes of one 16-channel plane of a stage's halo
  int ck;           // input channels a stage
  int chunks;       // cin / ck
  int bn;           // output channels a tile
  int ntiles;       // cout / bn
  int mtiles;       // tiles a frame
  long long tiles;  // n * strips * mtiles * ntiles
  int resident;     // all weights loaded once a CTA
  int stages;
  int halo_tx;      // bytes the TMA writes into a stage's halo
  int wchunk;       // bytes of the weights of one (output tile, chunk)
  int stage_bytes;  // a stage: its halo planes, then its weights where not resident
  int smem;         // dynamic shared memory
};

int make_plan(Plan* p, long long n, int h, int w, int cin, int cout, int ks) {
  if ((ks != 3 && ks != 5) || n < 1 || h < 1 || w < 1 || cin < CI_TILE || cin % CI_TILE ||
      cout < CO_TILE || cout % CO_TILE || n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  p->n = static_cast<int>(n), p->h = h, p->w = w, p->cin = cin, p->cout = cout, p->ks = ks;
  p->relu = 0;
  p->ws = w < 256 - (ks - 1) ? w : 256 - (ks - 1);  // a TMA box is at most 256 wide
  p->strips = (w + p->ws - 1) / p->ws;
  p->wp = p->ws + ks - 1;
  // rows a box: the padded rows BM consecutive positions touch, + the taps'
  p->rows = (BM + p->wp - 2) / p->wp + 1 + ks - 1;
  // positions a plane: + the k - 1 that the last row's pad positions reach
  p->plane = ((p->rows * p->wp + ks - 1) * 16 + 127) / 128 * 128;
  p->mtiles = (h * p->wp + BM - 1) / BM;
  const int budget = SMEM_MAX - SMEM_RESERVED - 8 * cout;  // - the epilogue's scales and biases
  // the widest output tile that leaves room for two stages (128 channels do
  // not at k = 5: 200 KB of weights a stage); input chunks of 64 channels
  // where the weights may stay resident, else of 32, the weights streaming
  // in twice as many stages (a quarter to a third off the CNN head's layers
  // 0-2 against chunks of 64; PERF.md §6)
  for (int bn = cout % 128 == 0 ? 128 : 64; bn >= 64; bn /= 2) {
    const int chunk_channels[2] = {cout == bn ? 64 : 32, cout == bn ? 32 : 64};
    for (const int ck : chunk_channels) {
      const int w_all = ks * ks * cin * bn;
      const int halo = ck / 16 * p->plane;
      const int wchunk = ks * ks * ck * bn;
      const int resident = cout == bn && w_all + 2 * halo <= budget;
      const int stage = halo + (resident ? 0 : wchunk);
      int stages = (budget - (resident ? w_all : 0)) / stage;
      if (stages > MAX_STAGES) stages = MAX_STAGES;
      if (stages < 2) continue;
      p->bn = bn;
      p->ntiles = cout / bn;
      p->tiles = n * p->strips * p->mtiles * p->ntiles;
      p->ck = ck;
      p->chunks = cin / ck;
      p->resident = resident;
      p->stages = stages;
      p->halo_tx = ck / 16 * p->rows * p->wp * 16;
      p->wchunk = wchunk;
      p->stage_bytes = stage;
      p->smem = 128 + 8 * cout + (resident ? w_all : 0) + stages * stage;  // 128: the alignment
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

struct Tile {
  int frame, strip, mt, nt;
};

// Tiles in the order frame, strip, 256 positions, output channels: the CTAs
// at work at one time share halos and, where they stream, weights in L2.
__device__ __forceinline__ Tile decode(long long tile, const Plan& p) {
  Tile t;
  t.nt = static_cast<int>(tile % p.ntiles);
  tile /= p.ntiles;
  t.mt = static_cast<int>(tile % p.mtiles);
  tile /= p.mtiles;
  t.strip = static_cast<int>(tile % p.strips);
  t.frame = static_cast<int>(tile / p.strips);
  return t;
}

#define D8I(d, i)                                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// d += A B, int8 x int8 -> int32, A (64 x 32) and B (32 x BN) K-major from
// shared memory.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1;\n"
      : D8I(d, 0), D8I(d, 8), D8I(d, 16), D8I(d, 24)
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1;\n"
      : D8I(d, 0), D8I(d, 8), D8I(d, 16), D8I(d, 24), D8I(d, 32), D8I(d, 40), D8I(d, 48),
        D8I(d, 56)
      : "l"(a), "l"(b));
}

#undef D8I

__device__ __forceinline__ float dequantize(int acc, float scale, float bias, int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? fmaxf(y, 0.0f) : y;
}

// The C fragment of a wgmma m64nN: this lane holds, for each 8-column chunk
// j, rows r0 = 16 * warp + lane / 4 and r0 + 8 at columns 8j + 2 (lane % 4)
// and + 1, as d[4j] (r0), d[4j + 1] (r0), d[4j + 2] (r0 + 8), d[4j + 3].
// BN output channels a tile, KS x KS taps, KQ k32 steps a chunk (CK = 32 KQ):
// compile-time, so that a chunk's KS * KS * KQ * 2 wgmma are one unrolled run
// and the accumulators never move between them.
template <int BN, int KS, int KQ>
__global__ void __launch_bounds__(THREADS, 1)
conv_int8_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ w,
                 const float* __restrict__ a_scale, const float* __restrict__ w_scale,
                 const float* __restrict__ bias, float* __restrict__ out, const Plan p) {
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES], w_full;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 127) & ~static_cast<uintptr_t>(127));
  float* s_scale = reinterpret_cast<float*>(smem);  // a_scale * w_scale, Cout of them
  float* s_bias = s_scale + p.cout;
  uint8_t* w_res = smem + 8 * p.cout;               // the resident weights
  uint8_t* ring = w_res + (p.resident ? KS * KS * p.cin * BN : 0);
  constexpr int planes = 2 * KQ, pad = KS / 2;  // 16-channel planes a chunk

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival a consumer warp
    }
    hopper::mbar_init(&w_full, 1);
    hopper::fence_barrier_init();
  }
  const float as = *a_scale;
  for (int i = threadIdx.x; i < p.cout; i += THREADS) {
    s_scale[i] = __fmul_rn(as, w_scale[i]);
    s_bias[i] = bias[i];
  }
  __syncthreads();

  if (threadIdx.x >= 128 * CONSUMERS) {  // the producer warpgroup: one thread issues
    hopper::regs_dec<40>();
    if (threadIdx.x == 128 * CONSUMERS) {
      if (p.resident) {
        const uint32_t bytes = KS * KS * p.cin * BN;
        hopper::mbar_expect_tx(&w_full, bytes);
        hopper::bulk_load(w_res, w, bytes, &w_full);
      }
      int it = 0;
      for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Tile tl = decode(tile, p);
        const int y0 = tl.mt * BM / p.wp;
        for (int c = 0; c < p.chunks; ++c, ++it) {
          const int s = it % p.stages;
          if (it >= p.stages) hopper::mbar_wait(&empty[s], (it / p.stages - 1) & 1);
          uint8_t* st = ring + s * p.stage_bytes;
          hopper::mbar_expect_tx(&full[s], p.halo_tx + (p.resident ? 0 : p.wchunk));
          for (int q = 0; q < planes; ++q)
            hopper::tma_load_5d(st + q * p.plane, &xmap, &full[s], 0, c * planes + q,
                                tl.strip * p.ws - pad, y0 - pad, tl.frame);
          if (!p.resident)
            hopper::bulk_load(st + planes * p.plane,
                              w + (static_cast<long long>(tl.nt) * p.chunks + c) * p.wchunk,
                              p.wchunk, &full[s]);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: M-blocks 2 wg and 2 wg + 1 of each tile
  hopper::regs_inc<232>();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t ring_addr = hopper::smem_u32(ring), w_addr = hopper::smem_u32(w_res);
  using hopper::gmma_desc;
  using hopper::kLayoutInterleave;
  if (p.resident) hopper::mbar_wait(&w_full, 0);

  int acc[2][BN / 2];
  int it = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile tl = decode(tile, p);
    const int o0 = tl.mt * BM, y0 = o0 / p.wp;
    const int base = o0 - y0 * p.wp + 128 * wg;  // this group's first row at tap (0, 0)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0;

    int prev = -1;
    for (int c = 0; c < p.chunks; ++c, ++it) {
      const int s = it % p.stages;
      hopper::mbar_wait(&full[s], (it / p.stages) & 1);
      const uint32_t a_st = ring_addr + s * p.stage_bytes;
      const uint32_t b_st = p.resident ? w_addr + c * p.wchunk : a_st + planes * p.plane;
      hopper::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < KS * KS; ++tap) {
        const int dy = tap / KS, dx = tap % KS;
        const uint32_t a_tap = a_st + 16 * (base + dy * p.wp + dx);
        const uint32_t b_tap = b_st + tap * planes * BN * 16;
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
          // a k32 step: two 16-channel planes, LBO apart; 8-row core matrices 128 bytes apart
          const uint64_t b = gmma_desc(b_tap + 2 * kq * BN * 16, BN * 16, 128, kLayoutInterleave);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
            wgmma_s8<BN>(acc[mb],
                         gmma_desc(a_tap + 2 * kq * p.plane + 64 * 16 * mb, p.plane, 128,
                                   kLayoutInterleave),
                         b);
        }
      }
      hopper::wgmma_commit();
      if (prev >= 0) {  // the chunk before is done: its stage goes back to the producer
        hopper::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // even lanes take row r0 and odd lanes row r0 + 8, 4 consecutive channels
    // each: a pair swap with the neighbour lane
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int pos = o0 + 128 * wg + 64 * mb + 16 * warp + g + 8 * (t & 1);
      const int y = pos / p.wp, x = tl.strip * p.ws + pos - y * p.wp;
      const bool valid = y < p.h && pos - y * p.wp < p.ws && x < p.w;
      const int col = tl.nt * BN + 4 * (t >> 1);
      float* orow = out + ((static_cast<long long>(tl.frame) * p.h + y) * p.w + x) * p.cout + col;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int* d = &acc[mb][4 * j];
        const int r0 = __shfl_xor_sync(0xffffffffu, (t & 1) ? d[0] : d[2], 1);
        const int r1 = __shfl_xor_sync(0xffffffffu, (t & 1) ? d[1] : d[3], 1);
        if (valid) {
          const int v0 = (t & 1) ? r0 : d[0], v1 = (t & 1) ? r1 : d[1];
          const int v2 = (t & 1) ? d[2] : r0, v3 = (t & 1) ? d[3] : r1;
          const float4 sc = *reinterpret_cast<const float4*>(s_scale + col + 8 * j);
          const float4 bi = *reinterpret_cast<const float4*>(s_bias + col + 8 * j);
          *reinterpret_cast<float4*>(orow + 8 * j) =
              make_float4(dequantize(v0, sc.x, bi.x, p.relu), dequantize(v1, sc.y, bi.y, p.relu),
                          dequantize(v2, sc.z, bi.z, p.relu), dequantize(v3, sc.w, bi.w, p.relu));
        }
      }
    }
  }
}

// The 5-D tensor map (16 bytes, 16-channel block, x, y, frame) of the int8
// NHWC input whose boxes are one channel block of `rows` x `wp` pixels.
cudaError_t input_map(CUtensorMap* map, const void* x, const Plan& p) {
  const uint64_t dims[5] = {16, static_cast<uint64_t>(p.cin / 16), static_cast<uint64_t>(p.w),
                            static_cast<uint64_t>(p.h), static_cast<uint64_t>(p.n)};
  const uint64_t strides[4] = {16, static_cast<uint64_t>(p.cin),
                               static_cast<uint64_t>(p.w) * p.cin,
                               static_cast<uint64_t>(p.h) * p.w * p.cin};
  const uint32_t box[5] = {16, 1, static_cast<uint32_t>(p.wp), static_cast<uint32_t>(p.rows), 1};
  return hopper::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, x, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int BN, int KS, int KQ>
cudaError_t launch(const CUtensorMap& xmap, const void* w, const void* a_scale,
                   const void* w_scale, const void* bias, void* out, const Plan& p,
                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_int8_kernel<BN, KS, KQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const long long grid = p.tiles < sms ? p.tiles : sms;
  conv_int8_kernel<BN, KS, KQ><<<static_cast<unsigned>(grid), THREADS, p.smem, stream>>>(
      xmap, static_cast<const int8_t*>(w), static_cast<const float*>(a_scale),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<float*>(out), p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's tile: Cin a multiple of ci_tile, Cout of co_tile.
int conv_int8_ci_tile() { return CI_TILE; }
int conv_int8_co_tile() { return CO_TILE; }

// The weight tiling the kernel takes at this shape: BN output and CK input
// channels (see the top of this file). Returns a cudaError_t:
// cudaErrorInvalidValue for a shape the kernel does not take.
int conv_int8_plan(long long n, int h, int wd, int cin, int cout, int ks, int* bn, int* ck) {
  Plan p;
  const int err = make_plan(&p, n, h, wd, cin, cout, ks);
  if (err == cudaSuccess) *bn = p.bn, *ck = p.ck;
  return err;
}

// x_q (n, h, w, cin) int8; w_t the weights tiled for conv_int8_plan's BN and
// CK; a_scale one float32; w_scale, bias (cout,) float32; out (n, h, w, cout)
// float32. Pointers 16-byte aligned. Returns the launch's cudaError_t.
int conv_int8_forward(const void* x, const void* w_t, const void* a_scale, const void* w_scale,
                      const void* bias, void* out, long long n, int h, int wd, int cin, int cout,
                      int ks, int relu, void* stream) {
  Plan p;
  cudaError_t err = static_cast<cudaError_t>(make_plan(&p, n, h, wd, cin, cout, ks));
  if (err != cudaSuccess) return err;
  p.relu = relu;
  CUtensorMap xmap;
  err = input_map(&xmap, x, p);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel_launch) {
    return kernel_launch(xmap, w_t, a_scale, w_scale, bias, out, p, s);
  };
  const int key = (p.bn == 128) * 4 + (p.ks == 5) * 2 + (p.ck == 64);
  switch (key) {
    case 0: err = go(launch<64, 3, 1>); break;
    case 1: err = go(launch<64, 3, 2>); break;
    case 2: err = go(launch<64, 5, 1>); break;
    case 3: err = go(launch<64, 5, 2>); break;
    case 4: err = go(launch<128, 3, 1>); break;
    case 5: err = go(launch<128, 3, 2>); break;
    case 6: err = go(launch<128, 5, 1>); break;
    default: err = go(launch<128, 5, 2>); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
