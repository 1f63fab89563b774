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
// x_q is (N, H, W, Cin) int8, w_q (k*k, Cout, Cin) int8 (the wrapper turns the
// JAX package's HWIO into this K-major layout), a_scale one float32 on the
// device, w_scale and bias (Cout,) float32, out (N, H, W, Cout) float32.
//
// What bounds it on an H100 (the SXM part's published peaks at 700 W): at
// SAVi's 05 shape (N = 9728 maps of 64 x 64, 64 -> 64, k = 5) it does 8.2
// TOP against 2.6 GB of int8 input and 10.2 GB of float32 output, so
// operations (1,979 TOP/s of int8 tensor cores) and bytes (3.35 TB/s) bound
// it about equally, near 4 ms (27.04 ms measured on an NVIDIA H100 80GB
// HBM3 at 700.00 W; PERF.md). The design is the simple one, right first: an
// implicit GEMM (M = pixels, N = Cout, K = k*k * Cin) on
// mma.sync.m16n8k32.s8.s8.s32; a CTA computes 128 pixels x 64
// channels with 4 warps of 64 x 32, walks K in steps of one tap and 64 input
// channels, and double-buffers the A (pixels, zero-filled at the frame's
// border by cp.async's src-size 0) and B (weights) tiles in shared memory with
// cp.async. Rows are padded to 80 bytes so the fragment loads hit 32 distinct
// banks. wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // pixels a CTA
constexpr int BN = 64;        // output channels a CTA
constexpr int BK = 64;        // input channels a step (one tap)
constexpr int THREADS = 128;  // 4 warps, 2 x 2, each 64 pixels x 32 channels
constexpr int LDS = BK + 16;  // bytes a shared-memory row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ a_scale, const float* __restrict__ w_scale,
                 const float* __restrict__ bias, float* __restrict__ out, long long m_total,
                 int h, int wd, int cin, int cout, int ks, int relu) {
  __shared__ __align__(16) int8_t sa[2][BM * LDS];
  __shared__ __align__(16) int8_t sb[2][BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group
  const int wm = warp >> 1, wn = warp & 1;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int pad = ks / 2;
  const int chunks = cin / BK;
  const int steps = ks * ks * chunks;

  // this thread's four A rows (pixels) and two B rows (output channels),
  // 16 bytes each, at byte col16 of the step's 64 input channels
  const int col16 = (tid & 3) * 16;
  int ay[4], ax[4];
  bool arow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + (tid >> 2) + 32 * i;
    arow[i] = m < m_total;
    const long long rem = m % (static_cast<long long>(h) * wd);
    ay[i] = static_cast<int>(rem / wd);
    ax[i] = static_cast<int>(rem % wd);
  }

  auto load_stage = [&](int buf, int step) {
    const int tap = step / chunks;
    const int c0 = (step - tap * chunks) * BK + col16;
    const int dy = tap / ks - pad, dx = tap % ks - pad;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 2) + 32 * i;
      const int yy = ay[i] + dy, xx = ax[i] + dx;
      const bool valid = arow[i] && yy >= 0 && yy < h && xx >= 0 && xx < wd;
      const int8_t* src = x;
      if (valid) src = x + (m0 + r + static_cast<long long>(dy) * wd + dx) * cin + c0;
      cp_async16(&sa[buf][r * LDS + col16], src, valid);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = (tid >> 2) + 32 * j;
      const int8_t* src = w + (static_cast<long long>(tap) * cout + n0 + r) * cin + c0;
      cp_async16(&sb[buf][r * LDS + col16], src, true);
    }
    cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  load_stage(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      load_stage(buf ^ 1, step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* pa = sa[buf];
    const int8_t* pb = sb[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm * 64 + mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const unsigned*>(pa + row * LDS + kk + t * 4);
        af[mt][1] = *reinterpret_cast<const unsigned*>(pa + (row + 8) * LDS + kk + t * 4);
        af[mt][2] = *reinterpret_cast<const unsigned*>(pa + row * LDS + kk + 16 + t * 4);
        af[mt][3] = *reinterpret_cast<const unsigned*>(pa + (row + 8) * LDS + kk + 16 + t * 4);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + g;
        bf[nt][0] = *reinterpret_cast<const unsigned*>(pb + col * LDS + kk + t * 4);
        bf[nt][1] = *reinterpret_cast<const unsigned*>(pb + col * LDS + kk + 16 + t * 4);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  // epilogue: acc (rows g and g + 8, columns 2t and 2t + 1 of each 16 x 8 tile)
  const float as = *a_scale;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + t * 2;
    const float s0 = __fmul_rn(as, w_scale[col]), s1 = __fmul_rn(as, w_scale[col + 1]);
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 64 + mt * 16 + g + half * 8;
        if (m >= m_total) continue;
        float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][half * 2]), s0), b0);
        float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + 1]), s1), b1);
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        *reinterpret_cast<float2*>(out + m * cout + col) = make_float2(v0, v1);
      }
    }
  }
}

}  // namespace

extern "C" {

// The kernel's tile: Cin a multiple of ci_tile, Cout of co_tile.
int conv_int8_ci_tile() { return BK; }
int conv_int8_co_tile() { return BN; }

// x_q (n, h, w, cin) int8; w_q (ks * ks, cout, cin) int8; a_scale one float32;
// w_scale, bias (cout,) float32; out (n, h, w, cout) float32. Pointers 16-byte
// aligned. Returns the launch's cudaError_t.
int conv_int8_forward(const void* x, const void* w, const void* a_scale, const void* w_scale,
                      const void* bias, void* out, long long n, int h, int wd, int cin, int cout,
                      int ks, int relu, void* stream) {
  const long long m_total = n * h * wd;
  const long long blocks = (m_total + BM - 1) / BM;
  if (cin % BK || cout % BN || (ks != 3 && ks != 5) || blocks < 1 || blocks > 0x7fffffffLL ||
      cout / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), cout / BN);
  conv_int8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<float*>(out), m_total, h, wd, cin, cout, ks,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
