// Non-causal multi-head attention of the ViT encoder for Hopper (sm_90a),
// float32, forward only: out = softmax(q k^T * scale) v per (frame, head).
//
// Replaces the TPU kernel the JAX package reaches from
// textocvp_tpu/nn/vit.py::_attention (arms "flash" / "flash_tuned": JAX's
// bundled Pallas TPU flash attention). That arm pads the token axis to a
// multiple of 128 for the TPU's lanes and masks the pad tokens with segment
// ids. Here the ragged tail is masked inside the kernel: no pad copies.
//
// What bounds it on an H100: operations. At the CLIPort shape (8 frames x 12
// heads, n = 577 tokens, dh = 64) one call does 4 * 96 * 577^2 * 64 = 8.2
// GFLOP on 57 MB of q, k, v and out: 0.12 ms at 67 TFLOP/s float32 against
// 0.017 ms at 3.35 TB/s. The service runs float32 with TF32 off, so the
// products run on the CUDA cores (FFMA), not the tensor cores.
//
// Design: one block of 256 threads per (frame * head, 64-query tile), 10
// tiles at n = 577. The block keeps its Q tile in shared memory and streams
// K and V in tiles of 64 tokens, with an online softmax (running max and sum
// in float32), so the (n, n) scores never leave the SM. Thread (ty, tx) of a
// 16 x 16 grid owns a 4 x 4 patch: query rows 4ty..4ty+3 against keys
// 4tx..4tx+3 for the scores, and the same rows against output columns
// 4tx..4tx+3 for the accumulator, so a row's rescale factor is in the
// thread's own registers and a row's max and sum reduce over the 16 lanes of
// one half-warp. Q and K are stored transposed (dh-major, row stride 68) and
// the probabilities P transposed too, so every inner-loop read is one float4
// per operand: 2 shared loads for 16 FMAs. Tokens past n read as zeros and
// their scores as -inf. expf, not __expf, keeps the result within 2e-5 of
// the plain version. About 68 KB of dynamic shared memory: 3 blocks per SM.
// Tensor cores (TF32 or bf16 wgmma) are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DH = 64;        // head width the kernel takes
constexpr int TILE = 64;      // queries per block, keys per step
constexpr int THREADS = 256;  // a 16 x 16 grid of 4 x 4 patches
constexpr int LD = TILE + 4;  // row stride of the transposed tiles (floats)
constexpr int SMEM_FLOATS = 3 * DH * LD + TILE * DH;

// Copy rows [row0, row0 + TILE) of a (n, DH) slab into dst[d * LD + row],
// zero past n. A pair of lanes reads 32 contiguous bytes of one row; the two
// halves of a warp write rows 16 banks apart, so the stores do not conflict.
__device__ __forceinline__ void load_transposed(const float* __restrict__ src, int row0,
                                                int n, float* dst) {
#pragma unroll
  for (int it = 0; it < TILE * DH / 4 / THREADS; ++it) {
    const int idx = it * THREADS + threadIdx.x;
    const int half = idx & 1, row = (idx >> 1) & (TILE - 1), d0 = (idx >> 7) * 8 + half * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < n)
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + row) * DH + d0));
    dst[(d0 + 0) * LD + row] = x.x;
    dst[(d0 + 1) * LD + row] = x.y;
    dst[(d0 + 2) * LD + row] = x.z;
    dst[(d0 + 3) * LD + row] = x.w;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int n, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // (DH, LD): q^T of the block's queries
  float* kt = qt + DH * LD;                      // (DH, LD): k^T of one key tile
  float* pt = kt + DH * LD;                      // (TILE, LD): p^T, key-major
  float* vs = pt + TILE * LD;                    // (TILE, DH): v of one key tile

  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * DH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_transposed(q + base, q0, n, qt);

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TILE) {
    load_transposed(k + base, k0, n, kt);
#pragma unroll
    for (int it = 0; it < TILE * DH / 4 / THREADS; ++it) {
      const int idx = it * THREADS + threadIdx.x;
      const int row = idx >> 4, e0 = (idx & 15) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + row < n)
        x = __ldg(reinterpret_cast<const float4*>(v + base + (size_t)(k0 + row) * DH + e0));
      reinterpret_cast<float4*>(vs + row * DH)[e0 / 4] = x;
    }
    __syncthreads();

    // scores of rows 4ty+r against keys 4tx+c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = reinterpret_cast<const float4*>(qt + d * LD)[ty];
      const float4 b = reinterpret_cast<const float4*>(kt + d * LD)[tx];
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    // online softmax over this tile's keys; the 16 lanes of a half-warp
    // share rows 4ty..4ty+3
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = (k0 + 4 * tx + c < n) ? s[r][c] * scale : -CUDART_INF_F;
        mt = fmaxf(mt, s[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[r], mt);  // finite: every tile holds a key < n
      const float alpha = expf(m[r] - m_new);
      float lt = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        lt += s[r][c];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
      l[r] = l[r] * alpha + lt;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      reinterpret_cast<float4*>(pt + (4 * tx + c) * LD)[ty] =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc[rows 4ty+r][cols 4tx+c] += p v
#pragma unroll 8
    for (int j = 0; j < TILE; ++j) {
      const float4 a = reinterpret_cast<const float4*>(pt + j * LD)[ty];
      const float4 b = reinterpret_cast<const float4*>(vs + j * DH)[tx];
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();  // kt, pt and vs are overwritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row < n) {
      const float inv = 1.f / l[r];
      reinterpret_cast<float4*>(out + base + (size_t)row * DH)[tx] =
          make_float4(acc[r][0] * inv, acc[r][1] * inv, acc[r][2] * inv, acc[r][3] * inv);
    }
  }
}

}  // namespace

extern "C" {

int va_head_dim() { return DH; }

// q, k, v, out: (bh, n, DH) float32, contiguous, 16-byte aligned. Launches on
// `stream` without synchronising; returns a cudaError_t, 0 on success.
int va_forward(const float* q, const float* k, const float* v, float* out, int bh, int n,
               float scale, void* stream) {
  if (bh < 1 || n < 1 || bh > 65535) return cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE - 1) / TILE, bh);
  attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, out,
                                                                             n, scale);
  return cudaGetLastError();
}

}  // extern "C"
