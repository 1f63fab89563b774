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
// GFLOP on 57 MB of q, k, v and out. The service runs float32 with TF32 off,
// so both products run as 3xTF32 on the tensor cores (tf32x3.cuh): float32
// accuracy at 3 x 8.2 GFLOP / 495 TFLOP/s = 0.050 ms, against 0.017 ms for
// the bytes at 3.35 TB/s and 0.12 ms for FFMA on the CUDA cores.
//
// Design: one block of 4 warps per (frame * head, 64-query tile), 10 tiles
// at n = 577; each warp owns 16 query rows. A warp loads its Q rows once,
// splits them into big and small TF32 fragments and keeps them in registers
// for the whole key loop. K and V stream through shared memory in tiles of
// 64 tokens, double-buffered with 16-byte cp.async copies (zero-filled past
// n), so the next tile loads while this one computes. Per tile, S = Q K^T
// (16 x 64 a warp) and P V run as m16n8k8 TF32 products, three per
// fragment pair, with an online softmax (running max and sum in float32,
// expf) in between, so the (n, n) scores never leave the SM. A tile's P V
// sums into fresh registers and joins O as O * alpha + P V in one rounded
// FFMA: the tensor cores' float32 accumulation drifts (tf32x3.cuh), and over
// 24 products a tile, not 240 a row, it stays near the plain version's
// float32 result. The C fragment of S feeds the A fragment of P V without a
// shuffle: within an 8-key step the lane holding keys 2t, 2t+1 takes them as
// the product's columns t and t + 4, and V's B fragment reads the same keys
// (rows 2t and 2t + 1). K and V rows are stored with a stride of 68 floats
// (4 mod 32 banks), so both fragment loads hit 32 distinct banks. Keys past
// n score -inf. About 68 KB of dynamic shared memory. wgmma (a 64-row warpgroup product from shared
// memory) would need K and V transposed and pre-split in shared memory;
// mma.sync keeps the split in registers and is later work to replace.

#include <cuda_bf16.h>
#include <math_constants.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::Frag;

constexpr int DH = 64;        // head width the kernel takes
constexpr int TILE = 64;      // queries per block, keys per step
constexpr int WARPS = TILE / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int LD = DH + 4;    // row stride of a staged K or V tile (floats)
constexpr int STAGE_FLOATS = 2 * TILE * LD;  // K, then V, of one key tile
constexpr int SMEM_BYTES = 2 * STAGE_FLOATS * (int)sizeof(float);

// 16-byte global -> shared copy that bypasses registers; `bytes` = 0 fills
// the 16 bytes with zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// cp.async rows [row0, row0 + TILE) of k and v into a stage; zeros past n.
__device__ __forceinline__ void stage_kv(const float* __restrict__ k,
                                         const float* __restrict__ v, int row0, int n,
                                         float* dst) {
#pragma unroll
  for (int it = 0; it < TILE * DH / 4 / THREADS; ++it) {
    const int idx = it * THREADS + threadIdx.x;
    const int row = idx >> 4, c4 = (idx & 15) * 4;
    const bool in = row0 + row < n;
    const size_t off = in ? (size_t)(row0 + row) * DH + c4 : 0;
    cp_async16(dst + row * LD + c4, k + off, in ? 16 : 0);
    cp_async16(dst + TILE * LD + row * LD + c4, v + off, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int n, float scale) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)blockIdx.y * n * DH;
  const float* kb = k + base;
  const float* vb = v + base;
  const int ntiles = (n + TILE - 1) / TILE;

  stage_kv(kb, vb, 0, n, stages);
  cp_async_commit();

  // this lane's query rows r0 and r0 + 8, as A fragments over dh
  const int r0 = blockIdx.x * TILE + warp * 16 + g;
  const float* q0 = q + base + (size_t)r0 * DH;
  Frag<4> qf[DH / 8];
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) {
    const float a[4] = {r0 < n ? __ldg(q0 + 8 * ks + t) : 0.f,
                        r0 + 8 < n ? __ldg(q0 + 8 * DH + 8 * ks + t) : 0.f,
                        r0 < n ? __ldg(q0 + 8 * ks + t + 4) : 0.f,
                        r0 + 8 < n ? __ldg(q0 + 8 * DH + 8 * ks + t + 4) : 0.f};
    qf[ks] = tf32x3::split(a);
  }

  // o[j]: rows r0, r0 + 8 x columns 8j + 2t, 8j + 2t + 1; m, l: running max
  // and this lane's share of the running sum of rows r0 and r0 + 8
  float o[DH / 8][4], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) stage_kv(kb, vb, (kt + 1) * TILE, n, stages + ((kt + 1) & 1) * STAGE_FLOATS);
    cp_async_commit();  // empty at the last tile: the wait below stays uniform
    cp_async_wait<1>();
    __syncthreads();
    const float* ks_tile = stages + (kt & 1) * STAGE_FLOATS;
    const float* vs_tile = ks_tile + TILE * LD;

    // s[j]: rows r0, r0 + 8 x keys 8j + 2t, 8j + 2t + 1 of this tile
    float s[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 8; ++ks) {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float* kp = ks_tile + (8 * j + g) * LD + 8 * ks + t;
        const float b[2] = {kp[0], kp[4]};
        tf32x3::mma3_k8(s[j], qf[ks], tf32x3::split(b));
      }
    }

    // online softmax over this tile's keys; the 4 lanes of a group share rows
    const int k0 = kt * TILE;
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (k0 + 8 * j + 2 * t + (e & 1) < n) ? s[j][e] * scale : -CUDART_INF_F;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);  // finite: every tile holds a key < n
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }

    // pv = p v: key step kk's columns t, t + 4 are keys 8kk + 2t, 8kk + 2t + 1
    float pv[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TILE / 8; ++kk) {
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      const Frag<4> pf = tf32x3::split(a);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float* vp = vs_tile + (8 * kk + 2 * t) * LD + 8 * j + g;
        const float b[2] = {vp[0], vp[LD]};
        tf32x3::mma3_k8(pv[j], pf, tf32x3::split(b));
      }
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[j][e]);
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row < n) {
      const float inv = 1.f / l[r];
      float* orow = out + base + (size_t)row * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The bfloat16 variant (tpu.compute_dtype "bfloat16"): q, k, v and out bf16.
// What the JAX package computes in bf16: S = q k^T with float32 accumulation,
// the softmax in float32, the probabilities rounded to bf16 before P V (its
// XLA arm casts them to the compute dtype, textocvp_tpu/nn/vit.py:77-79, the
// TPU flash kernel casts p to v's dtype), the output rounded once to bf16.
//
// What bounds it: bytes. At B = 8 (96 frame-heads, n = 577) q, k, v and out
// are 28.4 MB, 0.0085 ms at 3.35 TB/s; its 8.18 GFLOP take 0.0083 ms at the
// dense bf16 rate of 989 TFLOP/s.
//
// Design: the float32 kernel's blocks (4 warps, 64 queries, 16 a warp; K and
// V tiles of 64 keys through shared memory, double-buffered with 16-byte
// cp.async copies, zero-filled past n; keys past n score -inf), with both
// products as mma.sync.m16n8k16 bf16 with float32 accumulators: one product
// a fragment pair. The Q fragments stay in registers for the key loop. The B
// fragments are ldmatrix.x4 loads, of K as it lies and of V transposed
// (.trans), from rows of 72 bf16 (144 bytes: 8 rows of a phase in 8 distinct
// bank groups). The online softmax keeps the running max and sum in float32
// (expf); the C fragment of S, rounded to bf16 pairs, is the A fragment of
// P V without a shuffle; the running sum adds the unrounded p. 36 KB of
// shared memory.

namespace {

constexpr int BF_LD = DH + 8;                        // bf16 row stride of a staged K or V tile
constexpr int BF_STAGE = 2 * TILE * BF_LD;           // bf16 of a stage: K, then V
constexpr int BF_SMEM_BYTES = 2 * BF_STAGE * 2;      // two stages

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async rows [row0, row0 + TILE) of k and v into a stage; zeros past n.
__device__ __forceinline__ void bf_stage_kv(const __nv_bfloat16* __restrict__ k,
                                            const __nv_bfloat16* __restrict__ v, int row0, int n,
                                            __nv_bfloat16* dst) {
#pragma unroll
  for (int it = 0; it < TILE * DH / 8 / THREADS; ++it) {
    const int idx = it * THREADS + threadIdx.x;
    const int row = idx >> 3, c8 = (idx & 7) * 8;
    const bool in = row0 + row < n;
    const size_t off = in ? (size_t)(row0 + row) * DH + c8 : 0;
    cp_async16(dst + row * BF_LD + c8, k + off, in ? 16 : 0);
    cp_async16(dst + TILE * BF_LD + row * BF_LD + c8, v + off, in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int n, float scale) {
  extern __shared__ uint4 bf_smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(bf_smem);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)blockIdx.y * n * DH;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int ntiles = (n + TILE - 1) / TILE;

  bf_stage_kv(kb, vb, 0, n, stages);
  cp_async_commit();

  // this lane's query rows r0 and r0 + 8 as A fragments over dh: k16 step ks
  // holds columns 16ks + 2t, 2t + 1 (a0, a1) and 16ks + 2t + 8, 2t + 9 (a2, a3)
  const int r0 = blockIdx.x * TILE + warp * 16 + g;
  const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q + base + (size_t)r0 * DH);
  const uint32_t* q1 = q0 + 8 * DH / 2;
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    qf[ks][0] = r0 < n ? __ldg(q0 + 8 * ks + t) : 0u;
    qf[ks][1] = r0 + 8 < n ? __ldg(q1 + 8 * ks + t) : 0u;
    qf[ks][2] = r0 < n ? __ldg(q0 + 8 * ks + t + 4) : 0u;
    qf[ks][3] = r0 + 8 < n ? __ldg(q1 + 8 * ks + t + 4) : 0u;
  }

  // o[j]: rows r0, r0 + 8 x columns 8j + 2t, 8j + 2t + 1; m, l: running max
  // and this lane's share of the running sum of rows r0 and r0 + 8
  float o[DH / 8][4], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // ldmatrix rows of this lane: K (keys 16jp + (lane & 7) + 8 (lane >> 4),
  // columns 16ks + 8 ((lane >> 3) & 1)); V transposed (keys 16kk + (lane & 15),
  // columns 16jp + 8 (lane >> 4))
  const int k_row = (lane & 7) + 8 * (lane >> 4), k_col = 8 * ((lane >> 3) & 1);
  const int v_row = lane & 15, v_col = 8 * (lane >> 4);

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles)
      bf_stage_kv(kb, vb, (kt + 1) * TILE, n, stages + ((kt + 1) & 1) * BF_STAGE);
    cp_async_commit();  // empty at the last tile: the wait below stays uniform
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks_tile = stages + (kt & 1) * BF_STAGE;
    const __nv_bfloat16* vs_tile = ks_tile + TILE * BF_LD;

    // s[j]: rows r0, r0 + 8 x keys 8j + 2t, 8j + 2t + 1 of this tile
    float s[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
      for (int jp = 0; jp < TILE / 16; ++jp) {
        uint32_t b[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                     : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                     : "r"(smem_addr(ks_tile + (16 * jp + k_row) * BF_LD + 16 * ks + k_col)));
        mma_bf16(s[2 * jp], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], b[2], b[3]);
      }
    }

    // online softmax over this tile's keys; the 4 lanes of a group share rows
    const int k0 = kt * TILE;
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (k0 + 8 * j + 2 * t + (e & 1) < n) ? s[j][e] * scale : -CUDART_INF_F;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);  // finite: every tile holds a key < n
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // o += p v: key step kk's A fragment is the C fragments of key tiles 2kk, 2kk + 1
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < DH / 16; ++jp) {
        uint32_t b[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                     : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                     : "r"(smem_addr(vs_tile + (16 * kk + v_row) * BF_LD + 16 * jp + v_col)));
        mma_bf16(o[2 * jp], pa, b[0], b[1]);
        mma_bf16(o[2 * jp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row < n) {
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow = out + base + (size_t)row * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
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
  cudaError_t err = cudaFuncSetAttribute(attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE - 1) / TILE, bh);
  attention_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, n, scale);
  return cudaGetLastError();
}

// The bf16 variant: q, k, v, out (bh, n, DH) bf16, contiguous, 16-byte
// aligned. Launches on `stream` without synchronising; returns a
// cudaError_t, 0 on success.
int va_bf16_forward(const void* q, const void* k, const void* v, void* out, int bh, int n,
                    float scale, void* stream) {
  if (bh < 1 || n < 1 || bh > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BF_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE - 1) / TILE, bh);
  attention_bf16_kernel<<<grid, THREADS, BF_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), n, scale);
  return cudaGetLastError();
}

}  // extern "C"
