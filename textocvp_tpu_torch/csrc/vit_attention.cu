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

#include "hopper.cuh"
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
// dense bf16 rate of 989 TFLOP/s, and its 32M exponentials 0.0086 ms on the
// SFU (16 a clock an SM). So products, exponentials and bytes all have to
// overlap.
//
// Design (Hopper: TMA, mbarriers, wgmma):
// * A CTA owns 128 queries of one frame-head: two warpgroups of 64 query
//   rows; 5 CTAs a frame-head at n = 577, two CTAs an SM (66 KB of shared
//   memory, 128 registers a thread), so the four warpgroups of an SM
//   interleave one's softmax with another's products.
// * Thread 0 loads Q (128 x 64) once and K and V in tiles of 64 keys into a
//   ring of three stages with TMA, each stage completed on a "full" mbarrier
//   by its bytes and handed back on an "empty" mbarrier when both
//   warpgroups are done with it; it refills the stage of tile kt - 1 at the
//   top of tile kt, when the other warpgroup is most likely past it. (A
//   producer warp of its own, a ninth warp, leaves 96 registers a thread at
//   two CTAs an SM: too few to keep the wgmma in flight, which ptxas then
//   serialises, 0.0387 ms at B = 8 in that design.) The tensor maps are 3-D
//   (frame-head, token, dh) with the 128-byte swizzle: TMA fills rows past n
//   with zeros and never reads the next frame-head.
// * S = Q K^T is four wgmma m64n64k16 from shared memory (Q and K K-major,
//   the descriptor stepping 32 bytes along dh within the swizzled rows).
//   The softmax runs on the accumulator registers in float32: the running
//   max on the raw scores, then p = 2^(s * c - m * c) with c = scale *
//   log2(e), one FFMA and one ex2 a score. Only the last key tile masks
//   (keys >= n score -inf), and only where n is not a multiple of 64.
//   Nothing overlaps a warpgroup's softmax with its own next S = Q K^T: the
//   second S accumulator that takes, beside P and O, does not fit the 128
//   registers a thread of two CTAs an SM: ptxas serialised the wgmma in each
//   of the three forms tried, all slower than this one. The other three
//   warpgroups of the SM do the overlapping.
// * P stays in registers: the C fragment of S, rounded to bf16 pairs, is the
//   A fragment of P V. O += P V is four wgmma m64n64k16 with A from
//   registers and V from shared memory as it lies (keys x dh: the MN-major B
//   operand, the transpose bit set). The running sum adds the unrounded p.
// * The epilogue divides by the row sums and stores bf16 pairs of the rows
//   below n; rows past n are computed on TMA's zeros and never stored.

namespace {

constexpr int BF_BM = 128;                       // queries a CTA
constexpr int BF_BN = 64;                        // keys a tile
constexpr int BF_STAGES = 3;                     // K/V tiles in flight
constexpr int BF_GROUPS = BF_BM / 64;            // warpgroups of 64 query rows
constexpr int BF_THREADS = 128 * BF_GROUPS;
constexpr int BF_Q_BYTES = BF_BM * DH * 2;
constexpr int BF_TILE_BYTES = BF_BN * DH * 2;    // one K or V tile
constexpr int BF_SMEM_BYTES = 1024 + BF_Q_BYTES + BF_STAGES * 2 * BF_TILE_BYTES;  // + alignment

#define D8F(d, i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B: A (64 x 16) and B (16 x 64, K-major) from shared memory.
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : D8F(d, 0), D8F(d, 8), D8F(d, 16), D8F(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B: A (64 x 16) from registers, B (16 x 64) MN-major from shared memory.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : D8F(d, 0), D8F(d, 8), D8F(d, 16), D8F(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef D8F

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x on the SFU, one instruction (exp2f's ex2.approx with subnormals flushed;
// 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The C fragment of a wgmma m64nN: this lane holds, for each 8-column chunk
// j, rows r0 = 16 * warp + lane / 4 and r0 + 8 at columns 8j + 2 (lane % 4)
// and + 1, as d[4j] (r0), d[4j + 1] (r0), d[4j + 2] (r0 + 8), d[4j + 3].
__global__ void __launch_bounds__(BF_THREADS, 2)
attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                      int n, float scale_log2) {
  extern __shared__ uint8_t bf_raw[];
  __shared__ __align__(8) uint64_t q_full, full[BF_STAGES], empty[BF_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bf_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sq = smem;                // Q: 128 rows of 128 bytes, swizzled
  uint8_t* skv = smem + BF_Q_BYTES;  // stage s: K at s * 2 tiles, V one tile after

  const int bh = blockIdx.y, q0 = blockIdx.x * BF_BM;
  const int ntiles = (n + BF_BN - 1) / BF_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < BF_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * BF_GROUPS);  // one arrival a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the producer: thread 0 loads Q and the first BF_STAGES key tiles now,
  // and each later tile into the stage its tile - BF_STAGES has left
  auto load_tile = [&](int kt) {
    const int s = kt % BF_STAGES;
    uint8_t* st = skv + s * 2 * BF_TILE_BYTES;
    hopper::mbar_expect_tx(&full[s], 2 * BF_TILE_BYTES);
    hopper::tma_load_3d(st, &kmap, &full[s], 0, kt * BF_BN, bh);
    hopper::tma_load_3d(st + BF_TILE_BYTES, &vmap, &full[s], 0, kt * BF_BN, bh);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(&q_full, BF_Q_BYTES);
    hopper::tma_load_3d(sq, &qmap, &q_full, 0, q0, bh);
    for (int kt = 0; kt < BF_STAGES && kt < ntiles; ++kt) load_tile(kt);
  }

  // a warpgroup: query rows q0 + 64 wg + 16 (warp % 4) + g (+ 8)
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t q_addr = hopper::smem_u32(sq + wg * 64 * DH * 2);
  const uint32_t kv_addr = hopper::smem_u32(skv);
  using hopper::gmma_desc;
  using hopper::kLayoutSwizzle128;

  float o[32], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  hopper::mbar_wait(&q_full, 0);
  for (int kt = 0; kt < ntiles; ++kt) {
    // refill the stage of tile kt - 1 once both warpgroups are done with it:
    // by now the other warpgroup is most likely past it, so this seldom waits
    if (threadIdx.x == 0 && kt >= 1 && kt - 1 + BF_STAGES < ntiles) {
      hopper::mbar_wait(&empty[(kt - 1) % BF_STAGES], ((kt - 1) / BF_STAGES) & 1);
      load_tile(kt - 1 + BF_STAGES);
    }
    __syncwarp();
    const int s = kt % BF_STAGES;
    hopper::mbar_wait(&full[s], (kt / BF_STAGES) & 1);
    const uint32_t k_addr = kv_addr + s * 2 * BF_TILE_BYTES, v_addr = k_addr + BF_TILE_BYTES;

    // S = Q K^T: k16 step kk reads bytes 32 kk .. 32 kk + 31 of each 128-byte row
    float sc[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_bf16_ss(sc, gmma_desc(q_addr + 32 * kk, 16, 1024, kLayoutSwizzle128),
                    gmma_desc(k_addr + 32 * kk, 16, 1024, kLayoutSwizzle128), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    if (kt == ntiles - 1 && n % BF_BN) {  // the ragged last tile: keys >= n score -inf
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kt * BF_BN + 8 * (i >> 2) + 2 * t + (i & 1) >= n) sc[i] = -CUDART_INF_F;
    }
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);  // finite: every tile holds a key < n
      alpha[r] = ex2((m[r] - m_new) * scale_log2);
      m[r] = m_new;
      mc[r] = m_new * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], scale_log2, -mc[r]));
      l[r] += sc[i];
      o[i] *= alpha[r];
    }

    // O += P V: k16 step kk is key chunks 2 kk and 2 kk + 1 of S's C fragment,
    // and rows 16 kk .. 16 kk + 15 of the V tile (2048 bytes, two 8-row groups)
    uint32_t pa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < BF_BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BF_BN / 16; ++kk)
      wgmma_bf16_rs(o, pa[kk], gmma_desc(v_addr + 2048 * kk, 1024, 1024, kLayoutSwizzle128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + 64 * wg + 16 * (warp & 3) + g + 8 * r;
    if (row < n) {
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow = out + ((size_t)bh * n + row) * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// A 3-D tensor map (frame-head, token, dh) of a (bh, n, DH) bf16 tensor, boxes
// of `rows` tokens, 128-byte swizzle.
cudaError_t qkv_map(CUtensorMap* map, const void* base, int bh, int n, int rows) {
  const uint64_t dims[3] = {DH, static_cast<uint64_t>(n), static_cast<uint64_t>(bh)};
  const uint64_t strides[2] = {DH * 2, static_cast<uint64_t>(n) * DH * 2};
  const uint32_t box[3] = {DH, static_cast<uint32_t>(rows), 1};
  return hopper::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_128B);
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
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = qkv_map(&qmap, q, bh, n, BF_BM);
  if (err == cudaSuccess) err = qkv_map(&kmap, k, bh, n, BF_BN);
  if (err == cudaSuccess) err = qkv_map(&vmap, v, bh, n, BF_BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BF_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BF_BM - 1) / BF_BM, bh);
  attention_bf16_kernel<<<grid, BF_THREADS, BF_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), n,
      scale * 1.4426950408889634f);  // scale * log2(e)
  return cudaGetLastError();
}

}  // extern "C"
