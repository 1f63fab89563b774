// Float32-accurate products on Hopper's tensor cores ("3xTF32"), shared by
// csrc/vit_attention.cu and csrc/conv5.cu.
//
// A TF32 tensor-core product reads 10 of float32's 23 mantissa bits, which
// alone would miss the port's float32 limits (about 1e-4 relative on a
// 1600-term sum). So each float32 operand x is split in registers into two
// TF32 values,
//
//     big = x rounded to TF32 (nearest, ties away from zero: the rounding of
//           cvt.rna.tf32.f32),  small = x - big (exact in float32),
//
// and a product a * b becomes three TF32 products accumulated in float32:
// a_small * b_big + a_big * b_small + a_big * b_big, the two small terms
// first. The tensor core reads the top 19 bits of each operand register, so
// small enters truncated to TF32: with big rounded, |x - big - small| is at
// most 2^-21 |x|, and the dropped a_small * b_small is below 2^-22 |a b|. At
// three times the TF32 operation count (495 TFLOP/s TF32 on an H100 SXM)
// that is 165 TFLOP/s of float32-accurate work, against 67 on the CUDA
// cores. The tensor cores' float32 accumulation itself does not round to
// nearest, so a long sum drifts further from the exact one than an FFMA
// loop's: a 1600-term conv5 output lands within its 1e-4 limit of the plain
// version, but not within 1e-5.
//
// The split is the cost that the tensor pipe does not hide: cvt.rna.tf32.f32
// compiles on sm_90a to a longer sequence (with a float compare that screens
// inf and NaN), so big is rounded here with two integer operations and small
// is left for the tensor core to truncate: three instructions an operand. A NaN, whose rounded bits
// may wrap to zero, still reaches the product through small (NaN - big is
// NaN); an infinity gives NaN (inf - inf).
//
// The products are the warp-wide mma.sync.aligned.m16n8k8 (and m16n8k4)
// .row.col.f32.tf32.tf32.f32. Fragment layouts, for lane = 4 * g + t
// (g = lane / 4 in 0..7, t = lane % 4 in 0..3), from the PTX ISA:
//   A (16 x 8, row-major): a0 = A[g][t], a1 = A[g + 8][t],
//                          a2 = A[g][t + 4], a3 = A[g + 8][t + 4]
//   B (8 x 8, k x n):      b0 = B[t][g], b1 = B[t + 4][g]
//   C (16 x 8):            c0 = C[g][2t], c1 = C[g][2t + 1],
//                          c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]
//   m16n8k4 takes a0, a1 and b0 of the same positions.
// The k index of A and B is only summed over, so a kernel may map it to any
// permutation of its reduction axis as long as A and B agree.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32, nearest with ties away from zero, low 13 bits zero.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand fragment of N registers as its big and small TF32 parts.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.big[i] = round_tf32(x[i]);
    f.small[i] = __float_as_uint(x[i] - __uint_as_float(f.big[i]));
  }
  return f;
}

__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_k4(float (&d)[4], const uint32_t (&a)[2],
                                       const uint32_t (&b)[1]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// d += a * b to float32 accuracy (16 x 8 x 8).
__device__ __forceinline__ void mma3_k8(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_k8(d, a.small, b.big);
  mma_k8(d, a.big, b.small);
  mma_k8(d, a.big, b.big);
}

// d += a * b to float32 accuracy (16 x 8 x 4).
__device__ __forceinline__ void mma3_k4(float (&d)[4], const Frag<2>& a, const Frag<1>& b) {
  mma_k4(d, a.small, b.big);
  mma_k4(d, a.big, b.small);
  mma_k4(d, a.big, b.big);
}

}  // namespace tf32x3
