// Slot-attention refinement for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel textocvp_tpu/ops/pallas/slot_attention_kernel.py
// (_slot_attention_kernel, launched by _pallas_forward), which keeps one batch
// element's whole K and V in VMEM across every iteration. Here K and V are
// 2 MB each in float32 at N = 4096, D = 128: far more than one SM's 227 KB of
// shared memory, so that design does not carry over.
//
// What bounds it on an H100: bytes. At B = 8, N = 4096 one iteration reads
// K and V (2 * 8 * 4096 * 128 * 4 B = 33.6 MB) for about 0.07 GFLOP of
// attention arithmetic, so the least time for three iterations is about
// 10 us at 3.35 TB/s (K and V read once) and at most ~30 us if every
// iteration rereads them from device memory.
//
// The design follows from the softmax running over the SLOT axis: it is local
// to each location n. So one streaming pass over K and V per iteration
// computes, for each n, the S dot products, their softmax and +eps, and
// accumulates rowsum[s] += a[s, n] and acc[s, :] += a[s, n] v[n, :]. Then
// updates = acc / rowsum, which is exactly (attn / attn.sum(over n)) @ v. The
// (S, N) attention matrix is never stored except on the last iteration,
// where it is an output.
//
//   attend_kernel  grid (N / 128, B), 128 threads. Each warp takes one
//                  location at a time: a lane holds 4 of the 128 feature
//                  values (one float4 of K and of V per location), the S dot
//                  products are reduced across the warp, and the block writes
//                  its chunk's partial acc (S, D) and rowsum (S).
//   update_kernel  grid (B), 512 threads, one block per batch element. It
//                  reduces the partial sums, runs the GRU and the residual
//                  MLP on the (S, D) slots, and computes the next iteration's
//                  q = W_q LN(slots) + b. Weights are read in torch's (out, in)
//                  layout: each warp takes 4 output rows at a time, the lanes
//                  split the input dimension, so loads are coalesced.
//
// One call runs update (q only), then per iteration attend + update: 1 + 2
// iterations launches on the caller's stream, no synchronisation, no
// allocation (the wrapper allocates outputs and scratch). At serving batch 8
// update_kernel occupies 8 of the 132 SMs; fusing it into the pass and
// spreading it over more blocks is later work.

#include <cuda_runtime.h>

namespace {

constexpr int D = 128;             // slot width the kernel takes
constexpr int CHUNK = 128;         // locations per attend block
constexpr int ATTEND_WARPS = 4;
constexpr int UPDATE_THREADS = 512;
constexpr int ROWS = 4;            // output rows per warp step in matvec
constexpr int MAX_SLOTS = 12;
constexpr float LN_EPS = 1e-3f;    // the slot-attention LayerNorms
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may use

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

template <int S>
__global__ void __launch_bounds__(ATTEND_WARPS * 32)
attend_kernel(const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ q, float* __restrict__ part_acc,
              float* __restrict__ part_sum, float* __restrict__ attn,
              int N, int nchunks, float scale, float eps, int write_attn) {
  __shared__ float4 q_s[S][32];
  __shared__ __align__(16) float acc_s[ATTEND_WARPS][S][D];
  __shared__ float sum_s[ATTEND_WARPS][S];
  __shared__ float attn_s[S][CHUNK];

  const int c = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * S * D);
  for (int i = tid; i < S * 32; i += blockDim.x) q_s[i / 32][i % 32] = q4[i];
  __syncthreads();

  float4 qr[S], acc[S];
  float rsum[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    qr[s] = q_s[s][lane];
    acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    rsum[s] = 0.f;
  }

  const int n0 = c * CHUNK;
  const int n_len = min(CHUNK, N - n0);
  for (int i = warp; i < n_len; i += ATTEND_WARPS) {
    const size_t off = ((size_t)b * N + n0 + i) * D;
    const float4 kk = __ldg(reinterpret_cast<const float4*>(k + off) + lane);
    const float4 vv = __ldg(reinterpret_cast<const float4*>(v + off) + lane);
    float a[S];
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = warp_sum(dot4(qr[s], kk)) * scale;
    float m = a[0];
#pragma unroll
    for (int s = 1; s < S; ++s) m = fmaxf(m, a[s]);
    float tot = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a[s] = expf(a[s] - m);
      tot += a[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a[s] = a[s] / tot + eps;  // softmax over slots, then +eps
      rsum[s] += a[s];
      acc[s].x += a[s] * vv.x;
      acc[s].y += a[s] * vv.y;
      acc[s].z += a[s] * vv.z;
      acc[s].w += a[s] * vv.w;
    }
    if (write_attn && lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) attn_s[s][i] = a[s];
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) reinterpret_cast<float4*>(acc_s[warp][s])[lane] = acc[s];
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) sum_s[warp][s] = rsum[s];
  }
  __syncthreads();

  const size_t pbase = ((size_t)b * nchunks + c) * S;
  for (int idx = tid; idx < S * D; idx += blockDim.x) {
    const int s = idx / D, d = idx % D;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < ATTEND_WARPS; ++w) t += acc_s[w][s][d];
    part_acc[pbase * D + idx] = t;
  }
  if (tid < S) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < ATTEND_WARPS; ++w) t += sum_s[w][tid];
    part_sum[pbase + tid] = t;
  }
  if (write_attn) {
    for (int idx = tid; idx < S * CHUNK; idx += blockDim.x) {
      const int s = idx / CHUNK, i = idx % CHUNK;
      if (i < n_len) attn[((size_t)b * S + s) * N + n0 + i] = attn_s[s][i];
    }
  }
}

// Y[s, j] = act(sum_i W[j, i] X[s, i] + bias[j]) for the S rows of X, all in
// shared memory except W (out, in) and bias, which are read from global.
template <int S>
__device__ void matvec(const float* __restrict__ W, const float* __restrict__ bias,
                       const float* X, int in, float* Y, int out, bool relu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int in4 = in / 4;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  const float4* X4 = reinterpret_cast<const float4*>(X);
  for (int j0 = warp * ROWS; j0 < out; j0 += nwarps * ROWS) {
    float p[ROWS][S];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s) p[r][s] = 0.f;
    for (int i = lane; i < in4; i += 32) {
      float4 w[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        w[r] = (j0 + r < out) ? __ldg(W4 + (size_t)(j0 + r) * in4 + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 x = X4[s * in4 + i];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) p[r][s] += dot4(w[r], x);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s) p[r][s] = warp_sum(p[r][s]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (j0 + r >= out) break;
        const float bj = bias[j0 + r];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float y = p[r][s] + bj;
          Y[s * out + j0 + r] = relu ? fmaxf(y, 0.f) : y;
        }
      }
    }
  }
}

// out[s, :] = LN(x[s, :]) * w + b over D = 128, one warp per row.
template <int S>
__device__ void layer_norm(const float* x, const float* __restrict__ w,
                           const float* __restrict__ b, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int s = warp; s < S; s += nwarps) {
    const float4 xv = reinterpret_cast<const float4*>(x + s * D)[lane];
    const float mean = warp_sum(xv.x + xv.y + xv.z + xv.w) * (1.f / D);
    const float4 c = make_float4(xv.x - mean, xv.y - mean, xv.z - mean, xv.w - mean);
    const float var = warp_sum(dot4(c, c)) * (1.f / D);
    const float rstd = rsqrtf(var + LN_EPS);
    const float4 wv = __ldg(reinterpret_cast<const float4*>(w) + lane);
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b) + lane);
    reinterpret_cast<float4*>(out + s * D)[lane] =
        make_float4(c.x * rstd * wv.x + bv.x, c.y * rstd * wv.y + bv.y,
                    c.z * rstd * wv.z + bv.z, c.w * rstd * wv.w + bv.w);
  }
}

struct Weights {
  const float *ns_w, *ns_b, *q_w, *q_b;
  const float *w_ih, *b_ih, *w_hh, *b_hh;
  const float *nm_w, *nm_b, *w0, *b0, *w1, *b1;
};

// slots_in and slots_out may alias: each block reads its own batch element
// into shared memory before it writes anything back.
template <int S>
__global__ void __launch_bounds__(UPDATE_THREADS)
update_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_sum,
              int nchunks, const float* slots_in, float* slots_out,
              float* __restrict__ q_out, Weights wt, int H, int do_gru, int do_query) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // (S, D) slots
  float* x_s = h_s + S * D;                        // (S, D) updates / LN output
  float* gi_s = x_s + S * D;                       // (S, 3D)
  float* gh_s = gi_s + S * 3 * D;                  // (S, 3D)
  float* m_s = gh_s + S * 3 * D;                   // (S, H)
  const int b = blockIdx.x, tid = threadIdx.x;

  for (int i = tid; i < S * D; i += blockDim.x) h_s[i] = slots_in[(size_t)b * S * D + i];
  if (do_gru) {
    for (int i = tid; i < S * D; i += blockDim.x) {
      const int s = i / D;
      float num = 0.f, den = 0.f;
      for (int c = 0; c < nchunks; ++c) {
        const size_t base = ((size_t)b * nchunks + c) * S;
        num += part_acc[base * D + i];
        den += part_sum[base + s];
      }
      x_s[i] = num / den;  // (attn / rowsum) @ v
    }
    __syncthreads();
    matvec<S>(wt.w_ih, wt.b_ih, x_s, D, gi_s, 3 * D, false);
    matvec<S>(wt.w_hh, wt.b_hh, h_s, D, gh_s, 3 * D, false);
    __syncthreads();
    for (int i = tid; i < S * D; i += blockDim.x) {
      const int s = i / D, d = i % D;
      const float* gi = gi_s + s * 3 * D;
      const float* gh = gh_s + s * 3 * D;
      const float r = sigmoidf(gi[d] + gh[d]);
      const float z = sigmoidf(gi[D + d] + gh[D + d]);
      const float n = tanhf(gi[2 * D + d] + r * gh[2 * D + d]);
      h_s[i] = (1.f - z) * n + z * h_s[i];
    }
    __syncthreads();
    layer_norm<S>(h_s, wt.nm_w, wt.nm_b, x_s);
    __syncthreads();
    matvec<S>(wt.w0, wt.b0, x_s, D, m_s, H, true);
    __syncthreads();
    matvec<S>(wt.w1, wt.b1, m_s, H, gi_s, D, false);
    __syncthreads();
    for (int i = tid; i < S * D; i += blockDim.x) h_s[i] += gi_s[i];
  }
  __syncthreads();
  for (int i = tid; i < S * D; i += blockDim.x) slots_out[(size_t)b * S * D + i] = h_s[i];
  if (do_query) {
    layer_norm<S>(h_s, wt.ns_w, wt.ns_b, x_s);
    __syncthreads();
    matvec<S>(wt.q_w, wt.q_b, x_s, D, gi_s, D, false);
    __syncthreads();
    for (int i = tid; i < S * D; i += blockDim.x) q_out[(size_t)b * S * D + i] = gi_s[i];
  }
}

struct Args {
  const float *k, *v, *slots_in;
  float *slots_out, *attn, *q, *part_acc, *part_sum;
  Weights wt;
  int B, N, H, num_iters;
  float scale, eps;
  cudaStream_t stream;
};

template <int S>
cudaError_t run(const Args& a) {
  const int nchunks = (a.N + CHUNK - 1) / CHUNK;
  const size_t smem = (size_t)S * (8 * D + a.H) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(update_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  update_kernel<S><<<a.B, UPDATE_THREADS, smem, a.stream>>>(
      a.part_acc, a.part_sum, nchunks, a.slots_in, a.slots_out, a.q, a.wt, a.H, 0, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int it = 0; it < a.num_iters; ++it) {
    const bool last = it == a.num_iters - 1;
    attend_kernel<S><<<dim3(nchunks, a.B), ATTEND_WARPS * 32, 0, a.stream>>>(
        a.k, a.v, a.q, a.part_acc, a.part_sum, a.attn, a.N, nchunks, a.scale, a.eps,
        last ? 1 : 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    update_kernel<S><<<a.B, UPDATE_THREADS, smem, a.stream>>>(
        a.part_acc, a.part_sum, nchunks, a.slots_out, a.slots_out, a.q, a.wt, a.H, 1,
        last ? 0 : 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int sa_chunk_size() { return CHUNK; }
int sa_width() { return D; }
int sa_max_slots() { return MAX_SLOTS; }

// Returns a cudaError_t: 0 on success.
int sa_forward(const float* k, const float* v, const float* slots_in, float* slots_out,
               float* attn, float* q, float* part_acc, float* part_sum,
               const float* ns_w, const float* ns_b, const float* q_w, const float* q_b,
               const float* w_ih, const float* b_ih, const float* w_hh, const float* b_hh,
               const float* nm_w, const float* nm_b, const float* w0, const float* b0,
               const float* w1, const float* b1, int B, int N, int S, int H,
               int num_iters, float scale, float eps, void* stream) {
  if (B < 1 || N < 1 || H < 4 || H % 4 || num_iters < 1) return cudaErrorInvalidValue;
  Args a{k, v, slots_in, slots_out, attn, q, part_acc, part_sum,
         {ns_w, ns_b, q_w, q_b, w_ih, b_ih, w_hh, b_hh, nm_w, nm_b, w0, b0, w1, b1},
         B, N, H, num_iters, scale, eps, static_cast<cudaStream_t>(stream)};
  switch (S) {
    case 1: return run<1>(a);
    case 2: return run<2>(a);
    case 3: return run<3>(a);
    case 4: return run<4>(a);
    case 5: return run<5>(a);
    case 6: return run<6>(a);
    case 7: return run<7>(a);
    case 8: return run<8>(a);
    case 9: return run<9>(a);
    case 10: return run<10>(a);
    case 11: return run<11>(a);
    case 12: return run<12>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
