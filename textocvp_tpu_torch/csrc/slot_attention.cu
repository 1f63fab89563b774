// Slot-attention refinement for Hopper (sm_90a), forward only (the Python
// wrapper raises under grad).
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
// 10 us at 3.35 TB/s (K and V read once). At B = 64 K and V are 268 MB, more
// than the 50 MB L2, so a design that rereads them each iteration from
// device memory cannot go below about 0.24 ms.
//
// The softmax runs over the SLOT axis, so it is local to each location n: one
// streaming pass over K and V per iteration computes, for each n, the S dot
// products, their softmax and +eps, and accumulates rowsum[s] += a[s, n] and
// acc[s, :] += a[s, n] v[n, :]. Then updates = acc / rowsum, which is exactly
// (attn / attn.sum(over n)) @ v. The (S, N) attention is stored only on the
// last iteration, where it is an output (after +eps, before the renorm).
//
// One launch per call: a grid of thread-block clusters, C = 8 CTAs a cluster
// (the portable size; 16 was measured slower, see PERF.md), one cluster per
// batch element, 256 threads a CTA, all iterations inside the launch. CTA r of a cluster owns
//   * one contiguous slice of the batch element's N locations (ceil(N / C);
//     when N < C some CTAs own none and still take part in every
//     cluster.sync), and
//   * D / C of the columns of the slot width: its rows of q_w, of the three
//     GRU gates of gru_w_ih and gru_w_hh, and of mlp_w1; and H / C (rounded
//     up) of the MLP's hidden rows of mlp_w0.
// Per iteration:
//   1. attend: K and V tiles of 64 locations stream into shared memory with
//      cp.async, double-buffered. The S dot products of a tile are a small
//      (S x 128) (128 x 64) product: each thread keeps its sixteenth of D
//      of every query in registers for the whole iteration and takes four
//      locations against it; the sixteen partial sums meet in shared memory
//      and all threads add them. One thread a location takes the softmax and
//      +eps; then each warp accumulates a . v over every eighth location of
//      the tile, a lane holding one float4 column for all S slots.
//   2. the CTAs' sums meet through distributed shared memory: each CTA adds
//      the C partial acc and rowsum of its columns, divides, and writes the
//      updates into every CTA's shared memory.
//   3. the update, split by output rows: GRU rows of its columns (gate order
//      r, z, n; b_hn inside r * (...), as torch.nn.GRUCell), the GRU combine
//      of its columns, the MLP's hidden rows (ReLU) and output rows, and the
//      next q. Each product's outputs go to every CTA through distributed
//      shared memory, with a cluster.sync before the product that reads them.
//      The LayerNorms (eps 1e-3) run on the full (S, 128) rows in every CTA.
// Weights are read in torch's (out, in) layout from global memory: eight
// lanes share a row, each taking every eighth float4 with all of a 128-wide
// row's loads in flight at once, and sum with three shuffles. A CTA writes
// its columns of slots_out on the last iteration and ends on the cluster.sync
// after it, so no CTA exits while another still touches its shared memory.
//
// slots_in and slots_out may alias: every CTA of a cluster reads its batch
// element's slots before the first cluster.sync, and the last iteration
// writes them long after.
//
// The launch checks cudaOccupancyMaxActiveClusters > 0 and returns an error
// otherwise; it allocates nothing (the wrapper allocates the outputs) and
// does not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;               // slot width the kernel takes
constexpr int C = 8;                 // CTAs a cluster, one cluster a batch element
constexpr int DC = D / C;            // columns of D a CTA owns in the update
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;             // locations a K/V tile
constexpr int KP = D + 4;            // padded row of a tile: conflict-free float4 reads
constexpr int LOCS = 4;              // locations a thread takes in the dot products
constexpr int GROUPS = TILE / LOCS;  // its locations: g, g + GROUPS, ...
constexpr int PARTS = THREADS / GROUPS;  // the dot products' split of D
constexpr int F4 = D / 4 / PARTS;    // float4s of D a part: q kept in registers
constexpr int MAX_SLOTS = 12;
constexpr int MAX_DEVICES = 16;
constexpr float LN_EPS = 1e-3f;      // the slot-attention LayerNorms
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block may use

static_assert(D % C == 0 && C <= 8, "C must divide D and be portable: the launch asks for no more");
static_assert(GROUPS * PARTS == THREADS && D % (4 * PARTS) == 0, "tile and thread split");
static_assert(TILE % 32 == 0, "softmax threads are whole warps");

// Offsets in floats into the dynamic shared memory; every one a multiple of 4.
template <int S>
struct Layout {
  static constexpr int q = 0;                      // (S, D) this iteration's queries
  static constexpr int h = q + S * D;              // (S, D) slots
  static constexpr int hn = h + S * D;             // (S, D) slots after the GRU
  static constexpr int x = hn + S * D;             // (S, D) updates, then LayerNorm outputs
  static constexpr int acc = x + S * D;            // (S, D) this CTA's sum of a v
  static constexpr int sum = acc + S * D;          // (S) this CTA's sum of a
  static constexpr int pstride = S * TILE + 16;    // a part's rows, padded: no bank conflict
  static constexpr int part = sum + 16;            // (PARTS, S, TILE) partial dot products
  static constexpr int attn = part + PARTS * pstride;  // (S, TILE) a tile's dots, then attention
  static constexpr int rs = attn + S * TILE;       // (TILE / 32, S) softmax warps' sums of a
  static constexpr int region = rs + 32;           // reused, one phase at a time:
  // attend: two stages of a K and a V tile; its end: (WARPS, S, D) per-warp
  // sums of a v; update: the GRU's gate rows (S, 6 DC), then m (S, H).
  static constexpr int tiles = 2 * 2 * TILE * KP;
  static constexpr int gates = S * 6 * DC;
  static_assert(S <= 16 && TILE / 32 * S <= 32, "layout");
  __host__ __device__ static int region_floats(int H) {
    const int red = WARPS * S * D, upd = gates + S * H;
    const int m = red > upd ? red : upd;
    return tiles > m ? tiles : m;
  }
  static size_t bytes(int H) { return sizeof(float) * (size_t)(region + region_floats(H)); }
};

struct Weights {
  const float *ns_w, *ns_b, *q_w, *q_b;
  const float *w_ih, *b_ih, *w_hh, *b_hh;
  const float *nm_w, *nm_b, *w0, *b0, *w1, *b1;
};

struct Params {
  const float *k, *v, *slots_in;
  float *slots_out, *attn;
  Weights wt;
  int N, H, num_iters;
  float scale, eps;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Distributed shared memory through 32-bit shared::cluster addresses. The
// asm is volatile so that the compiler computes each remote address where it
// is used and does not keep C of them live across the kernel.
__device__ __forceinline__ unsigned remote_addr(const float* local, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(local))), "r"(rank));
  return out;
}

__device__ __forceinline__ float load_remote(const float* local, unsigned rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote_addr(local, rank))
               : "memory");
  return v;
}

// a value into the same place of every CTA's shared memory in the cluster
__device__ __forceinline__ void push(const float* local, float v) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote_addr(local, c)), "f"(v)
                 : "memory");
}

// Rows [0, len) of K and V from k, v (already at the tile's first location)
// into a stage: K at stage[0], V at stage[TILE * KP]. One commit group.
__device__ __forceinline__ void load_tile(float* stage, const float* k, const float* v, int len) {
  for (int i = threadIdx.x; i < len * (D / 4); i += THREADS) {
    const int row = i / (D / 4), c = 4 * (i % (D / 4));
    cp_async16(stage + row * KP + c, k + (size_t)row * D + c);
    cp_async16(stage + TILE * KP + row * KP + c, v + (size_t)row * D + c);
  }
  cp_async_commit();
}

// out[s, :] = LN(x[s, :]) * w + b over D = 128, one warp a row.
template <int S>
__device__ void layer_norm(const float* x, const float* __restrict__ w,
                           const float* __restrict__ b, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < S; s += WARPS) {
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

// One output row of a product: its weights (torch's (out, in) layout), its
// bias and the (S, in) input it multiplies, in shared memory.
struct Row {
  const float* w;
  const float* bias;
  const float* x;
};

// For j in [0, rows): y = row(j).w . row(j).x[s, :] + row(j).bias for each of
// the S slots, handed to out(j, s, y). Eight lanes share a row, each taking
// every eighth float4 of it, and sum with three shuffles; a warp takes four
// rows at a time and keeps up to MV_LOADS float4 of weights a lane in flight
// (every weight of a 128-wide row at once); the lane with s % 8 == its part
// hands slot s on.
constexpr int MV_LOADS = 8;

template <int S, class RowFn, class Out>
__device__ __forceinline__ void matvec(int in, int rows, RowFn row, Out out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane & 7;
  const int in4 = in / 4;
  for (int j0 = warp * 4; j0 < rows; j0 += WARPS * 4) {
    const int j = j0 + (lane >> 3);
    const bool valid = j < rows;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    Row r{nullptr, nullptr, nullptr};
    if (valid) {
      r = row(j);
      const float4* w4 = reinterpret_cast<const float4*>(r.w);
      const float4* x4 = reinterpret_cast<const float4*>(r.x);
      for (int i0 = part; i0 < in4; i0 += 8 * MV_LOADS) {
        float4 wv[MV_LOADS];
#pragma unroll
        for (int u = 0; u < MV_LOADS; ++u) {
          const int i = i0 + 8 * u;
          wv[u] = i < in4 ? __ldg(w4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < MV_LOADS; ++u) {
          const int i = i0 + 8 * u;
          if (i < in4) {
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s] += dot4(wv[u], x4[s * in4 + i]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 1);
      acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 2);
      acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 4);
    }
    if (valid) {
      const float bj = __ldg(r.bias);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if ((s & 7) == part) out(j, s, acc[s] + bj);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1) slot_attention_cluster_kernel(const Params p) {
  using L = Layout<S>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem + L::q;
  float* h_s = smem + L::h;
  float* hn_s = smem + L::hn;
  float* x_s = smem + L::x;
  float* acc_s = smem + L::acc;
  float* sum_s = smem + L::sum;
  float* part_s = smem + L::part;
  float* a_s = smem + L::attn;
  float* rs_s = smem + L::rs;
  float* region = smem + L::region;
  float* gates_s = region;               // update phase
  float* m_s = region + L::gates;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = p.N, H = p.H;
  const int d0 = rank * DC;                          // this CTA's columns of D
  const int hc = (H + C - 1) / C;
  const int h0 = min(H, rank * hc), h1 = min(H, h0 + hc);  // its hidden rows
  const int chunk = (N + C - 1) / C;
  const int n0 = min(N, rank * chunk), n_len = min(N, n0 + chunk) - n0;  // its locations
  const int ntiles = (n_len + TILE - 1) / TILE;
  const float* kb = p.k + ((size_t)b * N + n0) * D;
  const float* vb = p.v + ((size_t)b * N + n0) * D;

  const Weights& wt = p.wt;
  // rows d0 + j of a (D, in) weight times an (S, in) input
  auto own = [=](const float* w, const float* bias, const float* x, int in) {
    return [=](int j) { return Row{w + (size_t)(d0 + j) * in, bias + d0 + j, x}; };
  };

  // the first tile is in flight while the first queries are computed
  if (ntiles > 0) load_tile(region, kb, vb, min(TILE, n_len));
  for (int i = tid; i < S * D; i += THREADS) h_s[i] = p.slots_in[(size_t)b * S * D + i];
  cluster.sync();  // every CTA of the cluster runs before any shared memory is written remotely
  layer_norm<S>(h_s, wt.ns_w, wt.ns_b, x_s);
  __syncthreads();
  matvec<S>(D, DC, own(wt.q_w, wt.q_b, x_s, D),
            [=](int j, int s, float y) { push(q_s + s * D + d0 + j, y); });
  cluster.sync();

  for (int it = 0; it < p.num_iters; ++it) {
    const bool last = it == p.num_iters - 1;

    // 1. attend over this CTA's locations
    float4 acc[S];
    float rsum[S];
    float4 qr[S][F4];  // this thread's part of every query, for every tile
    const int g = tid % GROUPS, pt = tid / GROUPS;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      rsum[s] = 0.f;
#pragma unroll
      for (int u = 0; u < F4; ++u)
        qr[s][u] = reinterpret_cast<const float4*>(q_s + s * D)[pt * F4 + u];
    }
    for (int t = 0; t < ntiles; ++t) {
      const int len = min(TILE, n_len - t * TILE);
      if (t + 1 < ntiles) {
        const int off = (t + 1) * TILE;
        load_tile(region + ((t + 1) & 1) * 2 * TILE * KP, kb + (size_t)off * D,
                  vb + (size_t)off * D, min(TILE, n_len - off));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ks = region + (t & 1) * 2 * TILE * KP;
      const float* vs = ks + TILE * KP;
      // dot products, an (S x 128) (128 x TILE) product: LOCS locations of
      // this thread's group times its part of the queries, all slots
#pragma unroll
      for (int l = 0; l < LOCS; ++l) {
        const int n = g + l * GROUPS;
        const float4* k4 = reinterpret_cast<const float4*>(ks + n * KP) + pt * F4;
        float dots[S];
#pragma unroll
        for (int s = 0; s < S; ++s) dots[s] = 0.f;
#pragma unroll
        for (int u = 0; u < F4; ++u) {
          const float4 kv = k4[u];
#pragma unroll
          for (int s = 0; s < S; ++s) dots[s] += dot4(qr[s][u], kv);
        }
#pragma unroll
        for (int s = 0; s < S; ++s) part_s[pt * L::pstride + s * TILE + n] = dots[s];
      }
      __syncthreads();
      for (int i = tid; i < S * TILE; i += THREADS) {  // the parts' sums
        float d = 0.f;
#pragma unroll
        for (int q = 0; q < PARTS; ++q) d += part_s[q * L::pstride + i];
        a_s[i] = d * p.scale;
      }
      __syncthreads();
      if (tid < len) {  // softmax over slots, then +eps: one thread a location
        float a[S];
#pragma unroll
        for (int s = 0; s < S; ++s) a[s] = a_s[s * TILE + tid];
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
          a[s] = a[s] / tot + p.eps;
          rsum[s] += a[s];
          a_s[s * TILE + tid] = a[s];
        }
        if (last) {
          const size_t base = (size_t)b * S * N + n0 + t * TILE + tid;
#pragma unroll
          for (int s = 0; s < S; ++s) p.attn[base + (size_t)s * N] = a[s];
        }
      }
      __syncthreads();
      // a . v: warp w takes locations w, w + WARPS, ...; a lane one float4 column
#pragma unroll 2
      for (int n = warp; n < len; n += WARPS) {
        const float4 vv = reinterpret_cast<const float4*>(vs + n * KP)[lane];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float a = a_s[s * TILE + n];
          acc[s].x += a * vv.x;
          acc[s].y += a * vv.y;
          acc[s].z += a * vv.z;
          acc[s].w += a * vv.w;
        }
      }
      __syncthreads();  // the stage, part_s and a_s are written again next
    }
    // this CTA's sums: the warps' a . v through the free tile region
#pragma unroll
    for (int s = 0; s < S; ++s)
      reinterpret_cast<float4*>(region + (warp * S + s) * D)[lane] = acc[s];
    if (warp < TILE / 32) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float r = warp_sum(rsum[s]);
        if (lane == 0) rs_s[warp * S + s] = r;
      }
    }
    __syncthreads();
    for (int i = tid; i < S * D; i += THREADS) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += region[w * S * D + i];
      acc_s[i] = t;
    }
    if (tid < S) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < TILE / 32; ++w) t += rs_s[w * S + tid];
      sum_s[tid] = t;
    }
    cluster.sync();

    // 2. updates = (sum of a v) / (sum of a) over the cluster, own columns, to all
    for (int i = tid; i < S * DC; i += THREADS) {
      const int s = i / DC, d = d0 + i % DC;
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        num += load_remote(acc_s + s * D + d, c);
        den += load_remote(sum_s + s, c);
      }
      push(x_s + s * D + d, num / den);
    }
    cluster.sync();

    // 3. GRU rows of own columns (gates r, z, n), the combine, to all
    // rows j < 3 DC: gru_w_ih on the updates, the rest gru_w_hh on the slots
    matvec<S>(D, 6 * DC,
              [=](int j) {
                const bool hh = j >= 3 * DC;
                const int jj = hh ? j - 3 * DC : j;
                const int r = (jj / DC) * D + d0 + jj % DC;
                return hh ? Row{wt.w_hh + (size_t)r * D, wt.b_hh + r, h_s}
                          : Row{wt.w_ih + (size_t)r * D, wt.b_ih + r, x_s};
              },
              [=](int j, int s, float y) { gates_s[s * 6 * DC + j] = y; });
    __syncthreads();
    for (int i = tid; i < S * DC; i += THREADS) {
      const int s = i / DC, j = i % DC;
      const float* gi = gates_s + s * 6 * DC;
      const float* gh = gi + 3 * DC;
      const float r = sigmoidf(gi[j] + gh[j]);
      const float z = sigmoidf(gi[DC + j] + gh[DC + j]);
      const float n = tanhf(gi[2 * DC + j] + r * gh[2 * DC + j]);
      push(hn_s + s * D + d0 + j, (1.f - z) * n + z * h_s[s * D + d0 + j]);
    }
    cluster.sync();

    // residual MLP: hidden rows (ReLU) to all, then output rows of own columns
    layer_norm<S>(hn_s, wt.nm_w, wt.nm_b, x_s);
    __syncthreads();
    matvec<S>(D, h1 - h0,
              [=](int j) { return Row{wt.w0 + (size_t)(h0 + j) * D, wt.b0 + h0 + j, x_s}; },
              [=](int j, int s, float y) { push(m_s + s * H + h0 + j, fmaxf(y, 0.f)); });
    cluster.sync();
    matvec<S>(H, DC, own(wt.w1, wt.b1, m_s, H), [=](int j, int s, float y) {
      const float out = hn_s[s * D + d0 + j] + y;
      push(h_s + s * D + d0 + j, out);
      if (last) p.slots_out[((size_t)b * S + s) * D + d0 + j] = out;
    });
    cluster.sync();  // on the last iteration, the last access to another CTA
    if (last) break;

    // next queries, own rows, to all; the next first tile already in flight
    if (ntiles > 0) load_tile(region, kb, vb, min(TILE, n_len));
    layer_norm<S>(h_s, wt.ns_w, wt.ns_b, x_s);
    __syncthreads();
    matvec<S>(D, DC, own(wt.q_w, wt.q_b, x_s, D),
              [=](int j, int s, float y) { push(q_s + s * D + d0 + j, y); });
    cluster.sync();
  }
}

// One launch of a call on `stream`; or, with `active` set, no launch: the
// number of clusters the card runs at once goes to *active.
template <int S>
cudaError_t run(const Params& p, int B, cudaStream_t stream, int* active) {
  const size_t smem = Layout<S>::bytes(p.H);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = slot_attention_cluster_kernel<S>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // the attributes and the cluster check once per device, slot count and size
  static size_t ready[MAX_DEVICES][MAX_SLOTS + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (active != nullptr || dev >= MAX_DEVICES || ready[dev][S] != smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (active != nullptr) {
      *active = clusters;
      return cudaSuccess;
    }
    if (clusters < 1) return cudaErrorLaunchOutOfResources;  // no fallback
    if (dev < MAX_DEVICES) ready[dev][S] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t dispatch(int S, const Params& p, int B, cudaStream_t stream, int* active) {
  switch (S) {
    case 1: return run<1>(p, B, stream, active);
    case 2: return run<2>(p, B, stream, active);
    case 3: return run<3>(p, B, stream, active);
    case 4: return run<4>(p, B, stream, active);
    case 5: return run<5>(p, B, stream, active);
    case 6: return run<6>(p, B, stream, active);
    case 7: return run<7>(p, B, stream, active);
    case 8: return run<8>(p, B, stream, active);
    case 9: return run<9>(p, B, stream, active);
    case 10: return run<10>(p, B, stream, active);
    case 11: return run<11>(p, B, stream, active);
    case 12: return run<12>(p, B, stream, active);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int sa_width() { return D; }
int sa_max_slots() { return MAX_SLOTS; }
int sa_cluster_size() { return C; }
const char* sa_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// How many clusters of the kernel for S slots and MLP width H the current
// device runs at once; a negative cudaError_t if it cannot tell.
int sa_active_clusters(int S, int H) {
  if (H < 4 || H % 4) return -static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.H = H;
  int active = 0;
  const cudaError_t err = dispatch(S, p, 1, nullptr, &active);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

// One launch on `stream`. Returns a cudaError_t: 0 on success.
int sa_forward(const float* k, const float* v, const float* slots_in, float* slots_out,
               float* attn, const float* ns_w, const float* ns_b, const float* q_w,
               const float* q_b, const float* w_ih, const float* b_ih, const float* w_hh,
               const float* b_hh, const float* nm_w, const float* nm_b, const float* w0,
               const float* b0, const float* w1, const float* b1, int B, int N, int S, int H,
               int num_iters, float scale, float eps, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || H < 4 || H % 4 || num_iters < 1)
    return cudaErrorInvalidValue;
  const Params p{k, v, slots_in, slots_out, attn,
                 {ns_w, ns_b, q_w, q_b, w_ih, b_ih, w_hh, b_hh, nm_w, nm_b, w0, b0, w1, b1},
                 N, H, num_iters, scale, eps};
  return dispatch(S, p, B, static_cast<cudaStream_t>(stream), nullptr);
}

}  // extern "C"
