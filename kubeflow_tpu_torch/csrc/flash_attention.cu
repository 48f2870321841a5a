// GQA flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of kubeflow_tpu/ops/attention.py:
// _splash_flash / _splash_kernel (:215-258, JAX's splash attention:
// GQA-native, fused backward, causal block skipping) and _pallas_flash
// (:172, JAX's TPU flash attention, MHA with K/V broadcast to the query
// heads). Both compute the math of the reference _flash_fwd_xla /
// _flash_bwd_xla; one set of kernels serves both names, GQA-native, with
// no broadcast of K/V.
//
// Layouts (JAX's public layout, read in place, no transposes):
//   q, out, dout, dq  [B, T, Hq, D]     bf16 or f32 (one type for all)
//   k, v, dk, dv      [B, S, Hkv, D]    query head h reads kv head h / G
//   kv_mask           [B, S] f32 or null; > 0 attends
//   lse, delta        [B, Hq, T] f32
// Scores s = (q . k) * scale in f32 (the reference scales the f32 scores,
// not the queries), causal mask top-left aligned (query i sees keys j <= i,
// also when S != T). A row whose keys are all masked writes out = 0 and
// lse = -1e30, and its p, so its gradients, are exactly 0.
//
// Bound on the H100: operations. Causal attention at B=4, T=S=2048,
// Hq=32, D=128 does 4*D flops per attended (query, key) pair forward
// (1.37e11) and 10*D backward (QK^T recompute, dP, dV, dK, dQ) against
// ~30 MB per pass: thousands of flops per byte, so the least time is
// flops over the bf16 tensor-core peak (989 TFLOP/s): ~0.14 ms forward,
// ~0.35 ms backward. The design below therefore puts every product on the
// tensor cores and keeps the tensor cores fed: TMA copies overlap the
// products through a 2-stage ring, and nothing but the outputs and lse
// goes back to device memory.
//
// Two routes, chosen by dtype.
//
// bf16 (namespace tc): the tensor cores. Every product is a
//   wgmma.mma_async with f32 accumulators in registers; every tile
//   arrives by cp.async.bulk.tensor (TMA) into shared memory in the
//   128-byte swizzle that wgmma reads, completing on an mbarrier. One
//   4-D tensor map per tensor, {D, heads, len, B}, with a box of 64
//   columns x 1 head x the tile's rows: a D=128 row is two boxes. Rows
//   past the end arrive as zeros and are masked. One producer warp issues
//   the copies; the consumer warpgroups compute.
//   flash_fwd_tc_kernel       one CTA per (128-query tile, query head,
//     batch): two consumer warpgroups of 64 rows, a 2-stage ring of
//     128-key K and V tiles. S = Q.K^T with both operands in shared
//     memory (K-major); the online softmax runs on the accumulator
//     fragments; P goes to bf16 in registers and is the register A
//     operand of O += P.V, with V read MN-major through wgmma's transpose
//     bit. Tiles wholly above the diagonal are never loaded; only
//     diagonal, ragged-edge and kv-masked tiles are masked. Blocks run
//     heaviest causal tile first, with the G query heads of one kv head
//     side by side so that they share K/V in L2.
//   flash_bwd_delta_kernel    delta = rowsum(dout * out), one warp a row.
//   flash_bwd_dkdv_tc_kernel  one CTA per (64-key tile, kv head, batch),
//     looping over the G query heads and the query tiles from the
//     diagonal down through a 2-stage ring of Q/dO tiles: S^T = K.Q^T and
//     dP^T = V.dO^T (K-major), P^T and dS^T to bf16 in registers, dV +=
//     P^T.dO and dK += dS^T.Q with dO and Q MN-major. dk and dv
//     accumulate in f32 registers and are written once: no atomics,
//     bit-for-bit repeatable.
//   flash_bwd_dq_tc_kernel    one CTA per (64-query tile, query head,
//     batch): S and dP again, dQ += dS.K with K MN-major.
//   Where bf16 rounding happens: P before P.V in the forward; P before
//   dV, and dS before dQ and dK, in the backward. Splash rounds the same
//   backward operands (splash_attention_kernel.py:1395, 1788, 1804) but
//   runs the forward's P.V in f32 (:820). On this card f32 operands would
//   run as TF32, and wgmma takes no MN-major B for 32-bit types, so the
//   forward rounds P as FlashAttention and SDPA do. Scores, the softmax
//   and its sums stay f32.
//
// f32: the CUDA cores, f32 FMAs throughout, no TF32 (the exact-parity
//   route). flash_fwd_kernel, flash_bwd_dkdv_kernel (the same loop order
//   as the bf16 one) and flash_bwd_dq_kernel tile by 64 rows; 256
//   threads hold a 4 x 4 score micro-tile and a 4 x (D/16) output
//   micro-tile each, from tiles staged in shared memory as f32 (rows
//   padded to D+1 floats so column reads do not conflict).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // cudaGetDriverEntryPoint, so nothing links -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kPStride = kTile + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows row0 .. row0+63 of head `head` of a [B, len, heads, HD] tensor into
// shared memory as f32 [64][HD+1]; rows at or past `len` read as 0.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int b, int head, int row0, int len,
                                          int heads) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = row0 + r;
    float val = 0.f;
    if (row < len) {
      val = src[((static_cast<size_t>(b) * len + row) * heads + head) * HD + d];
    }
    dst[r * (HD + 1) + d] = val;
  }
}

// Both routes: 1 for key j that exists and that kv_mask lets through.
__device__ __forceinline__ float key_ok(const float* __restrict__ kvm, int b,
                                        int j, int s_len) {
  return (j < s_len &&
          (kvm == nullptr || kvm[static_cast<size_t>(b) * s_len + j] > 0.f))
             ? 1.f
             : 0.f;
}

// key_ok of keys k0 .. k0+63.
__device__ __forceinline__ void load_key_mask(float* dst,
                                              const float* __restrict__ kvm,
                                              int b, int k0, int s_len) {
  if (threadIdx.x < kTile) {
    dst[threadIdx.x] = key_ok(kvm, b, k0 + threadIdx.x, s_len);
  }
}

// lse and delta of query rows q0 .. q0+63 of head h; rows past T read as
// fully masked (lse -1e30), so their p is 0.
__device__ __forceinline__ void load_row_stats(float* s_lse, float* s_delta,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int b, int h, int q0, int t_len,
                                               int hq) {
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    const size_t at = (static_cast<size_t>(b) * hq + h) * t_len + r;
    s_lse[threadIdx.x] = r < t_len ? lse[at] : kNegInf;
    s_delta[threadIdx.x] = r < t_len ? delta[at] : 0.f;
  }
}

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         (3 * kTile * (HD + 1) + kTile * kPStride + kTile);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kvm,
                 float* __restrict__ out, float* __restrict__ lse, int t_len,
                 int s_len, int hq, int hkv, int group, int causal,
                 float scale) {
  constexpr int kS = HD + 1;
  constexpr int kD = HD / 16;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_k = s_q + kTile * kS;
  float* s_v = s_k + kTile * kS;
  float* s_p = s_v + kTile * kS;
  float* s_mask = s_p + kTile * kPStride;

  // Heaviest causal tiles (the last query rows) are scheduled first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kTile;
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;

  load_tile<HD>(s_q, q, b, h, q0, t_len, hq);

  float m[4], l[4], acc[4][kD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kD; ++dd) acc[i][dd] = 0.f;
  }

  const int k_end = causal ? min(s_len, q0 + kTile) : s_len;
  const int n_kt = (k_end + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // readers of the previous tile are done
    load_tile<HD>(s_k, k, b, hk, k0, s_len, hkv);
    load_tile<HD>(s_v, v, b, hk, k0, s_len, hkv);
    load_key_mask(s_mask, kvm, b, k0, s_len);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = s_q[(rg * 4 + i) * kS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = s_k[(cg + 16 * j) * kS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int qi = q0 + r;
      bool ok[4];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        ok[j] = s_mask[c] > 0.f && (!causal || k0 + c <= qi);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        s_p[r * kPStride + cg + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(psum);
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) acc[i][dd] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int c = 0; c < kTile; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = s_p[(rg * 4 + i) * kPStride + c];
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) {
        const float vb = s_v[c * kS + cg + 16 * dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dd] = fmaf(pa[i], vb, acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi < t_len) {
      const bool valid = m[i] > kNegInf / 2;
      const size_t row = (static_cast<size_t>(b) * t_len + qi) * hq + h;
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) {
        out[row * HD + cg + 16 * dd] = valid ? acc[i][dd] / l[i] : 0.f;
      }
      if (cg == 0) {
        lse[(static_cast<size_t>(b) * hq + h) * t_len + qi] =
            valid ? m[i] + logf(l[i]) : kNegInf;
      }
    }
  }
}

// Both routes: delta[b, h, t] = sum_d dout * out, one warp a row.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int t_len,
                       int hq) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const size_t base = static_cast<size_t>(row) * HD;
  float sum = 0.f;
  for (int d = lane; d < HD; d += 32) {
    sum += to_f32(out[base + d]) * to_f32(dout[base + d]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    // row = (b * T + t) * Hq + h  ->  delta[b, h, t]
    const int h = row % hq;
    const int bt = row / hq;
    const int t = bt % t_len;
    const int b = bt / t_len;
    delta[(static_cast<size_t>(b) * hq + h) * t_len + t] = sum;
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (4 * kTile * (HD + 1) + 2 * kTile * kPStride + 3 * kTile);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ kvm,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int t_len, int s_len, int hq, int hkv, int group,
                      int causal, float scale) {
  constexpr int kS = HD + 1;
  constexpr int kD = HD / 16;
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + kTile * kS;
  float* s_q = s_v + kTile * kS;
  float* s_do = s_q + kTile * kS;
  float* s_p = s_do + kTile * kS;     // [key][query]
  float* s_ds = s_p + kTile * kPStride;  // [key][query]
  float* s_lse = s_ds + kTile * kPStride;
  float* s_delta = s_lse + kTile;
  float* s_mask = s_delta + kTile;

  // Key tile 0 sees every query tile under the causal mask: heavy first.
  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kTile;
  const int rg = threadIdx.x >> 4;  // key rows rg*4 .. rg*4+3
  const int cg = threadIdx.x & 15;  // query columns cg + 16j; dims cg + 16dd

  load_tile<HD>(s_k, k, b, hk, k0, s_len, hkv);
  load_tile<HD>(s_v, v, b, hk, k0, s_len, hkv);
  load_key_mask(s_mask, kvm, b, k0, s_len);

  float dka[4][kD], dva[4][kD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int dd = 0; dd < kD; ++dd) {
      dka[i][dd] = 0.f;
      dva[i][dd] = 0.f;
    }
  }

  // The first query that can see key k0 (top-left causal alignment).
  const int q_begin = causal ? k0 : 0;
  const int n_qt = (t_len + kTile - 1) / kTile;
  const int qt0 = q_begin < t_len ? q_begin / kTile : n_qt;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<HD>(s_q, q, b, h, q0, t_len, hq);
      load_tile<HD>(s_do, dout, b, h, q0, t_len, hq);
      load_row_stats(s_lse, s_delta, lse, delta, b, h, q0, t_len, hq);
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = 0.f;
          dpt[i][j] = 0.f;
        }
      }
      for (int d = 0; d < HD; ++d) {
        float ka[4], va[4], qb[4], ob[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = s_k[(rg * 4 + i) * kS + d];
          va[i] = s_v[(rg * 4 + i) * kS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = s_q[(cg + 16 * j) * kS + d];
          ob[j] = s_do[(cg + 16 * j) * kS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
            dpt[i][j] = fmaf(va[i], ob[j], dpt[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = cg + 16 * j;
          const float row_lse = s_lse[r];
          const bool ok = s_mask[c] > 0.f && row_lse > kNegInf / 2 &&
                          (!causal || k0 + c <= q0 + r);
          const float p = ok ? expf(st[i][j] * scale - row_lse) : 0.f;
          s_p[c * kPStride + r] = p;
          s_ds[c * kPStride + r] = p * (dpt[i][j] - s_delta[r]) * scale;
        }
      }
      __syncthreads();

      for (int r = 0; r < kTile; ++r) {
        float pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = s_p[(rg * 4 + i) * kPStride + r];
          sa[i] = s_ds[(rg * 4 + i) * kPStride + r];
        }
#pragma unroll
        for (int dd = 0; dd < kD; ++dd) {
          const float ob = s_do[r * kS + cg + 16 * dd];
          const float qb = s_q[r * kS + cg + 16 * dd];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][dd] = fmaf(pa[i], ob, dva[i][dd]);
            dka[i][dd] = fmaf(sa[i], qb, dka[i][dd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + rg * 4 + i;
    if (kj < s_len) {
      const size_t row = (static_cast<size_t>(b) * s_len + kj) * hkv + hk;
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) {
        dk[row * HD + cg + 16 * dd] = dka[i][dd];
        dv[row * HD + cg + 16 * dd] = dva[i][dd];
      }
    }
  }
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (4 * kTile * (HD + 1) + kTile * kPStride + 3 * kTile);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ kvm,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int t_len, int s_len, int hq, int hkv, int group,
                    int causal, float scale) {
  constexpr int kS = HD + 1;
  constexpr int kD = HD / 16;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kTile * kS;
  float* s_k = s_do + kTile * kS;
  float* s_v = s_k + kTile * kS;
  float* s_ds = s_v + kTile * kS;  // [query][key]
  float* s_lse = s_ds + kTile * kPStride;
  float* s_delta = s_lse + kTile;
  float* s_mask = s_delta + kTile;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kTile;
  const int rg = threadIdx.x >> 4;  // query rows rg*4 .. rg*4+3
  const int cg = threadIdx.x & 15;  // key columns cg + 16j; dims cg + 16dd

  load_tile<HD>(s_q, q, b, h, q0, t_len, hq);
  load_tile<HD>(s_do, dout, b, h, q0, t_len, hq);
  load_row_stats(s_lse, s_delta, lse, delta, b, h, q0, t_len, hq);

  float dqa[4][kD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int dd = 0; dd < kD; ++dd) dqa[i][dd] = 0.f;
  }

  const int k_end = causal ? min(s_len, q0 + kTile) : s_len;
  const int n_kt = (k_end + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<HD>(s_k, k, b, hk, k0, s_len, hkv);
    load_tile<HD>(s_v, v, b, hk, k0, s_len, hkv);
    load_key_mask(s_mask, kvm, b, k0, s_len);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    }
    for (int d = 0; d < HD; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = s_q[(rg * 4 + i) * kS + d];
        oa[i] = s_do[(rg * 4 + i) * kS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = s_k[(cg + 16 * j) * kS + d];
        vb[j] = s_v[(cg + 16 * j) * kS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const float row_lse = s_lse[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const bool ok = s_mask[c] > 0.f && row_lse > kNegInf / 2 &&
                        (!causal || k0 + c <= q0 + r);
        const float p = ok ? expf(s[i][j] * scale - row_lse) : 0.f;
        s_ds[r * kPStride + c] = p * (dp[i][j] - s_delta[r]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < kTile; ++c) {
      float sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = s_ds[(rg * 4 + i) * kPStride + c];
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) {
        const float kb = s_k[c * kS + cg + 16 * dd];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][dd] = fmaf(sa[i], kb, dqa[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi < t_len) {
      const size_t row = (static_cast<size_t>(b) * t_len + qi) * hq + h;
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) dq[row * HD + cg + 16 * dd] = dqa[i][dd];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma, TMA, mbarriers
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRow = 128;         // bytes of one swizzled smem row: 64 bf16
constexpr int kGroup = 8 * kRow;  // 8 rows: the period of the 128-byte swizzle
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats to a bf16x2 register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the phase with parity `parity`. A wait of
// more than 2^28 polls (seconds) traps, so a lost copy fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Rows row0 .. row0+ROWS-1 of one head of a [B, len, heads, HD] tensor:
// HD/64 boxes of [ROWS][64] bf16, one after the other from `dst`.
template <int HD, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row0,
                                         int b) {
#pragma unroll
  for (int x = 0; x < HD / 64; ++x) {
    tma_load(dst + x * ROWS * kRow, map, bar, 64 * x, head, row0, b);
  }
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle. A K-major
// operand (rows of 64 contiguous bf16 along K) reads only sbo, the
// stride between groups of 8 rows. An MN-major operand (rows along K, 64
// contiguous bf16 along M or N) reads lbo, the stride between 64-wide
// boxes along M or N, and sbo, the stride between groups of 8 K-rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// K-step `ks` (16 columns of the contraction) of a K-major tile whose
// boxes hold ROWS rows; `tile` may point at a 64-row slice of box 0.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return desc(tile + (ks / 4) * ROWS * kRow + (ks % 4) * 32, 16, kGroup);
}

// K-step `kk` (16 rows of the contraction) of an MN-major B operand: a
// tile of ROWS K-rows whose N columns span its 64-wide boxes.
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * kRow, ROWS * kRow, kGroup);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the asm statements around it.
template <int N>
__device__ __forceinline__ void fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// An m64nNk16 accumulator (N/2 floats a thread) as bf16 A fragments of
// the next product, one [4] per 16 columns: the accumulator's layout for
// 16 columns is the A operand's layout for 16 contraction elements.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&acc)[N],
                                           uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
    }
  }
}

// lse of a row in log2 units, or +inf for a row that attends nothing
// (lse -1e30) or lies past T, so that 2^(s - lse2) is 0 there.
__device__ __forceinline__ float lse2_of(const float* __restrict__ lse,
                                         size_t at, bool in_range) {
  if (!in_range) return inf();
  const float x = lse[at];
  return x > kNegInf / 2 ? x * kLog2e : inf();
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16. wgmma_ss: A and B from
// shared memory, both K-major; `accumulate` 0 overwrites d. wgmma_rs: A
// from registers, B MN-major from shared memory (transpose bit set).

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory of the forward: Q, two K and two V stages (128 rows
// each), key flags of each stage, mbarriers q_full, k_full[2],
// v_full[2], empty[2].
template <int HD>
struct FwdLayout {
  static constexpr int kBQ = 128, kBK = 128;
  static constexpr int kTileBytes = 128 * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + 2 * kTileBytes;
  static constexpr int kFlags = kV + 2 * kTileBytes;
  static constexpr int kBars = kFlags + 2 * kBK * 4;
  static constexpr int kBytes = kBars + 7 * 8 + 1024;  // + room to align
};

// Warps 0-7: two consumer warpgroups of 64 query rows; warp 8: producer.
template <int HD>
__global__ void __launch_bounds__(288, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ kvm,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int batch, int t_len, int s_len,
                    int hq, int group, int causal, float scale) {
  using L = FwdLayout<HD>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* flags = reinterpret_cast<float*>(smem + L::kFlags);
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (3 + s); };
  auto empty = [&](int s) { return q_full + 8 * (5 + s); };

  // Query heads fastest (a kv head's G heads side by side), then batch,
  // then query tiles from the last (the heaviest under causal) down.
  const int n_qt = (t_len + kBQ - 1) / kBQ;
  const int h = blockIdx.x % hq;
  const int b = (blockIdx.x / hq) % batch;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / (hq * batch)) *
                 kBQ;
  const int hk = h / group;
  const int k_end = causal ? min(s_len, q0 + kBQ) : s_len;
  const int n_kt = (k_end + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 32);  // the producer's 32 lanes (key flags)
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      mbar_arrive_tx(q_full, L::kTileBytes);
      tma_tile<HD, kBQ>(base + L::kQ, &tm_q, q_full, h, q0, b);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt & 1;
      const int k0 = kt * kBK;
      if (kt >= 2) mbar_wait(empty(s), ((kt >> 1) - 1) & 1);
#pragma unroll
      for (int e = 0; e < kBK / 32; ++e) {
        const int c = lane * (kBK / 32) + e;
        flags[s * kBK + c] = key_ok(kvm, b, k0 + c, s_len);
      }
      if (lane == 0) {
        mbar_arrive_tx(k_full(s), L::kTileBytes);
        tma_tile<HD, kBK>(base + L::kK + s * L::kTileBytes, &tm_k, k_full(s),
                          hk, k0, b);
        mbar_arrive_tx(v_full(s), L::kTileBytes);
        tma_tile<HD, kBK>(base + L::kV + s * L::kTileBytes, &tm_v, v_full(s),
                          hk, k0, b);
      } else {
        mbar_arrive(k_full(s));
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;  // rows r0, r0+8 of the 64
  const int cq = 2 * (lane % 4);  // columns cq, cq+1 of each 8-column block
  const int row_lo = q0 + 64 * wg;  // the warpgroup's first query row
  const float sl2 = scale * kLog2e;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-inf(), -inf()}, l[2] = {0.f, 0.f};
  const uint32_t q_tile = base + L::kQ + 64 * wg * kRow;
  mbar_wait(q_full, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1;
    const uint32_t ph = (kt >> 1) & 1;
    const int k0 = kt * kBK;
    const uint32_t k_tile = base + L::kK + s * L::kTileBytes;
    const uint32_t v_tile = base + L::kV + s * L::kTileBytes;

    // S = Q.K^T
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full(s), ph);
    __syncwarp();
    fence(sc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      wgmma_ss(sc, kmajor<kBQ>(q_tile, ks), kmajor<kBK>(k_tile, ks), ks);
    }
    wg_commit();
    wg_wait0();
    fence(sc);

    // Scale to log2 units; mask diagonal, ragged and kv-masked tiles.
    const bool edge = kvm != nullptr || k0 + kBK > s_len ||
                      (causal && k0 + kBK - 1 > row_lo);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float2 f = make_float2(1.f, 1.f);
      if (edge) {
        f = *reinterpret_cast<const float2*>(flags + s * kBK + 8 * j + cq);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          x *= sl2;
          if (edge) {
            const int key = k0 + 8 * j + cq + e;
            const bool ok = (e ? f.y : f.x) > 0.f &&
                            (!causal || key <= row_lo + r0 + 8 * i);
            if (!ok) x = -inf();
          }
        }
      }
    }

    // Online softmax; a row with nothing unmasked yet keeps m = -inf and
    // takes its exponents against 0, so its p and corr are 0.
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -inf();
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -inf() ? 0.f : m_new;
      corr[i] = ex2(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(sc[4 * j + 2 * i + e] - m_use);
          sc[4 * j + 2 * i + e] = p;
          sum += p;
        }
      }
      l[i] = l[i] * corr[i] + sum;  // this thread's share of the row
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= corr[i];
        o[4 * j + 2 * i + 1] *= corr[i];
      }
    }

    // O += P.V, P in registers as bf16.
    uint32_t pf[kBK / 16][4];
    to_a_frags(sc, pf);
    mbar_wait(v_full(s), ph);
    __syncwarp();
    fence(o);
    fence(pf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_rs(o, pf[kk], mnmajor<kBK>(v_tile, kk));
    }
    wg_commit();
    wg_wait0();
    fence(o);
    fence(pf);
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const bool valid = m[i] != -inf();
    const float inv = valid ? 1.f / lt : 0.f;
    const int qi = row_lo + r0 + 8 * i;
    if (qi < t_len) {
      __nv_bfloat16* row =
          out + ((static_cast<size_t>(b) * t_len + qi) * hq + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(row + 8 * j + cq) = pack_bf16(
            o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
      if (lane % 4 == 0) {
        lse[(static_cast<size_t>(b) * hq + h) * t_len + qi] =
            valid ? (m[i] + log2f(lt)) * kLn2 : kNegInf;
      }
    }
  }
}

// Shared memory of the dk/dv kernel: the CTA's K and V tiles, two Q and
// two dO stages (64 rows each), each stage's query stats (64 lse in log2
// units, 64 delta), mbarriers kv_full, full[2], empty[2].
template <int HD>
struct DkdvLayout {
  static constexpr int kT = 64 * HD * 2;
  static constexpr int kK = 0, kV = kT, kQ = 2 * kT, kDO = 4 * kT;
  static constexpr int kStats = 6 * kT;
  static constexpr int kBars = kStats + 2 * 128 * 4;
  static constexpr int kBytes = kBars + 5 * 8 + 1024;
};

// Warps 0-3: one consumer warpgroup of 64 keys; warp 4: producer.
template <int HD>
__global__ void __launch_bounds__(160, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ kvm,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int batch, int t_len,
                         int s_len, int hq, int hkv, int group, int causal,
                         float scale) {
  using L = DkdvLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  const uint32_t kv_full = base + L::kBars;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (3 + s); };

  // kv heads fastest, then batch, then key tiles from the first (which
  // every query tile sees under causal: the heaviest) up.
  const int hk = blockIdx.x % hkv;
  const int b = (blockIdx.x / hkv) % batch;
  const int k0 = static_cast<int>(blockIdx.x) / (hkv * batch) * 64;
  const int n_qt = (t_len + 63) / 64;
  const int q_begin = causal ? k0 : 0;  // the first query that sees k0
  const int qt0 = q_begin < t_len ? q_begin / 64 : n_qt;
  const int per_head = n_qt - qt0;
  const int n_it = group * per_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 32);  // the producer's 32 lanes (query stats)
      mbar_init(empty(s), 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * L::kT);
      tma_tile<HD, 64>(base + L::kK, &tm_k, kv_full, hk, k0, b);
      tma_tile<HD, 64>(base + L::kV, &tm_v, kv_full, hk, k0, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it & 1;
      const int h = hk * group + it / per_head;
      const int q0 = (qt0 + it % per_head) * 64;
      if (it >= 2) mbar_wait(empty(s), ((it >> 1) - 1) & 1);
      float* st = stats + s * 128;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * lane + e;
        const int qi = q0 + c;
        const size_t at = (static_cast<size_t>(b) * hq + h) * t_len + qi;
        st[c] = lse2_of(lse, at, qi < t_len);
        st[64 + c] = qi < t_len ? delta[at] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(full(s), 2 * L::kT);
        tma_tile<HD, 64>(base + L::kQ + s * L::kT, &tm_q, full(s), h, q0, b);
        tma_tile<HD, 64>(base + L::kDO + s * L::kT, &tm_do, full(s), h, q0,
                         b);
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  const int r0 = 16 * warp + lane / 4;  // key rows r0, r0+8 of the 64
  const int cq = 2 * (lane % 4);  // query columns cq, cq+1 of each block
  const float sl2 = scale * kLog2e;
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kok[i] = key_ok(kvm, b, k0 + r0 + 8 * i, s_len) > 0.f;
  }
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  const uint32_t k_tile = base + L::kK, v_tile = base + L::kV;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1;
    const uint32_t ph = (it >> 1) & 1;
    const int q0 = (qt0 + it % per_head) * 64;
    const uint32_t q_tile = base + L::kQ + s * L::kT;
    const uint32_t do_tile = base + L::kDO + s * L::kT;
    const float* st = stats + s * 128;

    // S^T = K.Q^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(full(s), ph);
    __syncwarp();
    fence(sc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      wgmma_ss(sc, kmajor<64>(k_tile, ks), kmajor<64>(q_tile, ks), ks);
    }
    wg_commit();
    wg_wait0();
    fence(sc);

    // P^T, masked where a key is past S or kv-masked, or above the
    // diagonal; rows past T or fully masked carry lse2 = +inf, so p = 0.
    const bool diag = causal && k0 + 63 > q0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + cq);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * j + cq + e;
          const bool ok = kok[i] && (!diag || k0 + r0 + 8 * i <= qi);
          float& x = sc[4 * j + 2 * i + e];
          x = ok ? ex2(x * sl2 - (e ? l2.y : l2.x)) : 0.f;
        }
      }
    }

    // dV += P^T.dO and dP^T = V.dO^T, in one batch.
    uint32_t pf[4][4];
    to_a_frags(sc, pf);
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    fence(dva);
    fence(dp);
    fence(pf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(dva, pf[kk], mnmajor<64>(do_tile, kk));
    }
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      wgmma_ss(dp, kmajor<64>(v_tile, ks), kmajor<64>(do_tile, ks), ks);
    }
    wg_commit();
    wg_wait0();
    fence(dva);
    fence(dp);
    fence(pf);

    // dS^T = P^T * (dP^T - delta) * scale; dK += dS^T.Q
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(st + 64 + 8 * j + cq);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * i + e;
          sc[idx] = sc[idx] * (dp[idx] - (e ? dl.y : dl.x)) * scale;
        }
      }
    }
    uint32_t dsf[4][4];
    to_a_frags(sc, dsf);
    fence(dka);
    fence(dsf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(dka, dsf[kk], mnmajor<64>(q_tile, kk));
    }
    wg_commit();
    wg_wait0();
    fence(dka);
    fence(dsf);
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + r0 + 8 * i;
    if (kj < s_len) {
      const size_t row =
          ((static_cast<size_t>(b) * s_len + kj) * hkv + hk) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + row + 8 * j + cq) =
            pack_bf16(dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * j + cq) =
            pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    }
  }
}

// Shared memory of the dq kernel: Q and dO (64 rows), two K and two V
// stages (64 rows each), key flags of each stage, mbarriers qdo_full,
// k_full[2], v_full[2], empty[2].
template <int HD>
struct DqLayout {
  static constexpr int kT = 64 * HD * 2;
  static constexpr int kQ = 0, kDO = kT, kK = 2 * kT, kV = 4 * kT;
  static constexpr int kFlags = 6 * kT;
  static constexpr int kBars = kFlags + 2 * 64 * 4;
  static constexpr int kBytes = kBars + 7 * 8 + 1024;
};

// Warps 0-3: one consumer warpgroup of 64 query rows; warp 4: producer.
template <int HD>
__global__ void __launch_bounds__(160, 2)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ kvm,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int batch, int t_len,
                       int s_len, int hq, int group, int causal,
                       float scale) {
  using L = DqLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* flags = reinterpret_cast<float*>(smem + L::kFlags);
  const uint32_t qdo_full = base + L::kBars;
  auto k_full = [&](int s) { return qdo_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return qdo_full + 8 * (3 + s); };
  auto empty = [&](int s) { return qdo_full + 8 * (5 + s); };

  const int n_qt = (t_len + 63) / 64;
  const int h = blockIdx.x % hq;
  const int b = (blockIdx.x / hq) % batch;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / (hq * batch)) * 64;
  const int hk = h / group;
  const int k_end = causal ? min(s_len, q0 + 64) : s_len;
  const int n_kt = (k_end + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 32);  // the producer's 32 lanes (key flags)
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      mbar_arrive_tx(qdo_full, 2 * L::kT);
      tma_tile<HD, 64>(base + L::kQ, &tm_q, qdo_full, h, q0, b);
      tma_tile<HD, 64>(base + L::kDO, &tm_do, qdo_full, h, q0, b);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt & 1;
      const int k0 = kt * 64;
      if (kt >= 2) mbar_wait(empty(s), ((kt >> 1) - 1) & 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * lane + e;
        flags[s * 64 + c] = key_ok(kvm, b, k0 + c, s_len);
      }
      if (lane == 0) {
        mbar_arrive_tx(k_full(s), L::kT);
        tma_tile<HD, 64>(base + L::kK + s * L::kT, &tm_k, k_full(s), hk, k0, b);
        mbar_arrive_tx(v_full(s), L::kT);
        tma_tile<HD, 64>(base + L::kV + s * L::kT, &tm_v, v_full(s), hk, k0, b);
      } else {
        mbar_arrive(k_full(s));
      }
    }
    return;
  }

  const int r0 = 16 * warp + lane / 4;  // query rows r0, r0+8 of the 64
  const int cq = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    const size_t at = (static_cast<size_t>(b) * hq + h) * t_len + qi;
    lse2[i] = lse2_of(lse, at, qi < t_len);
    dl[i] = qi < t_len ? delta[at] : 0.f;
  }
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  const uint32_t q_tile = base + L::kQ, do_tile = base + L::kDO;
  mbar_wait(qdo_full, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1;
    const uint32_t ph = (kt >> 1) & 1;
    const int k0 = kt * 64;
    const uint32_t k_tile = base + L::kK + s * L::kT;
    const uint32_t v_tile = base + L::kV + s * L::kT;

    // S = Q.K^T and dP = dO.V^T
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = 0.f;
      dp[i] = 0.f;
    }
    mbar_wait(k_full(s), ph);
    __syncwarp();
    fence(sc);
    fence(dp);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      wgmma_ss(sc, kmajor<64>(q_tile, ks), kmajor<64>(k_tile, ks), ks);
    }
    mbar_wait(v_full(s), ph);
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      wgmma_ss(dp, kmajor<64>(do_tile, ks), kmajor<64>(v_tile, ks), ks);
    }
    wg_commit();
    wg_wait0();
    fence(sc);
    fence(dp);

    // dS = P * (dP - delta) * scale
    const bool edge = kvm != nullptr || k0 + 64 > s_len ||
                      (causal && k0 + 63 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 f = make_float2(1.f, 1.f);
      if (edge) {
        f = *reinterpret_cast<const float2*>(flags + s * 64 + 8 * j + cq);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * i + e;
          const int key = k0 + 8 * j + cq + e;
          const bool ok = !edge || ((e ? f.y : f.x) > 0.f &&
                                    (!causal || key <= q0 + r0 + 8 * i));
          const float p = ok ? ex2(sc[idx] * sl2 - lse2[i]) : 0.f;
          sc[idx] = p * (dp[idx] - dl[i]) * scale;
        }
      }
    }

    // dQ += dS.K
    uint32_t dsf[4][4];
    to_a_frags(sc, dsf);
    fence(dqa);
    fence(dsf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(dqa, dsf[kk], mnmajor<64>(k_tile, kk));
    }
    wg_commit();
    wg_wait0();
    fence(dqa);
    fence(dsf);
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    if (qi < t_len) {
      __nv_bfloat16* row =
          dq + ((static_cast<size_t>(b) * t_len + qi) * hq + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(row + 8 * j + cq) =
            pack_bf16(dqa[4 * j + 2 * i], dqa[4 * j + 2 * i + 1]);
      }
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Dims {
  int batch, t_len, s_len, hq, hkv, causal;
  float scale;
};

// Kernels above 48 KB of shared memory must opt in before each launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [B, len, heads, hd] tensor: dims {hd, heads,
// len, B}, boxes of 64 columns x 1 head x `rows` rows, 128-byte swizzle,
// out-of-range rows read as zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int hd, int heads,
                       int len, int batch, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads,
                                 row_bytes * heads * len};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int HD>
cudaError_t fwd_f32(const void* q, const void* k, const void* v,
                    const float* kvm, void* out, float* lse, Dims d,
                    cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<HD>;
  const size_t smem = fwd_smem<HD>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(d.t_len, kTile), d.hq, d.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kvm, static_cast<float*>(out), lse,
      d.t_len, d.s_len, d.hq, d.hkv, d.hq / d.hkv, d.causal, d.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v,
                     const float* kvm, void* out, float* lse, Dims d,
                     cudaStream_t stream) {
  using L = tc::FwdLayout<HD>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = tensor_map(&tq, q, HD, d.hq, d.t_len, d.batch, L::kBQ)) ||
      (err = tensor_map(&tk, k, HD, d.hkv, d.s_len, d.batch, L::kBK)) ||
      (err = tensor_map(&tv, v, HD, d.hkv, d.s_len, d.batch, L::kBK))) {
    return err;
  }
  auto kernel = tc::flash_fwd_tc_kernel<HD>;
  if ((err = allow_smem(kernel, L::kBytes)) != cudaSuccess) return err;
  const int grid = cdiv(d.t_len, L::kBQ) * d.hq * d.batch;
  kernel<<<grid, 288, L::kBytes, stream>>>(
      tq, tk, tv, kvm, static_cast<__nv_bfloat16*>(out), lse, d.batch,
      d.t_len, d.s_len, d.hq, d.hq / d.hkv, d.causal, d.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd_delta(const void* out, const void* dout, float* delta, Dims d,
                      cudaStream_t stream) {
  const int rows = d.batch * d.t_len * d.hq;
  const int warps_per_block = kThreads / 32;
  flash_bwd_delta_kernel<T, HD>
      <<<cdiv(rows, warps_per_block), kThreads, 0, stream>>>(
          static_cast<const T*>(out), static_cast<const T*>(dout), delta,
          rows, d.t_len, d.hq);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_f32(const void* q, const void* k, const void* v,
                    const float* kvm, const void* out, const void* dout,
                    const float* lse, float* delta, void* dq, void* dk,
                    void* dv, Dims d, cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const int group = d.hq / d.hkv;
  cudaError_t err = bwd_delta<float, HD>(out, dout, delta, d, stream);
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<HD>;
  if ((err = allow_smem(dkdv, dkdv_smem<HD>())) != cudaSuccess) return err;
  const dim3 grid_kv(cdiv(d.s_len, kTile), d.hkv, d.batch);
  dkdv<<<grid_kv, kThreads, dkdv_smem<HD>(), stream>>>(
      qp, kp, vp, kvm, dop, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), d.t_len, d.s_len, d.hq, d.hkv, group,
      d.causal, d.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<HD>;
  if ((err = allow_smem(dqk, dq_smem<HD>())) != cudaSuccess) return err;
  const dim3 grid_q(cdiv(d.t_len, kTile), d.hq, d.batch);
  dqk<<<grid_q, kThreads, dq_smem<HD>(), stream>>>(
      qp, kp, vp, kvm, dop, lse, delta, static_cast<float*>(dq), d.t_len,
      d.s_len, d.hq, d.hkv, group, d.causal, d.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const float* kvm, const void* out, const void* dout,
                     const float* lse, float* delta, void* dq, void* dk,
                     void* dv, Dims d, cudaStream_t stream) {
  cudaError_t err = bwd_delta<__nv_bfloat16, HD>(out, dout, delta, d, stream);
  if (err != cudaSuccess) return err;
  // Both kernels read 64-row tiles of every tensor.
  CUtensorMap tq, tk, tv, tdo;
  if ((err = tensor_map(&tq, q, HD, d.hq, d.t_len, d.batch, 64)) ||
      (err = tensor_map(&tk, k, HD, d.hkv, d.s_len, d.batch, 64)) ||
      (err = tensor_map(&tv, v, HD, d.hkv, d.s_len, d.batch, 64)) ||
      (err = tensor_map(&tdo, dout, HD, d.hq, d.t_len, d.batch, 64))) {
    return err;
  }
  const int group = d.hq / d.hkv;

  auto dkdv = tc::flash_bwd_dkdv_tc_kernel<HD>;
  constexpr int dkdv_bytes = tc::DkdvLayout<HD>::kBytes;
  if ((err = allow_smem(dkdv, dkdv_bytes)) != cudaSuccess) return err;
  dkdv<<<cdiv(d.s_len, 64) * d.hkv * d.batch, 160, dkdv_bytes, stream>>>(
      tq, tk, tv, tdo, kvm, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), d.batch, d.t_len, d.s_len, d.hq,
      d.hkv, group, d.causal, d.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dqk = tc::flash_bwd_dq_tc_kernel<HD>;
  constexpr int dq_bytes = tc::DqLayout<HD>::kBytes;
  if ((err = allow_smem(dqk, dq_bytes)) != cudaSuccess) return err;
  dqk<<<cdiv(d.t_len, 64) * d.hq * d.batch, 160, dq_bytes, stream>>>(
      tq, tk, tv, tdo, kvm, lse, delta, static_cast<__nv_bfloat16*>(dq),
      d.batch, d.t_len, d.s_len, d.hq, group, d.causal, d.scale);
  return cudaGetLastError();
}

bool dims_ok(const Dims& d, int hd) {
  // The bf16 grids are 1-D: tiles x heads x batch must fit in an int.
  const long long tiles = (static_cast<long long>(d.t_len) + 63) / 64;
  return d.batch > 0 && d.t_len > 0 && d.s_len > 0 && d.hq > 0 &&
         d.hkv > 0 && d.hq % d.hkv == 0 && d.batch <= 65535 &&
         d.hq <= 65535 && d.hkv <= 65535 && (hd == 64 || hd == 128) &&
         tiles * d.hq * d.batch < (1ll << 31) &&
         (static_cast<long long>(d.s_len) + 63) / 64 * d.hkv * d.batch <
             (1ll << 31);
}

}  // namespace

// Plain C entry points for ctypes. dtype: 0 = f32 (CUDA cores), 1 = bf16
// (tensor cores). kv_mask may be null. Each returns the cudaError_t of its
// launches (0 = success); the caller raises on any other value. They
// launch on `stream`, do not synchronise and allocate nothing (delta is
// the caller's f32 [B, Hq, T] scratch).
extern "C" int kft_flash_fwd(const void* q, const void* k, const void* v,
                             const void* kv_mask, void* out, void* lse,
                             int batch, int t_len, int s_len, int hq, int hkv,
                             int hd, int causal, float scale, int dtype,
                             void* stream) {
  const Dims d{batch, t_len, s_len, hq, hkv, causal, scale};
  if (!dims_ok(d, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const float* kvm = static_cast<const float*>(kv_mask);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64) {
    err = fwd_f32<64>(q, k, v, kvm, out, lp, d, s);
  } else if (dtype == 0 && hd == 128) {
    err = fwd_f32<128>(q, k, v, kvm, out, lp, d, s);
  } else if (dtype == 1 && hd == 64) {
    err = fwd_bf16<64>(q, k, v, kvm, out, lp, d, s);
  } else if (dtype == 1 && hd == 128) {
    err = fwd_bf16<128>(q, k, v, kvm, out, lp, d, s);
  }
  return static_cast<int>(err);
}

extern "C" int kft_flash_bwd(const void* q, const void* k, const void* v,
                             const void* kv_mask, const void* out,
                             const void* dout, const void* lse, void* delta,
                             void* dq, void* dk, void* dv, int batch,
                             int t_len, int s_len, int hq, int hkv, int hd,
                             int causal, float scale, int dtype,
                             void* stream) {
  const Dims d{batch, t_len, s_len, hq, hkv, causal, scale};
  if (!dims_ok(d, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const float* kvm = static_cast<const float*>(kv_mask);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64) {
    err = bwd_f32<64>(q, k, v, kvm, out, dout, lp, dp, dq, dk, dv, d, s);
  } else if (dtype == 0 && hd == 128) {
    err = bwd_f32<128>(q, k, v, kvm, out, dout, lp, dp, dq, dk, dv, d, s);
  } else if (dtype == 1 && hd == 64) {
    err = bwd_bf16<64>(q, k, v, kvm, out, dout, lp, dp, dq, dk, dv, d, s);
  } else if (dtype == 1 && hd == 128) {
    err = bwd_bf16<128>(q, k, v, kvm, out, dout, lp, dp, dq, dk, dv, d, s);
  }
  return static_cast<int>(err);
}
