// GQA flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels kubeflow_tpu/ops/attention.py:
// _splash_flash / _splash_kernel (JAX's splash attention, GQA-native,
// fused backward, causal block skipping) and _pallas_flash (JAX's TPU
// flash attention, MHA with K/V broadcast to the query heads). Both compute
// the math of the reference _flash_fwd_xla / _flash_bwd_xla; one set of
// kernels serves both names, GQA-native, with no broadcast of K/V.
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
// Kernels (at most four, as the TPU pair is a forward and a fused
// backward):
//   flash_fwd_kernel        one CTA per (query tile, query head, batch): an
//                           online softmax over key tiles up to the causal
//                           limit; tiles wholly above the diagonal are never
//                           read, as splash skips them.
//   flash_bwd_delta_kernel  delta = rowsum(dout * out), one warp a row.
//   flash_bwd_dkdv_kernel   one CTA per (key tile, kv head, batch): loops
//                           over the G query heads of the group and the
//                           query tiles from the diagonal down, accumulates
//                           dk and dv in f32 registers and writes them once:
//                           no atomics, GQA native, bit-for-bit repeatable.
//   flash_bwd_dq_kernel     one CTA per (query tile, query head, batch).
// Every tile is 64 rows; 256 threads hold a 4 x 4 score micro-tile and a
// 4 x (D/16) output micro-tile each. Tiles are staged in shared memory as
// f32 (rows padded to D+1 floats so column reads do not conflict), so one
// code path serves bf16 and f32, and all arithmetic is f32 FMAs.
//
// Bound on the H100: operations. Causal attention at B=4, T=S=2048,
// Hq=32, D=128 does 4*D flops per attended (query, key) pair forward
// (1.37e11) and 10*D backward (QK^T recompute, dP, dV, dK, dQ) against
// ~30 MB of bytes per pass: thousands of flops per byte, so the least
// time is flops over the bf16 tensor-core peak (989 TFLOP/s): ~0.14 ms
// forward, ~0.35 ms backward. This first version is simple, not fast: it
// runs on the f32 CUDA cores (67 TFLOP/s peak), reads its operands from
// shared memory without cp.async/TMA, and the dq kernel recomputes S and
// dP beside the dkdv kernel. wgmma on bf16 tiles fed by TMA, with warp
// specialisation, is the later work that moves it toward the bound;
// PERF.md carries its measured time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kPStride = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int head, int row0, int len,
                                          int heads) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = row0 + r;
    float val = 0.f;
    if (row < len) {
      val = to_f32(
          src[((static_cast<size_t>(b) * len + row) * heads + head) * HD + d]);
    }
    dst[r * (HD + 1) + d] = val;
  }
}

// 1 for keys k0 .. k0+63 that exist and that kv_mask lets through.
__device__ __forceinline__ void load_key_mask(float* dst,
                                              const float* __restrict__ kvm,
                                              int b, int k0, int s_len) {
  if (threadIdx.x < kTile) {
    const int j = k0 + threadIdx.x;
    float ok = 0.f;
    if (j < s_len) {
      ok = (kvm == nullptr || kvm[static_cast<size_t>(b) * s_len + j] > 0.f)
               ? 1.f
               : 0.f;
    }
    dst[threadIdx.x] = ok;
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kvm,
                 T* __restrict__ out, float* __restrict__ lse, int t_len,
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

  load_tile<T, HD>(s_q, q, b, h, q0, t_len, hq);

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
    load_tile<T, HD>(s_k, k, b, hk, k0, s_len, hkv);
    load_tile<T, HD>(s_v, v, b, hk, k0, s_len, hkv);
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
        out[row * HD + cg + 16 * dd] =
            from_f32<T>(valid ? acc[i][dd] / l[i] : 0.f);
      }
      if (cg == 0) {
        lse[(static_cast<size_t>(b) * hq + h) * t_len + qi] =
            valid ? m[i] + logf(l[i]) : kNegInf;
      }
    }
  }
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ kvm,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int t_len, int s_len, int hq,
                      int hkv, int group, int causal, float scale) {
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

  load_tile<T, HD>(s_k, k, b, hk, k0, s_len, hkv);
  load_tile<T, HD>(s_v, v, b, hk, k0, s_len, hkv);
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
      load_tile<T, HD>(s_q, q, b, h, q0, t_len, hq);
      load_tile<T, HD>(s_do, dout, b, h, q0, t_len, hq);
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
        dk[row * HD + cg + 16 * dd] = from_f32<T>(dka[i][dd]);
        dv[row * HD + cg + 16 * dd] = from_f32<T>(dva[i][dd]);
      }
    }
  }
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (4 * kTile * (HD + 1) + kTile * kPStride + 3 * kTile);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ kvm,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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

  load_tile<T, HD>(s_q, q, b, h, q0, t_len, hq);
  load_tile<T, HD>(s_do, dout, b, h, q0, t_len, hq);
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
    load_tile<T, HD>(s_k, k, b, hk, k0, s_len, hkv);
    load_tile<T, HD>(s_v, v, b, hk, k0, s_len, hkv);
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
      for (int dd = 0; dd < kD; ++dd) {
        dq[row * HD + cg + 16 * dd] = from_f32<T>(dqa[i][dd]);
      }
    }
  }
}

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

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, const float* kvm,
                void* out, float* lse, Dims d, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  const size_t smem = fwd_smem<HD>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d.t_len + kTile - 1) / kTile, d.hq, d.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kvm, static_cast<T*>(out), lse, d.t_len,
      d.s_len, d.hq, d.hkv, d.hq / d.hkv, d.causal, d.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd(const void* q, const void* k, const void* v, const float* kvm,
                const void* out, const void* dout, const float* lse,
                float* delta, void* dq, void* dk, void* dv, Dims d,
                cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int group = d.hq / d.hkv;

  const int rows = d.batch * d.t_len * d.hq;
  const int warps_per_block = kThreads / 32;
  flash_bwd_delta_kernel<T, HD>
      <<<(rows + warps_per_block - 1) / warps_per_block, kThreads, 0,
         stream>>>(static_cast<const T*>(out), dop, delta, rows, d.t_len,
                   d.hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, HD>;
  err = allow_smem(dkdv, dkdv_smem<HD>());
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((d.s_len + kTile - 1) / kTile, d.hkv, d.batch);
  dkdv<<<grid_kv, kThreads, dkdv_smem<HD>(), stream>>>(
      qp, kp, vp, kvm, dop, lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), d.t_len, d.s_len, d.hq, d.hkv, group, d.causal,
      d.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, HD>;
  err = allow_smem(dqk, dq_smem<HD>());
  if (err != cudaSuccess) return err;
  const dim3 grid_q((d.t_len + kTile - 1) / kTile, d.hq, d.batch);
  dqk<<<grid_q, kThreads, dq_smem<HD>(), stream>>>(
      qp, kp, vp, kvm, dop, lse, delta, static_cast<T*>(dq), d.t_len,
      d.s_len, d.hq, d.hkv, group, d.causal, d.scale);
  return cudaGetLastError();
}

bool dims_ok(const Dims& d, int hd) {
  return d.batch > 0 && d.t_len > 0 && d.s_len > 0 && d.hq > 0 &&
         d.hkv > 0 && d.hq % d.hkv == 0 && d.batch <= 65535 &&
         d.hq <= 65535 && d.hkv <= 65535 && (hd == 64 || hd == 128);
}

}  // namespace

// Plain C entry points for ctypes. dtype: 0 = f32, 1 = bf16. kv_mask may
// be null. Each returns the cudaError_t of its launches (0 = success); the
// caller raises on any other value. They launch on `stream`, do not
// synchronise and allocate nothing (delta is the caller's f32 [B, Hq, T]
// scratch).
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
    err = fwd<float, 64>(q, k, v, kvm, out, lp, d, s);
  } else if (dtype == 0 && hd == 128) {
    err = fwd<float, 128>(q, k, v, kvm, out, lp, d, s);
  } else if (dtype == 1 && hd == 64) {
    err = fwd<__nv_bfloat16, 64>(q, k, v, kvm, out, lp, d, s);
  } else if (dtype == 1 && hd == 128) {
    err = fwd<__nv_bfloat16, 128>(q, k, v, kvm, out, lp, d, s);
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
    err = bwd<float, 64>(q, k, v, kvm, out, dout, lp, dp, dq, dk, dv, d, s);
  } else if (dtype == 0 && hd == 128) {
    err = bwd<float, 128>(q, k, v, kvm, out, dout, lp, dp, dq, dk, dv, d, s);
  } else if (dtype == 1 && hd == 64) {
    err = bwd<__nv_bfloat16, 64>(q, k, v, kvm, out, dout, lp, dp, dq, dk, dv,
                                 d, s);
  } else if (dtype == 1 && hd == 128) {
    err = bwd<__nv_bfloat16, 128>(q, k, v, kvm, out, dout, lp, dp, dq, dk,
                                  dv, d, s);
  }
  return static_cast<int>(err);
}
