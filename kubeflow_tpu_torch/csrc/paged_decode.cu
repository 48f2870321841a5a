// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kubeflow_tpu/ops/attention.py:
// _paged_decode_pallas (body `kernel`, grid (B, Hkv, MB)). Same contract:
//   qg    [B, Hkv, G, hd]  query group of each kv head (bf16 or f32)
//   pools [N, Bs, Hkv, hd] bf16/f32, or int8 codes + f32 scales [N, Bs, Hkv]
//   table [B, MB] int32    block table; entries >= N are unallocated
//                          sentinels and clamp to N-1
//   pos   [B] int32        row b attends virtual positions <= pos[b]
//   out   [B, Hkv, G, hd]  f32; a row whose keys are all masked writes 0.
// Scores, softmax and accumulation run in f32 with an online softmax
// (m, l, acc), exactly the TPU kernel's arithmetic; only the order of the
// dot-product sums differs.
//
// Design. The TPU grid's sequential table axis becomes a loop inside one
// CTA per (row, kv head): CTAs run in parallel in no order, so nothing can
// be carried between them. The CTA has hd threads; thread d owns output
// dimension d of every query row of the group. Each table column's K and V
// tiles [Bs, hd] are staged in shared memory (dequantized to f32 on the
// way) and shared by the G query rows; one warp per (g, t) pair reduces a
// score with shuffles, and every thread then applies the same online-
// softmax update to its own column of acc.
//
// Bound on the H100: bytes. The kernel must read 2 · Σ_b live_b · Hkv · hd
// · bytes of K/V (live_b = min(pos_b + 1, MB·Bs)), plus the scales for
// int8 pools, and does 4 · G flops per K/V element read: far below the
// card's ~295 operations per byte, so the least time is those bytes over
// 3.35 TB/s. This first version is simple, not fast: one element per
// thread per load, no cp.async/TMA, no split over the KV axis
// (flash-decoding), so small batches leave most SMs idle. Those are later
// work; PERF.md carries its measured time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 8;
constexpr int kMaxBlock = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename QT, typename KVT, bool kQuant, int HD>
__global__ void __launch_bounds__(HD)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                    const KVT* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table, const int* __restrict__ pos,
                    float* __restrict__ out, int hkv, int group, int n_blocks,
                    int bs, int mb, float sm_scale) {
  constexpr int kWarps = HD / 32;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;

  __shared__ float q_s[kMaxGroup][HD];
  __shared__ float k_s[kMaxBlock][HD];
  __shared__ float v_s[kMaxBlock][HD];
  __shared__ float s_s[kMaxGroup * kMaxBlock];

  const size_t q_base = (static_cast<size_t>(b) * hkv + h) * group;
  for (int g = 0; g < group; ++g) {
    q_s[g][d] = to_f32(q[(q_base + g) * HD + d]);
  }

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  const int p = pos[b];
  // Columns wholly past pos[b] hold only masked keys. Once column 0 is
  // live (p >= 0) every m is finite, so such a column gives p = exp(-1e30
  // - m) = 0 and corr = 1: skipping it is exact. p < 0 walks nothing and
  // leaves m at -1e30, which writes 0 below, as the TPU kernel does.
  const int cols = p < 0 ? 0 : min(mb, p / bs + 1);
  for (int j = 0; j < cols; ++j) {
    // Sentinel entries clamp to the last block (the TPU kernel's _blk);
    // an unclamped id would read past the pool. The span mask hides
    // whatever the clamped block holds.
    int blk = table[static_cast<size_t>(b) * mb + j];
    blk = max(0, min(blk, n_blocks - 1));
    __syncthreads();  // the previous column's readers are done
    for (int t = 0; t < bs; ++t) {
      const size_t row = (static_cast<size_t>(blk) * bs + t) * hkv + h;
      float kv = to_f32(k_pool[row * HD + d]);
      float vv = to_f32(v_pool[row * HD + d]);
      if (kQuant) {
        kv *= k_scale[row];
        vv *= v_scale[row];
      }
      k_s[t][d] = kv;
      v_s[t][d] = vv;
    }
    __syncthreads();
    for (int pi = warp; pi < group * bs; pi += kWarps) {
      const int g = pi / bs;
      const int t = pi - g * bs;
      float sum = 0.f;
#pragma unroll
      for (int dd = lane; dd < HD; dd += 32) sum += q_s[g][dd] * k_s[t][dd];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      if (lane == 0) {
        s_s[pi] = (j * bs + t <= p) ? sum * sm_scale : kNegInf;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        const float* s = s_s + g * bs;
        float m_new = m[g];
        for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, s[t]);
        const float corr = expf(m[g] - m_new);
        float l_add = 0.f;
        float a_add = 0.f;
        for (int t = 0; t < bs; ++t) {
          const float pr = expf(s[t] - m_new);
          l_add += pr;
          a_add += pr * v_s[t][d];
        }
        l[g] = l[g] * corr + l_add;
        acc[g] = acc[g] * corr + a_add;
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      const float den = l[g] == 0.f ? 1.f : l[g];
      out[(q_base + g) * HD + d] = m[g] > kNegInf / 2 ? acc[g] / den : 0.f;
    }
  }
}

template <typename QT, typename KVT, bool kQuant>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const int* table,
                      const int* pos, float* out, int batch, int hkv,
                      int group, int n_blocks, int bs, int mb, float sm_scale,
                      cudaStream_t stream) {
  const dim3 grid(batch, hkv);
  const QT* qp = static_cast<const QT*>(q);
  const KVT* kp = static_cast<const KVT*>(k);
  const KVT* vp = static_cast<const KVT*>(v);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  if (hd == 64) {
    paged_decode_kernel<QT, KVT, kQuant, 64><<<grid, 64, 0, stream>>>(
        qp, kp, vp, ksp, vsp, table, pos, out, hkv, group, n_blocks, bs, mb,
        sm_scale);
  } else if (hd == 128) {
    paged_decode_kernel<QT, KVT, kQuant, 128><<<grid, 128, 0, stream>>>(
        qp, kp, vp, ksp, vsp, table, pos, out, hkv, group, n_blocks, bs, mb,
        sm_scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, int hd, const void* q, const void* k,
                      const void* v, const void* ks, const void* vs,
                      const int* table, const int* pos, float* out, int batch,
                      int hkv, int group, int n_blocks, int bs, int mb,
                      float sm_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_hd<QT, float, false>(hd, q, k, v, ks, vs, table, pos, out,
                                         batch, hkv, group, n_blocks, bs, mb,
                                         sm_scale, stream);
    case 1:
      return launch_hd<QT, __nv_bfloat16, false>(
          hd, q, k, v, ks, vs, table, pos, out, batch, hkv, group, n_blocks,
          bs, mb, sm_scale, stream);
    case 2:
      return launch_hd<QT, int8_t, true>(hd, q, k, v, ks, vs, table, pos, out,
                                         batch, hkv, group, n_blocks, bs, mb,
                                         sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Type codes: 0 = f32, 1 = bf16, 2 = int8
// (pools only; scales then point at the f32 [N, Bs, Hkv] arrays). Returns
// the cudaError_t of the launch (0 = success); the caller raises on any
// other value. Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int kft_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* table,
                                const void* pos, void* out, int batch, int hkv,
                                int group, int hd, int n_blocks, int bs,
                                int mb, float sm_scale, int q_dtype,
                                int kv_dtype, void* stream) {
  if (batch <= 0 || hkv <= 0 || group <= 0 || group > kMaxGroup || bs <= 0 ||
      bs > kMaxBlock || mb <= 0 || n_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* tp = static_cast<const int*>(table);
  const int* pp = static_cast<const int*>(pos);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0:
      err = launch_kv<float>(kv_dtype, hd, q, k_pool, v_pool, k_scale,
                             v_scale, tp, pp, op, batch, hkv, group, n_blocks,
                             bs, mb, sm_scale, s);
      break;
    case 1:
      err = launch_kv<__nv_bfloat16>(kv_dtype, hd, q, k_pool, v_pool, k_scale,
                                     v_scale, tp, pp, op, batch, hkv, group,
                                     n_blocks, bs, mb, sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
