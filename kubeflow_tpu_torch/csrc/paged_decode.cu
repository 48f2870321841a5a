// Paged single-token decode attention for Hopper (sm_90a), split over the
// KV axis (flash-decoding).
//
// Replaces the Pallas TPU kernel kubeflow_tpu/ops/attention.py:
// _paged_decode_pallas (body `kernel`, grid (B, Hkv, MB)). Same contract:
//   qg    [B, Hkv, G, hd]  query group of each kv head (bf16 or f32)
//   pools [N, Bs, Hkv, hd] bf16/f32, or int8 codes + f32 scales [N, Bs, Hkv]
//   table [B, MB] int32    block table; entries >= N are unallocated
//                          sentinels and clamp to N-1 (the TPU's _blk)
//   pos   [B] int32        row b attends virtual positions <= pos[b]
//   out   [B, Hkv, G, hd]  f32; a row whose keys are all masked writes 0.
// Scores, softmax and accumulation run in f32 with an online softmax
// (m, l, acc), the TPU kernel's arithmetic; the order of the sums differs.
//
// Bound on the H100: bytes. The kernel must read 2 · Σ_b live_b · Hkv · hd
// · bytes of K/V (live_b = min(pos_b + 1, MB·Bs)), plus the scales for
// int8 pools, and does about 4 · G operations per K/V element: far below
// the card's ~295 operations per byte. So the design is about bytes in
// flight and SMs kept busy, not about tensor cores (G <= 8 query rows per
// kv head is far below wgmma's 64-row tile).
//
// Design, against the four limits of a one-CTA-per-(row, head) walk:
//
// 1. SMs kept busy: the grid is (splits, Hkv, B). Each CTA covers a run
//    of `cps` table columns of one (row, kv head), so a batch of 8 rows
//    or a single long row still fills the card. A CTA whose run starts
//    past pos[b] returns at once. Each live CTA writes a partial (m, l,
//    acc[G, hd]) in f32 to a workspace; the last one of its (row, head)
//    to arrive (an int32 counter per pair, which it resets to 0) combines
//    the partials in split order, so the result does not depend on which
//    CTA ends last and is bitwise repeatable. A row with one live split
//    skips the workspace and writes its output directly.
// 2. Bytes in flight: a split's live positions are walked in chunks of
//    KS keys (8 KB of K and V a chunk, any Bs a multiple of 8). Each chunk
//    arrives by 16-byte cp.async.cg (neighbouring threads on neighbouring
//    addresses) into a 4-stage shared-memory ring, so three chunks are in
//    flight while one is computed. Block ids are clamped before any
//    address is formed, read once per CTA into shared memory; rows past
//    the live span are zero-filled (src-size 0), never read.
// 3. Arithmetic in registers: each lane owns 8 dims (two runs of 4) of
//    one key; hd/8 lanes hold a key, so a warp covers 256/hd keys a step.
//    A score is an 8-element partial dot product per lane and a butterfly
//    of log2(hd/8) shuffles. Each key group keeps its own online softmax
//    (m, l per query row; acc as the lane's 8 dims × G rows); the groups
//    of a warp merge by shuffles and the four warps in shared memory,
//    once per split, in a fixed order. int8 codes are dequantized by
//    their per-position scale after the dot product (the K scale) and
//    into p (the V scale). expf throughout, as the plain version.
// 4. No serial load/compute alternation: one __syncthreads a chunk, with
//    the loads of chunk c+3 started before chunk c is computed.
//
// int8 scales are read per position and head, 4 bytes each, beside the
// codes: the 32-byte sectors they sit in are what a contiguous [Bs, Hkv]
// read would bring in at Hkv = 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kChunkBytes = 4096;  // K (or V) bytes of one chunk
constexpr int kMaxGroup = 8;
constexpr int kMaxCols = 512;      // table columns of one split
constexpr int kMaxSplits = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements of a K/V row in shared memory, as f32.
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, float* x) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = static_cast<float>(static_cast<int8_t>((u >> (8 * k)) & 0xffu));
  }
}

template <typename QT, typename KVT, bool kQuant, int HD, int kG>
__global__ void __launch_bounds__(kThreads, kG > 2 ? 2 : 4)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                    const KVT* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table, const int* __restrict__ pos,
                    float* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ counters, int batch, int hkv, int group,
                    int n_blocks, int bs, int mb, int splits, int cps,
                    float sm_scale) {
  constexpr int kRowBytes = HD * static_cast<int>(sizeof(KVT));
  constexpr int kKeys = kChunkBytes / kRowBytes;   // keys a chunk
  constexpr int kVecs = kRowBytes / 16;            // 16-byte pieces a row
  constexpr int kLanes = HD / 8;                   // lanes a key
  constexpr int kKpw = 32 / kLanes;                // keys a warp step
  constexpr int kPasses = kKeys / (kWarps * kKpw);
  constexpr int kScaleOff = 2 * kChunkBytes;
  constexpr int kStageBytes = kScaleOff + (kQuant ? 8 * kKeys : 0);
  static_assert(kPasses >= 1 && kKeys * kVecs == 2 * kThreads, "tiling");
  static_assert(!kQuant || 2 * kKeys <= kThreads, "scale copies");
  static_assert(kWarps * kG * (HD + 2) * 4 <= kStages * kStageBytes,
                "warp merge scratch");
  static_assert(3 * kMaxSplits * kMaxGroup * 4 + 8 * kMaxGroup <=
                    kStages * kStageBytes,
                "split combine scratch");

  __shared__ __align__(16) char ring[kStages * kStageBytes];
  __shared__ int blk_s[kMaxCols];
  __shared__ int last_s;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / kLanes;   // key group within the warp
  const int li = lane % kLanes;    // lane within the key group
  const int d0 = 4 * li;           // this lane's dims: d0..d0+3 and
  const int d1 = HD / 2 + 4 * li;  //                  d1..d1+3
  const int bh = b * hkv + h;
  const size_t out_base = static_cast<size_t>(bh) * group * HD;

  const int p = pos[b];
  const int live_cols = p < 0 ? 0 : min(mb, p / bs + 1);
  const int n_live = (live_cols + cps - 1) / cps;  // live splits of the row
  if (split >= n_live) {
    if (n_live == 0 && split == 0) {  // pos < 0 attends nothing: zeros
      for (int e = tid; e < group * HD; e += kThreads) out[out_base + e] = 0.f;
    }
    return;
  }
  const int lo = split * cps * bs;
  const int hi = min(min(lo + cps * bs, p + 1), mb * bs);
  const int n_cols = (hi - lo + bs - 1) / bs;
  const int n_chunks = (hi - lo + kKeys - 1) / kKeys;

  for (int j = tid; j < n_cols; j += kThreads) {
    const int blk = table[static_cast<size_t>(b) * mb + split * cps + j];
    blk_s[j] = max(0, min(blk, n_blocks - 1));
  }

  float qr[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const size_t qb = (static_cast<size_t>(bh) * group + g) * HD;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qr[g][k] = g < group ? to_f32(q[qb + d0 + k]) : 0.f;
      qr[g][4 + k] = g < group ? to_f32(q[qb + d1 + k]) : 0.f;
    }
  }
  __syncthreads();  // blk_s

  const char* kbytes = reinterpret_cast<const char*>(k_pool);
  const char* vbytes = reinterpret_cast<const char*>(v_pool);
  auto load_chunk = [&](int c) {
    char* stage = ring + (c % kStages) * kStageBytes;
    const int base = lo + c * kKeys;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int v = tid + k * kThreads;
      const int r = v / kVecs;
      const int cv = v - r * kVecs;
      const int off = base + r - lo;
      const bool ok = base + r < hi;
      const int col = ok ? off / bs : 0;
      const int t = ok ? off - col * bs : 0;
      const size_t row =
          (static_cast<size_t>(blk_s[col]) * bs + t) * hkv + h;
      const size_t src = row * kRowBytes + cv * 16;
      const int dst = r * kRowBytes + cv * 16;
      cp_async16(stage + dst, kbytes + src, ok ? 16 : 0);
      cp_async16(stage + kChunkBytes + dst, vbytes + src, ok ? 16 : 0);
    }
    if (kQuant && tid < 2 * kKeys) {
      const int r = tid % kKeys;
      const int off = base + r - lo;
      const bool ok = base + r < hi;
      const int col = ok ? off / bs : 0;
      const int t = ok ? off - col * bs : 0;
      const size_t row =
          (static_cast<size_t>(blk_s[col]) * bs + t) * hkv + h;
      const float* src = (tid < kKeys ? k_scale : v_scale) + row;
      cp_async4(stage + kScaleOff + 4 * tid, src, ok ? 4 : 0);
    }
  };

  float m[kG], l[kG], acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) load_chunk(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; chunk c-1's slot is free
    if (c + kStages - 1 < n_chunks) load_chunk(c + kStages - 1);
    cp_async_commit();
    const char* stage = ring + (c % kStages) * kStageBytes;
    const float* scales = reinterpret_cast<const float*>(stage + kScaleOff);
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int r = (ps * kWarps + warp) * kKpw + grp;
      const bool valid = lo + c * kKeys + r < hi;
      const KVT* krow =
          reinterpret_cast<const KVT*>(stage + r * kRowBytes);
      const KVT* vrow =
          reinterpret_cast<const KVT*>(stage + kChunkBytes + r * kRowBytes);
      float kx[8], vx[8];
      load4(krow + d0, kx);
      load4(krow + d1, kx + 4);
      float s[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) a = fmaf(qr[g][j], kx[j], a);
        s[g] = a;
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
        }
      }
      load4(vrow + d0, vx);
      load4(vrow + d1, vx + 4);
      const float ks = kQuant ? scales[r] : 1.f;
      const float vs = kQuant ? scales[kKeys + r] : 1.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float x = (kQuant ? s[g] * ks : s[g]) * sm_scale;
        const float m_new = valid ? fmaxf(m[g], x) : m[g];
        const float corr = expf(m[g] - m_new);
        const float pr = valid ? expf(x - m_new) : 0.f;
        l[g] = l[g] * corr + pr;
        const float pv = kQuant ? pr * vs : pr;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(pv, vx[j], acc[g][j] * corr);
        m[g] = m_new;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes scratch

  // The key groups of a warp merge by shuffles (group 0 keeps the sum).
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = expf(m[g] - mx);
      const float w = expf(mo - mx);
      l[g] = l[g] * a + lo_ * w;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float other = __shfl_xor_sync(0xffffffffu, acc[g][j], o);
        acc[g][j] = acc[g][j] * a + other * w;
      }
      m[g] = mx;
    }
  }
  // Then the warps, in shared memory: [warp][g] m, l and acc[hd].
  float* scr = reinterpret_cast<float*>(ring);
  float* scr_ml = scr + kWarps * kG * HD;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float* a = scr + (warp * kG + g) * HD;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[d0 + k] = acc[g][k];
        a[d1 + k] = acc[g][4 + k];
      }
      if (li == 0) {
        scr_ml[2 * (warp * kG + g)] = m[g];
        scr_ml[2 * (warp * kG + g) + 1] = l[g];
      }
    }
  }
  __syncthreads();

  const int n_out = group * HD;
  const size_t ws_pair = static_cast<size_t>(bh) * splits;
  float* ws_acc = ws;
  float* ws_m = ws + static_cast<size_t>(batch) * hkv * splits * group * HD;
  float* ws_l = ws_m + static_cast<size_t>(batch) * hkv * splits * group;
  for (int e = tid; e < n_out; e += kThreads) {
    const int g = e / HD;
    const int d = e - g * HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, scr_ml[2 * (w * kG + g)]);
    float a = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(scr_ml[2 * (w * kG + g)] - mx);
      a += scr[(w * kG + g) * HD + d] * f;
      den += scr_ml[2 * (w * kG + g) + 1] * f;
    }
    if (n_live == 1) {
      out[out_base + e] = a / (den == 0.f ? 1.f : den);
    } else {
      const size_t sg = (ws_pair + split) * group + g;
      ws_acc[sg * HD + d] = a;
      if (d == 0) {
        ws_m[sg] = mx;
        ws_l[sg] = den;
      }
    }
  }
  if (n_live == 1) return;

  // The last live split of this (row, head) to arrive combines them all.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int seen = atomicAdd(counters + bh, 1);
    last_s = seen == n_live - 1;
    if (last_s) counters[bh] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  float* sm_m = scr;                                // [n_live][group]
  float* sm_l = sm_m + kMaxSplits * kMaxGroup;      // [n_live][group]
  float* sm_w = sm_l + kMaxSplits * kMaxGroup;      // [n_live][group]
  float* sm_ml = sm_w + kMaxSplits * kMaxGroup;     // M[g], L[g]
  const int n_ml = n_live * group;
  for (int i = tid; i < n_ml; i += kThreads) {
    sm_m[i] = __ldcg(ws_m + ws_pair * group + i);
    sm_l[i] = __ldcg(ws_l + ws_pair * group + i);
  }
  __syncthreads();
  if (tid < group) {
    float mx = kNegInf;
    for (int i = 0; i < n_live; ++i) mx = fmaxf(mx, sm_m[i * group + tid]);
    float den = 0.f;
    for (int i = 0; i < n_live; ++i) {
      den += sm_l[i * group + tid] * expf(sm_m[i * group + tid] - mx);
    }
    sm_ml[2 * tid] = mx;
    sm_ml[2 * tid + 1] = den;
  }
  __syncthreads();
  for (int i = tid; i < n_ml; i += kThreads) {
    sm_w[i] = expf(sm_m[i] - sm_ml[2 * (i % group)]);
  }
  __syncthreads();
  for (int e = tid; e < n_out; e += kThreads) {
    const int g = e / HD;
    const int d = e - g * HD;
    const float* src = ws_acc + (ws_pair * group + g) * HD + d;
    const size_t stride = static_cast<size_t>(group) * HD;
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_live; ++i) {
      a += sm_w[i * group + g] * __ldcg(src + i * stride);
    }
    const float den = sm_ml[2 * g + 1];
    out[out_base + e] = a / (den == 0.f ? 1.f : den);
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs;
  const int *table, *pos;
  float* out;
  float* ws;
  int* counters;
  int batch, hkv, group, n_blocks, bs, mb, splits, cps;
  float sm_scale;
  cudaStream_t stream;
};

template <typename QT, typename KVT, bool kQuant, int HD, int kG>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.splits, a.hkv, a.batch);
  paged_decode_kernel<QT, KVT, kQuant, HD, kG>
      <<<grid, kThreads, 0, a.stream>>>(
          static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k),
          static_cast<const KVT*>(a.v), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), a.table, a.pos, a.out, a.ws,
          a.counters, a.batch, a.hkv, a.group, a.n_blocks, a.bs, a.mb,
          a.splits, a.cps, a.sm_scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT, bool kQuant>
cudaError_t launch_shape(int hd, const Args& a) {
  const bool small = a.group <= 2;
  if (hd == 64) {
    return small ? launch<QT, KVT, kQuant, 64, 2>(a)
                 : launch<QT, KVT, kQuant, 64, 8>(a);
  }
  if (hd == 128) {
    return small ? launch<QT, KVT, kQuant, 128, 2>(a)
                 : launch<QT, KVT, kQuant, 128, 8>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, int hd, const Args& a) {
  switch (kv_dtype) {
    case 0:
      return launch_shape<QT, float, false>(hd, a);
    case 1:
      return launch_shape<QT, __nv_bfloat16, false>(hd, a);
    case 2:
      return launch_shape<QT, int8_t, true>(hd, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Type codes: 0 = f32, 1 = bf16, 2 = int8
// (pools only; scales then point at the f32 [N, Bs, Hkv] arrays). The grid
// is (splits, Hkv, B); split s covers table columns [s·cps, (s+1)·cps).
// With splits > 1, `ws` points at B·Hkv·splits·G·(hd + 2) f32 of scratch
// and `counters` at B·Hkv int32 that are 0 (the kernel leaves them 0);
// launches sharing `counters` must run on one stream. Returns the
// cudaError_t of the launch (0 = success); the caller raises on any other
// value. Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int kft_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* table,
                                const void* pos, void* out, void* ws,
                                void* counters, int batch, int hkv, int group,
                                int hd, int n_blocks, int bs, int mb,
                                int splits, int cps, float sm_scale,
                                int q_dtype, int kv_dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || hkv <= 0 || hkv > 65535 || group <= 0 ||
      group > kMaxGroup || bs < 8 || bs > 64 || bs % 8 != 0 || mb <= 0 ||
      n_blocks <= 0 || splits <= 0 || splits > kMaxSplits || cps <= 0 ||
      cps > kMaxCols || static_cast<long long>(splits) * cps < mb ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,
               k_pool,
               v_pool,
               k_scale,
               v_scale,
               static_cast<const int*>(table),
               static_cast<const int*>(pos),
               static_cast<float*>(out),
               static_cast<float*>(ws),
               static_cast<int*>(counters),
               batch,
               hkv,
               group,
               n_blocks,
               bs,
               mb,
               splits,
               cps,
               sm_scale,
               static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case 0:
      return static_cast<int>(launch_kv<float>(kv_dtype, hd, a));
    case 1:
      return static_cast<int>(launch_kv<__nv_bfloat16>(kv_dtype, hd, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
