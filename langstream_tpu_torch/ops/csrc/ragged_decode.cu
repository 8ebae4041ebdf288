// Ragged decode attention: one query per row against its first `length`
// cache rows, sm_90a. The rows come from a page pool through a page table
// (paged layout) or from a dense head-major cache through its strides
// (dense layout). bf16 queries and output. Two kernels live here:
//
//   - decode_cluster_kernel: a bf16 cache, both layouts (a runtime flag
//     picks the addressing) — lstpu_decode_bf16;
//   - decode_split_kernel + decode_combine_kernel: an int8 cache with
//     per-token f32 scales, both layouts (a template flag) —
//     lstpu_paged_decode / lstpu_dense_decode.
//
// Replaces: langstream_tpu/ops/attention.py,
//   - ragged_paged_decode_attention (wrapper :849, pallas_call :892),
//     kernel body _paged_decode_kernel (:766), index map _paged_kv_index
//     (:833) — decode_cluster_kernel, paged;
//   - ragged_decode_attention (wrapper :526, pallas_call :577), kernel body
//     _decode_kernel (:464) — decode_cluster_kernel, dense;
//   - ragged_paged_decode_attention_int8 (wrapper :979, pallas_call :1026),
//     kernel body _paged_decode_int8_kernel (:907) — the split kernel, paged;
//   - ragged_decode_attention_int8 (wrapper :670, pallas_call :731), kernel
//     body _decode_int8_kernel (:596) — the split kernel, dense.
// Same math: q and the cache rows are widened to f32 (int8 rows are
// dequantized q*s to f32 in registers: the K scale multiplies the row's
// dot, the V scale the row's probability), scores scaled by 1/sqrt(D) and
// optionally soft-capped, softmax in f32 with the -1e30 mask constant, p =
// 0 where s <= -1e30 and kept in f32 for PV, l clamped to 1e-30 (a row of
// length 0 gives 0), output rounded to bf16. Rows past a row's length are
// never visited (the TPU kernels re-reference the last valid block and skip
// its body). Paged: the physical page is clamped into [0, P-1], so an
// unmapped sentinel entry reads some page instead of faulting. Dense: the
// length is clamped to the cache width T, so a row whose position ran past
// a [..., :T] view reads the view and nothing beyond it.
//
// Bound on an H100: device-memory bytes. A step reads every valid K/V
// element once — sum(lengths) * Hkv * D * 2 * itemsize per layer (plus the
// int8 scales) at 3.35 TB/s — and does ~4 flops per element read (86
// MFLOP for 5,280 keys of llama-3-8b: 1.3 us at the f32 peak against 6.5
// us of bytes).
//
// decode_cluster_kernel. A tile is tr = 64 rows of one kv head (the plan's
// tile rows): a page [ps, D] of 64, an equal part of a wider page, or tr
// consecutive rows of a dense [B, Hkv, T, D] cache — in both layouts one
// contiguous run of bytes. One launch per call:
//   - grid (Hkv, B, C), cluster dims (1, 1, C), C <= 8: the C CTAs of a
//     cluster split one (row, kv head). Each takes a contiguous share of
//     ceil(n / C) of the row's n VALID tiles, n computed on the device from
//     lengths[b] (the host chose C from the table width or the view's T, so
//     no host sync);
//   - a producer warp: one thread issues each tile's K and V as two bulk
//     copies (cp.async.bulk, the non-tensor TMA form) into a ring of >= 3
//     stages, completing on the stage's full mbarrier; a share of up to
//     `stages` tiles is in flight at once. Only the valid rows of a row's
//     last tile are copied (valid * D * 2 bytes, a multiple of 16), so a
//     dense cache of exactly T rows is never read past its end;
//   - four consumer warps, each with its own online softmax over its rows
//     of every tile (no CTA barrier per tile): lanes lie along D, 16 bytes
//     of a row each (lanes_per_row lanes a row, so unpadded rows read
//     without bank conflicts), the partial dots reduced with shuffles; the
//     G query heads share every K/V byte; p stays f32 for PV (QK^T on bf16
//     mma.sync was tried: no faster at these shapes). Rows of a
//     stage past `valid` hold an earlier tile's bytes, or garbage: they are
//     never loaded, so not even 0 * NaN reaches the sums. A warp releases a
//     stage by arriving on its empty mbarrier;
//   - the warps' partials merge in shared memory (over the drained ring),
//     then, after a cluster barrier, rank 0 reads every rank's (m, l,
//     acc[G][D]) through distributed shared memory, weights them by
//     exp(m_r - M) and writes the bf16 output. A rank with no tiles arrives
//     with (-1e30, 0, 0); every rank waits at a second cluster barrier, so
//     none exits while rank 0 still reads its shared memory. Nothing goes
//     through global memory and there is no second kernel.
// decode_launch_plan (ops/attention.py) mirrors the launch (cluster size,
// tile rows, ring depth, shared memory) and refuses what the bulk copies
// cannot take; the shared-memory size it computes is passed in and checked
// against cluster_layout below, so the two cannot drift apart silently.
//
// decode_split_kernel (int8). The tiles of a row are SPLIT across CTAs
// (split-K): one CTA per (kv head, row, split of `pps` tiles) runs the
// online softmax over its tiles and writes its partial (m, l, acc) to
// scratch, and decode_combine_kernel merges the splits of each row
// (exp(m_s - M) weights). Inside a CTA each tile's valid int8 K and V rows
// are first copied into shared memory with 16-byte loads, K with one
// padding word per row so that threads reading neighbouring rows hit
// distinct banks; scores are computed by one thread per (row, half of D)
// for all G heads at once, then one warp per head updates the online
// softmax, then each thread accumulates its own output columns over the
// tile's V rows. Not yet: the cluster kernel's ring and merge for int8.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 227 * 1024;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }  // queries
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

// Four consecutive elements of an int8 K row in shared memory → f32.
// (K rows are padded by one 4-byte word, so only 4-byte alignment holds.)
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = float(int8_t((w >> (8 * e)) & 0xffu));
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared-memory layout of the split kernel (offsets in bytes).
struct Layout {
  size_t qs, kt, vt, ksc, vsc, part, pt, m, l, corr, total;
  int kstride;  // bytes per K row: the row plus one padding word
};

__host__ __device__ inline Layout layout(int G, int D, int ps, int item) {
  Layout L{};
  L.kstride = D * item + 4;
  L.qs = 0;                                                   // f32 [G][D]
  L.kt = align16(L.qs + sizeof(float) * G * D);               // TKV [ps][D + pad]
  L.vt = align16(L.kt + size_t(L.kstride) * ps);              // TKV [ps][D]
  L.ksc = align16(L.vt + size_t(D) * item * ps);              // f32 [ps]
  L.vsc = align16(L.ksc + sizeof(float) * ps);                // f32 [ps]
  L.part = align16(L.vsc + sizeof(float) * ps);               // f32 [2][G][ps] half dots
  L.pt = align16(L.part + sizeof(float) * 2 * G * ps);        // f32 [ps][G] probabilities
  L.m = align16(L.pt + sizeof(float) * G * ps);
  L.l = align16(L.m + sizeof(float) * G);
  L.corr = align16(L.l + sizeof(float) * G);
  L.total = align16(L.corr + sizeof(float) * G);
  return L;
}

// Paged (kDense false): tile j of row b is logical page j, found through
// the table — its first row is (page * Hkv + kvh) * ps of the pool [P, Hkv,
// ps, D]. Dense: tile j of row b is rows [j * ps, (j + 1) * ps) of the
// head-major cache, whose batch / kv-head strides are rsb / rsh rows (of D
// elements) for K/V and ssb / ssh for the scales; the length is clamped
// to the cache width T, and the table, P and Tp are unused.
template <typename TKV, int D, int G, bool kDense>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const bf16* __restrict__ q,         // [B, H, D]
                    const TKV* __restrict__ kp,         // pool or cache (see above)
                    const TKV* __restrict__ vp,
                    const float* __restrict__ k_scale,  // per-row scales (int8 only)
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths,    // [B]
                    const int* __restrict__ table,      // [B, Tp] (paged)
                    float* __restrict__ m_out,          // [B, Hkv, NS, G]
                    float* __restrict__ l_out,          // [B, Hkv, NS, G]
                    float* __restrict__ acc_out,        // [B, Hkv, NS, G, D]
                    int H, int Hkv, int P, int ps, int Tp, int pps, int NS, float scale,
                    float softcap, int T, long long rsb, long long rsh, long long ssb,
                    long long ssh) {
  constexpr bool kInt8 = sizeof(TKV) == 1;
  constexpr int kCols = (D + kThreads - 1) / kThreads;
  constexpr int kRowVecs = D * int(sizeof(TKV)) / 16;  // 16-byte vectors per row
  constexpr int kBatch = 4;                            // loads in flight per thread and tensor
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(G, D, ps, int(sizeof(TKV)));
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  unsigned char* kt = smem + L.kt;
  TKV* vt = reinterpret_cast<TKV*>(smem + L.vt);
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* pt = reinterpret_cast<float*>(smem + L.pt);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* corr_s = reinterpret_cast<float*>(smem + L.corr);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h0 = kvh * G;
  const int length = kDense ? min(max(lengths[b], 0), T) : max(lengths[b], 0);
  const int n_pages = kDense ? (length + ps - 1) / ps : min((length + ps - 1) / ps, Tp);
  const int p_begin = split * pps;
  const int p_end = min(p_begin + pps, n_pages);
  const size_t pidx = (size_t(b) * Hkv + kvh) * NS + split;

  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(q[(size_t(b) * H + h0) * D + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  float acc[G][kCols];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  __syncthreads();

  for (int j = p_begin; j < p_end; ++j) {
    size_t row0, sc0;  // the tile's first cache row and the index of its scale
    if constexpr (kDense) {
      row0 = size_t(b * rsb + kvh * rsh) + size_t(j) * ps;
      sc0 = size_t(b * ssb + kvh * ssh) + size_t(j) * ps;
    } else {
      const int page = min(max(table[size_t(b) * Tp + j], 0), P - 1);
      row0 = (size_t(page) * Hkv + kvh) * ps;
      sc0 = row0;
    }
    const int valid = min(ps, length - j * ps);  // rows of this tile inside the length

    // stage the page's valid K/V rows in shared memory: 16-byte loads,
    // kBatch of each tensor in flight per thread before any store
    const uint4* kg = reinterpret_cast<const uint4*>(kp + row0 * D);
    const uint4* vg = reinterpret_cast<const uint4*>(vp + row0 * D);
    const int n_vec = valid * kRowVecs;
    for (int base = 0; base < n_vec; base += kThreads * kBatch) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < n_vec) {
          kr[u] = kg[i];
          vr[u] = vg[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < n_vec) {
          uint32_t* kd = reinterpret_cast<uint32_t*>(kt + size_t(i / kRowVecs) * L.kstride) +
                         (i % kRowVecs) * 4;
          kd[0] = kr[u].x;
          kd[1] = kr[u].y;
          kd[2] = kr[u].z;
          kd[3] = kr[u].w;
          reinterpret_cast<uint4*>(vt)[i] = vr[u];
        }
      }
    }
    if (kInt8) {
      for (int t = tid; t < valid; t += kThreads) {
        ksc[t] = k_scale[sc0 + t];
        vsc[t] = v_scale[sc0 + t];
      }
    }
    __syncthreads();

    // partial dots: one thread per (row, half of D), all G heads at once;
    // neighbouring threads read neighbouring (padded) rows — no bank
    // conflicts — and the same q values — a broadcast
    for (int i = tid; i < 2 * ps; i += kThreads) {
      const int t = i % ps;
      const int half = i / ps;
      if (t >= valid) continue;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      const TKV* kr = reinterpret_cast<const TKV*>(kt + size_t(t) * L.kstride) + half * (D / 2);
      const float* qh = qs + half * (D / 2);
#pragma unroll 4
      for (int d = 0; d < D / 2; d += 4) {
        float kf[4];
        load4(kr + d, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qv = *reinterpret_cast<const float4*>(qh + g * D + d);
          dot[g] += qv.x * kf[0] + qv.y * kf[1] + qv.z * kf[2] + qv.w * kf[3];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) part[(half * G + g) * ps + t] = dot[g];
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNeg;
      for (int t = lane; t < ps; t += 32) {
        float s = kNeg;
        if (t < valid) {
          s = part[g * ps + t] + part[(G + g) * ps + t];
          if (kInt8) s *= ksc[t];
          s *= scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        }
        part[g * ps + t] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float s = part[g * ps + t];
        const float p = (s <= kNeg) ? 0.f : expf(s - m_new);
        sum += p;
        // the V scale of an int8 row rides its probability into PV
        pt[t * G + g] = (kInt8 && t < valid) ? p * vsc[t] : p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: each thread owns output columns d = tid + kThreads * c
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tid + kThreads * c;
      if (d < D) {
        float a[G];
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] = acc[g][c] * corr_s[g];
        for (int t = 0; t < valid; ++t) {
          const float vf = to_f32(vt[size_t(t) * D + d]);
          const float* p = pt + t * G;
#pragma unroll
          for (int g = 0; g < G; ++g) a[g] += p[g] * vf;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][c] = a[g];
      }
    }
    __syncthreads();  // the next page rewrites kt / vt / part / pt / corr_s
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = tid + kThreads * c;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc_out[(pidx * G + g) * D + d] = acc[g][c];
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    m_out[pidx * G + g] = m_s[g];
    l_out[pidx * G + g] = l_s[g];
  }
}

// Merge the splits of each row: out = sum_s e^(m_s - M) acc_s / max(sum_s
// e^(m_s - M) l_s, 1e-30), M = max_s m_s. A row of length 0 gives 0. The
// split statistics are staged in shared memory first, so the per-column
// sums load their accumulators back to back.
template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ m_in, const float* __restrict__ l_in,
                      const float* __restrict__ acc_in, const int* __restrict__ lengths,
                      bf16* __restrict__ out, int H, int Hkv, int ps, int Tp, int pps, int NS) {
  extern __shared__ float wsm[];  // [NS][G] split weights, then [G] inverse denominators
  float* inv = wsm + NS * G;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int length = max(lengths[b], 0);
  const int n_pages = min((length + ps - 1) / ps, Tp);
  const int n_splits = max(1, min(NS, (n_pages + pps - 1) / pps));
  const size_t base = (size_t(b) * Hkv + kvh) * NS;
  for (int i = threadIdx.x; i < n_splits * G; i += kThreads) wsm[i] = m_in[base * G + i];
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNeg;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, wsm[s * G + g]);
    float denom = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(wsm[s * G + g] - mx);
      wsm[s * G + g] = w;
      denom += w * l_in[(base + s) * G + g];
    }
    inv[g] = 1.f / fmaxf(denom, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) o += wsm[s * G + g] * acc_in[((base + s) * G + g) * D + d];
    out[(size_t(b) * H + kvh * G + g) * D + d] = __float2bfloat16(o * inv[g]);
  }
}

struct Launch {
  const void *q, *k, *v, *k_scale, *v_scale;
  const int *lengths, *table;
  void* out;
  float *m, *l, *acc;  // split scratch
  int B, H, Hkv, P, ps, Tp, pps;  // Tp: tiles of a full row (table width, or ceil(T / ps))
  float scale, softcap;
  int T;                               // dense: cache width
  long long rsb, rsh, ssb, ssh;        // dense: strides (see decode_split_kernel)
};

template <typename TKV, int D, int G, bool kDense>
cudaError_t launch(const Launch& a, cudaStream_t stream) {
  const int NS = (a.Tp + a.pps - 1) / a.pps;
  const size_t smem = layout(G, D, a.ps, int(sizeof(TKV))).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto split = decode_split_kernel<TKV, D, G, kDense>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  split<<<dim3(a.Hkv, a.B, NS), kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale), a.lengths,
      a.table, a.m, a.l, a.acc, a.H, a.Hkv, a.P, a.ps, a.Tp, a.pps, NS, a.scale, a.softcap, a.T,
      a.rsb, a.rsh, a.ssb, a.ssh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t combine_smem = sizeof(float) * (size_t(NS) * G + G);
  if (combine_smem > 48 * 1024) return cudaErrorInvalidValue;
  decode_combine_kernel<D, G><<<dim3(a.Hkv, a.B), kThreads, combine_smem, stream>>>(
      a.m, a.l, a.acc, a.lengths, static_cast<bf16*>(a.out), a.H, a.Hkv, a.ps, a.Tp, a.pps, NS);
  return cudaGetLastError();
}

template <typename TKV, int D, bool kDense>
cudaError_t launch_g(const Launch& a, cudaStream_t stream) {
  switch (a.H / a.Hkv) {
    case 1:
      return launch<TKV, D, 1, kDense>(a, stream);
    case 2:
      return launch<TKV, D, 2, kDense>(a, stream);
    case 4:
      return launch<TKV, D, 4, kDense>(a, stream);
    case 8:
      return launch<TKV, D, 8, kDense>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// int8 caches only: a bf16 cache goes to decode_cluster_kernel
template <bool kDense>
cudaError_t launch_d(int D, int kv_int8, const Launch& a, cudaStream_t stream) {
  if (!kv_int8) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_g<int8_t, 64, kDense>(a, stream);
    case 128:
      return launch_g<int8_t, 128, kDense>(a, stream);
    case 256:
      return launch_g<int8_t, 256, kDense>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// decode_cluster_kernel (bf16 cache; see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kCWarps = 4;                     // consumer warps
constexpr int kCThreads = 32 * (kCWarps + 1);  // + one producer warp
constexpr int kMaxCluster = 8;                 // the portable cluster size
constexpr float kLog2e = 1.4426950408889634f;

// lanes that share one row: enough that q and the accumulator of a lane,
// G x D / lanes_per_row floats each, stay at 64 registers or fewer where a
// row has the 16-byte chunks for it (D / 8 lanes at most), and at least 8,
// so the 8 lanes of one shared-memory phase read 8 distinct 16-byte chunks
// of one row (conflict-free on unpadded rows)
constexpr int kLaneFloats = 64;
__host__ __device__ constexpr int lanes_per_row(int D, int G) {
  return G * D / kLaneFloats < 8 ? 8 : (G * D / kLaneFloats > D / 8 ? D / 8 : G * D / kLaneFloats);
}

// Shared-memory layout (byte offsets). The ring holds `stages` tiles of K
// then V rows; once it is drained, the warps' accumulators [kCWarps][G][D]
// f32 reuse its bytes, and the CTA's merged partial acc is their slot 0.
struct ClusterLayout {
  uint32_t stage, region, mw, lw, pm, pl, wts, inv, bars, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int G, int D, int tr, int stages) {
  ClusterLayout L{};
  L.stage = uint32_t(2 * tr * D * 2);
  const uint32_t ring = uint32_t(stages) * L.stage;
  const uint32_t red = uint32_t(kCWarps * G * D * 4);
  L.region = uint32_t(align16(ring > red ? ring : red));
  L.mw = L.region;                          // f32 [kCWarps][G] warp maxima
  L.lw = L.mw + kCWarps * G * 4;            // f32 [kCWarps][G] warp sums
  L.pm = L.lw + kCWarps * G * 4;            // f32 [G] the CTA's partial m
  L.pl = L.pm + G * 4;                      // f32 [G] the CTA's partial l
  L.wts = L.pl + G * 4;                     // f32 [kMaxCluster][G] merge weights (rank 0)
  L.inv = L.wts + kMaxCluster * G * 4;      // f32 [G] 1 / merged l (rank 0)
  L.bars = uint32_t(align16(L.inv + G * 4));  // mbarriers full[stages], empty[stages]
  L.total = L.bars + 16 * uint32_t(stages);
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kCWarps) : "memory");
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// eight bf16 (one 16-byte chunk) → f32
__device__ __forceinline__ void widen8(const uint4 w, float* f) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(x[e] << 16);
    f[2 * e + 1] = __uint_as_float(x[e] & 0xffff0000u);
  }
}

// A tile is tr rows. Paged (dense == 0): a page of ps rows holds ps / tr
// tiles; tile j of row b is part j % (ps / tr) of logical page j / (ps /
// tr), whose rows start at (clamp(table[b, page]) * Hkv + kvh) * ps of the
// pool [P, Hkv, ps, D]. Dense: tile j is rows [j * tr, (j + 1) * tr) of
// the cache, whose batch / kv-head strides are rsb / rsh rows; the length
// is clamped to T, and the table, P, ps and Tp are unused.
template <int D, int G>
__global__ void __launch_bounds__(kCThreads, 2)
decode_cluster_kernel(const bf16* __restrict__ q,       // [B, H, D]
                      const bf16* __restrict__ kp,      // pool or cache (see above)
                      const bf16* __restrict__ vp,
                      const int* __restrict__ lengths,  // [B]
                      const int* __restrict__ table,    // [B, Tp] (paged)
                      bf16* __restrict__ out,           // [B, H, D]
                      int H, int Hkv, int P, int ps, int tr, int Tp, int T, long long rsb,
                      long long rsh, int dense, int stages, float scale, float softcap) {
  constexpr int kLPR = lanes_per_row(D, G);
  constexpr int kCPL = D / 8 / kLPR;  // 16-byte chunks of a row per lane
  constexpr int kDL = 8 * kCPL;       // elements of a row per lane
  constexpr int kRPW = 32 / kLPR;     // rows a warp reads at once
  constexpr int kNB = G >= 8 ? 2 : (G == 4 ? 4 : 8);  // row groups per softmax update
  constexpr int kBatchRows = kNB * kRPW * kCWarps;
  static_assert(kCPL >= 1 && kLPR * kCPL * 8 == D, "lane layout");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterLayout L = cluster_layout(G, D, tr, stages);
  float* red = reinterpret_cast<float*>(smem);
  float* mw = reinterpret_cast<float*>(smem + L.mw);
  float* lw = reinterpret_cast<float*>(smem + L.lw);
  float* pm = reinterpret_cast<float*>(smem + L.pm);
  float* pl = reinterpret_cast<float*>(smem + L.pl);
  float* wts = reinterpret_cast<float*>(smem + L.wts);
  float* inv = reinterpret_cast<float*>(smem + L.inv);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * stages;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int n_ranks = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h0 = kvh * G;
  const int length = dense ? min(max(lengths[b], 0), T) : max(lengths[b], 0);
  const int spp = ps / tr;  // tiles per page
  const int n_tiles = dense ? (length + tr - 1) / tr : min((length + tr - 1) / tr, Tp * spp);
  const int per = (n_tiles + n_ranks - 1) / n_ranks;
  const int t0 = min(rank * per, n_tiles);
  const int n_my = min(t0 + per, n_tiles) - t0;  // this rank's share

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kCWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kCWarps) {
    // producer: lane l holds the page of tile t0 + k for k = l (mod 32)
    int page = 0;
    for (int k = 0; k < n_my; ++k) {
      if (!dense && k % 32 == 0) {
        const int j = t0 + k + lane;
        page = j < t0 + n_my ? min(max(table[size_t(b) * Tp + j / spp], 0), P - 1) : 0;
      }
      const int pg = dense ? 0 : __shfl_sync(0xffffffffu, page, k % 32);
      if (lane == 0) {
        const int s = k % stages;
        if (k >= stages) mbar_wait(empty0 + 8 * s, uint32_t((k / stages) - 1) & 1u);
        const int j = t0 + k;
        const size_t row0 = dense ? size_t(b * rsb + kvh * rsh) + size_t(j) * tr
                                  : (size_t(pg) * Hkv + kvh) * ps + size_t(j % spp) * tr;
        const uint32_t bytes = uint32_t(min(tr, length - j * tr)) * D * 2;
        const uint32_t dst = smem_u32(smem) + uint32_t(s) * L.stage;
        mbar_expect_tx(full0 + 8 * s, 2 * bytes);
        bulk_load(dst, kp + row0 * D, bytes, full0 + 8 * s);
        bulk_load(dst + L.stage / 2, vp + row0 * D, bytes, full0 + 8 * s);
      }
    }
  } else {
    // consumers: lane (rr, jl) reads row rr of each group of kRPW rows,
    // chunks jl + kLPR * c of it (c < kCPL)
    const int jl = lane % kLPR;
    const int rr = lane / kLPR;
    float qf[G][kDL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < kCPL; ++c)
        widen8(*reinterpret_cast<const uint4*>(q + (size_t(b) * H + h0 + g) * D +
                                               8 * (jl + kLPR * c)),
               &qf[g][8 * c]);
    float acc[G][kDL];
    float m[G], l[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNeg;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < kDL; ++e) acc[g][e] = 0.f;
    }

    for (int k = 0; k < n_my; ++k) {
      const int s = k % stages;
      mbar_wait(full0 + 8 * s, uint32_t(k / stages) & 1u);
      const int valid = min(tr, length - (t0 + k) * tr);  // rows of this stage to read
      const bf16* kt = reinterpret_cast<const bf16*>(smem + size_t(s) * L.stage);
      const bf16* vt = kt + size_t(tr) * D;
      for (int r0 = 0; r0 < valid; r0 += kBatchRows) {
        float sc[kNB][G];  // scores, then probabilities
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          const int first = r0 + (n * kCWarps + warp) * kRPW;  // warp-uniform
          if (first < valid) {
            const int row = first + rr;
            float dot[G];
#pragma unroll
            for (int g = 0; g < G; ++g) dot[g] = 0.f;
            if (row < valid) {
#pragma unroll
              for (int c = 0; c < kCPL; ++c) {
                float kf[8];
                widen8(*reinterpret_cast<const uint4*>(kt + size_t(row) * D + 8 * (jl + kLPR * c)),
                       kf);
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                  for (int e = 0; e < 8; ++e) dot[g] = fmaf(qf[g][8 * c + e], kf[e], dot[g]);
              }
            }
#pragma unroll
            for (int off = kLPR / 2; off > 0; off >>= 1)
#pragma unroll
              for (int g = 0; g < G; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              float x = dot[g] * scale;
              if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
              sc[n][g] = row < valid ? x : kNeg;
            }
          } else {
#pragma unroll
            for (int g = 0; g < G; ++g) sc[n][g] = kNeg;
          }
        }
        // the warp's online softmax over these rows (lanes of one row hold
        // the same scores, so the reductions run over the row bits)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float mx = kNeg;
#pragma unroll
          for (int n = 0; n < kNB; ++n) mx = fmaxf(mx, sc[n][g]);
#pragma unroll
          for (int off = kLPR; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[g], mx);
          const float corr = exp2_approx((m[g] - m_new) * kLog2e);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            const float p = sc[n][g] <= kNeg ? 0.f : exp2_approx((sc[n][g] - m_new) * kLog2e);
            sc[n][g] = p;
            sum += p;
          }
#pragma unroll
          for (int off = kLPR; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[g] = l[g] * corr + sum;
          m[g] = m_new;
#pragma unroll
          for (int e = 0; e < kDL; ++e) acc[g][e] *= corr;
        }
        // PV with p in f32, over the valid rows only
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          const int row = r0 + (n * kCWarps + warp) * kRPW + rr;
          if (row < valid) {
#pragma unroll
            for (int c = 0; c < kCPL; ++c) {
              float vf[8];
              widen8(*reinterpret_cast<const uint4*>(vt + size_t(row) * D + 8 * (jl + kLPR * c)),
                     vf);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[g][8 * c + e] = fmaf(sc[n][g], vf[e], acc[g][8 * c + e]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
    }

    // the warp's rows → one accumulator, then the warps → the CTA's partial
#pragma unroll
    for (int off = kLPR; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kDL; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    consumers_sync();  // every warp is done reading the ring
    if (rr == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < kCPL; ++c)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            red[(warp * G + g) * D + 8 * (jl + kLPR * c) + e] = acc[g][8 * c + e];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        mw[warp * G + g] = m[g];
        lw[warp * G + g] = l[g];
      }
    }
    consumers_sync();
    for (int i = tid; i < G * D; i += 32 * kCWarps) {
      const int g = i / D;
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) mx = fmaxf(mx, mw[w * G + g]);
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kCWarps; ++w)
        a += exp2_approx((mw[w * G + g] - mx) * kLog2e) * red[w * G * D + i];
      red[i] = a;
    }
    if (tid < G) {
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) mx = fmaxf(mx, mw[w * G + tid]);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) sum += exp2_approx((mw[w * G + tid] - mx) * kLog2e) * lw[w * G + tid];
      pm[tid] = mx;
      pl[tid] = sum;
    }
  }

  cluster.sync();  // every rank's partial (m, l, acc) is in its shared memory
  if (rank == 0 && warp < kCWarps) {
    // every remote load of a step is issued before any is used
    if (tid < G) {
      float rm[kMaxCluster], rl[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        rm[r] = r < n_ranks ? *cluster.map_shared_rank(pm + tid, r) : kNeg;
        rl[r] = r < n_ranks ? *cluster.map_shared_rank(pl + tid, r) : 0.f;
      }
      float mx = kNeg;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) mx = fmaxf(mx, rm[r]);
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const float w = r < n_ranks ? exp2_approx((rm[r] - mx) * kLog2e) : 0.f;
        wts[r * G + tid] = w;
        sum += w * rl[r];
      }
      inv[tid] = 1.f / fmaxf(sum, 1e-30f);
    }
    consumers_sync();
    for (int i = 4 * tid; i < G * D; i += 4 * 32 * kCWarps) {
      const int g = i / D;
      float4 a[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        a[r] = r < n_ranks ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(red + i, r))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const float w = wts[r * G + g];
        o.x += w * a[r].x;
        o.y += w * a[r].y;
        o.z += w * a[r].z;
        o.w += w * a[r].w;
      }
      const float s = inv[g];
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (size_t(b) * H + h0) * D + i);
      dst[0] = __floats2bfloat162_rn(o.x * s, o.y * s);
      dst[1] = __floats2bfloat162_rn(o.z * s, o.w * s);
    }
  }
  cluster.sync();  // no rank exits while rank 0 may still read its shared memory
}

struct ClusterArgs {
  const void *q, *k, *v;
  const int *lengths, *table;
  void* out;
  int B, H, Hkv, P, ps, tr, Tp, T;
  long long rsb, rsh;  // dense: strides in rows
  int dense, cluster, stages, smem;
  float scale, softcap;
};

template <int D, int G>
cudaError_t launch_cluster(const ClusterArgs& a, cudaStream_t stream) {
  const ClusterLayout L = cluster_layout(G, D, a.tr, a.stages);
  // the plan's shared memory must be this kernel's layout
  if (int(L.total) != a.smem || L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = decode_cluster_kernel<D, G>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMaxSmem));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv, a.B, a.cluster);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = a.cluster;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(a.q),
                            static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
                            a.lengths, a.table, static_cast<bf16*>(a.out), a.H, a.Hkv, a.P,
                            a.ps, a.tr, a.Tp, a.T, a.rsb, a.rsh, a.dense, a.stages, a.scale,
                            a.softcap);
}

template <int D>
cudaError_t launch_cluster_g(const ClusterArgs& a, cudaStream_t stream) {
  switch (a.H / a.Hkv) {
    case 1:
      return launch_cluster<D, 1>(a, stream);
    case 2:
      return launch_cluster<D, 2>(a, stream);
    case 4:
      return launch_cluster<D, 4>(a, stream);
    case 8:
      return launch_cluster<D, 8>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// int8 caches (kv_int8 must be 1; a bf16 cache goes to lstpu_decode_bf16).
// q [B, H, D] bf16; k/v pool [P, Hkv, ps, D] int8 with k_scale/v_scale
// [P, Hkv, ps] f32; lengths [B] i32;
// table [B, Tp] i32; out [B, H, D] bf16. Physical pages are clamped into
// [0, P-1]. Scratch, allocated by the caller: m/l [B, Hkv, NS, G] f32 and
// acc [B, Hkv, NS, G, D] f32 with NS = ceil(Tp / pps), pps = pages per
// split. softcap <= 0 disables the soft cap. Returns the cudaError_t of
// the launches.
extern "C" int lstpu_paged_decode(const void* q, const void* k, const void* v, const void* k_scale,
                                  const void* v_scale, const void* lengths, const void* table,
                                  void* out, void* m_scratch, void* l_scratch, void* acc_scratch,
                                  int B, int H, int Hkv, int D, int P, int ps, int Tp, int pps,
                                  float scale, float softcap, int kv_int8, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || P <= 0 || ps <= 0 || Tp <= 0 || pps <= 0)
    return int(cudaErrorInvalidValue);
  const Launch a{q, k, v, k_scale, v_scale, static_cast<const int*>(lengths),
                 static_cast<const int*>(table), out, static_cast<float*>(m_scratch),
                 static_cast<float*>(l_scratch), static_cast<float*>(acc_scratch), B, H, Hkv, P,
                 ps, Tp, pps, scale, softcap, 0, 0, 0, 0, 0};
  return int(launch_d<false>(D, kv_int8, a, static_cast<cudaStream_t>(stream)));
}

// int8 caches (kv_int8 must be 1). q [B, H, D] bf16; k/v cache [B, Hkv,
// T, D] int8 with rows of D contiguous elements at element strides kv_sb
// (batch) / kv_sh (kv head), k_scale/v_scale [B, Hkv, T] f32 at strides
// sc_sb / sc_sh; lengths [B] i32, clamped to T; out [B, H, D]
// bf16. The cache is split into tiles of ps rows, pps tiles per split;
// scratch as for lstpu_paged_decode with NS = ceil(ceil(T / ps) / pps).
extern "C" int lstpu_dense_decode(const void* q, const void* k, const void* v, const void* k_scale,
                                  const void* v_scale, const void* lengths, void* out,
                                  void* m_scratch, void* l_scratch, void* acc_scratch, int B, int H,
                                  int Hkv, int D, int T, long long kv_sb, long long kv_sh,
                                  long long sc_sb, long long sc_sh, int ps, int pps, float scale,
                                  float softcap, int kv_int8, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || T <= 0 || ps <= 0 || pps <= 0)
    return int(cudaErrorInvalidValue);
  if (kv_sb % D != 0 || kv_sh % D != 0) return int(cudaErrorInvalidValue);
  const Launch a{q, k, v, k_scale, v_scale, static_cast<const int*>(lengths), nullptr, out,
                 static_cast<float*>(m_scratch), static_cast<float*>(l_scratch),
                 static_cast<float*>(acc_scratch), B, H, Hkv, 1, ps, (T + ps - 1) / ps, pps,
                 scale, softcap, T, kv_sb / D, kv_sh / D, sc_sb, sc_sh};
  return int(launch_d<true>(D, kv_int8, a, static_cast<cudaStream_t>(stream)));
}

// bf16 caches, one launch of decode_cluster_kernel over tiles of
// tile_rows rows. q [B, H, D] bf16; lengths [B] i32; out [B, H, D] bf16.
// Paged (dense == 0): k/v pool [P, Hkv, page_rows, D] contiguous (page_rows
// a multiple of tile_rows), table [B, Tp] i32 (physical pages clamped into
// [0, P-1]). Dense: k/v cache [B, Hkv, T, D] with rows of D contiguous
// elements at element strides kv_sb / kv_sh (whole rows), lengths clamped
// to T, table null, page_rows unused. cluster (1..8), stages and smem come from
// decode_launch_plan; smem must equal cluster_layout's total. Every base,
// and every row, must be 16-byte aligned (the bulk copies' rule). softcap
// <= 0 disables the soft cap. Returns the cudaError_t of the launch.
extern "C" int lstpu_decode_bf16(const void* q, const void* k, const void* v, const void* lengths,
                                 const void* table, void* out, int B, int H, int Hkv, int D, int P,
                                 int page_rows, int tile_rows, int Tp, int T, long long kv_sb,
                                 long long kv_sh,
                                 int dense, int cluster, int stages, int smem, float scale,
                                 float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || tile_rows <= 0 || cluster < 1 ||
      cluster > kMaxCluster || stages < 1)
    return int(cudaErrorInvalidValue);
  if (dense ? (T <= 0 || kv_sb % D != 0 || kv_sh % D != 0)
            : (P <= 0 || Tp <= 0 || !table || page_rows % tile_rows != 0))
    return int(cudaErrorInvalidValue);
  const ClusterArgs a{q, k, v, static_cast<const int*>(lengths), static_cast<const int*>(table),
                      out, B, H, Hkv, P, dense ? tile_rows : page_rows, tile_rows, Tp, T,
                      kv_sb / D, kv_sh / D, dense, cluster,
                      stages, smem, scale, softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return int(launch_cluster_g<64>(a, st));
    case 128:
      return int(launch_cluster_g<128>(a, st));
    case 256:
      return int(launch_cluster_g<256>(a, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
