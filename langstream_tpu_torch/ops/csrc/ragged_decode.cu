// Ragged decode attention: one query per row against its first `length`
// cache rows, sm_90a. The rows come from a page pool through a page table
// (paged layout) or from a dense head-major cache through its strides
// (dense layout): an addressing template flag (kDense) of one kernel. bf16
// queries; a bf16 cache and an int8 cache with per-token f32 scales are
// instantiations of one template.
//
// Replaces: langstream_tpu/ops/attention.py,
//   - ragged_paged_decode_attention (wrapper :849, pallas_call :892),
//     kernel body _paged_decode_kernel (:766), index map _paged_kv_index (:833);
//   - ragged_paged_decode_attention_int8 (wrapper :979, pallas_call :1026),
//     kernel body _paged_decode_int8_kernel (:907);
//   - ragged_decode_attention (wrapper :526, pallas_call :577), kernel body
//     _decode_kernel (:464) — the dense layout;
//   - ragged_decode_attention_int8 (wrapper :670, pallas_call :731), kernel
//     body _decode_int8_kernel (:596).
// Same math: q and the cache rows are widened to f32 (int8 rows are
// dequantized q*s to f32 in registers: the K scale multiplies the row's
// dot, the V scale the row's probability), scores and softmax in f32 with
// the -1e30 mask constant, p = 0 where s <= -1e30, l clamped to 1e-30,
// output rounded to bf16. Rows past a row's length are never visited (the
// TPU kernels re-reference the last valid block and skip its body). Paged:
// the physical page is clamped into [0, P-1], so an unmapped sentinel entry
// reads some page instead of faulting. Dense: the length is clamped to the
// cache width T, so a row whose position ran past a [..., :T] view reads
// the view and nothing beyond it.
//
// Bound on an H100: device-memory bytes. A step reads every valid K/V
// element once — sum(lengths) * Hkv * D * 2 * itemsize per layer (plus the
// int8 scales) at 3.35 TB/s — and does ~4 flops per element read.
//
// Design. The TPU grid walks a row's blocks in order carrying m/l/acc in
// scratch; here the tiles of a row (a page, or `ps` consecutive dense rows)
// are SPLIT across CTAs (split-K), so a batch of a few long rows still
// fills the SMs: one CTA per (kv head, row, split of `pps` tiles) runs the
// online softmax over its tiles and writes its partial (m, l, acc) to
// scratch, and a second small kernel merges the splits of each row
// (exp(m_s - M) weights). Inside a CTA each tile's K and V rows inside the
// length are first copied into shared memory with 16-byte loads (all 128
// threads, many loads in flight — the bandwidth lever), K with one padding
// word per row so that threads reading neighbouring rows hit distinct
// banks. The G query heads of the kv head share every K/V byte read:
// scores are computed by one thread per (row, half of D) for all G heads at
// once, then one warp per head updates the online softmax, then each thread
// accumulates its own output columns over the tile's V rows. Keys past the
// length are neither loaded nor accumulated, so bytes scale with
// sum(lengths), not with the cache width. The dense cache is read in place
// through its strides: a [..., :T] view of a wider cache is never copied.
// Not yet: double-buffered (cp.async / TMA) tile loads, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 227 * 1024;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }

// Four consecutive elements of a K row in shared memory → f32.
// (K rows are padded by one 4-byte word, so only 4-byte alignment holds.)
__device__ __forceinline__ void load4(const bf16* p, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}
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

template <bool kDense>
cudaError_t launch_d(int D, int kv_int8, const Launch& a, cudaStream_t stream) {
  switch (D * 2 + (kv_int8 != 0)) {
    case 128:
      return launch_g<bf16, 64, kDense>(a, stream);
    case 129:
      return launch_g<int8_t, 64, kDense>(a, stream);
    case 256:
      return launch_g<bf16, 128, kDense>(a, stream);
    case 257:
      return launch_g<int8_t, 128, kDense>(a, stream);
    case 512:
      return launch_g<bf16, 256, kDense>(a, stream);
    case 513:
      return launch_g<int8_t, 256, kDense>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, H, D] bf16; k/v pool [P, Hkv, ps, D], bf16 or (kv_int8 != 0) int8
// with k_scale/v_scale [P, Hkv, ps] f32 (else null); lengths [B] i32;
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

// q [B, H, D] bf16; k/v cache [B, Hkv, T, D] with rows of D contiguous
// elements at element strides kv_sb (batch) / kv_sh (kv head), bf16 or
// (kv_int8 != 0) int8 with k_scale/v_scale [B, Hkv, T] f32 at strides
// sc_sb / sc_sh (else null); lengths [B] i32, clamped to T; out [B, H, D]
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
