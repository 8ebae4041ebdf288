// Causal GQA flash attention of prompt queries against a head-major K/V
// cache, sm_90a: the queries of one prompt segment, at a per-row global
// offset, against the cache prefix written by earlier segments plus the
// segment's own lower triangle. A whole-prompt prefill is the segment at
// offset 0 over a cache of the prompt's own width. bf16 queries and output;
// a bf16 cache and an int8 cache with per-token f32 scales are
// instantiations of one template.
//
// Replaces: langstream_tpu/ops/attention.py,
//   - flash_prefill_attention (wrapper :143, pallas_call :171), kernel body
//     _prefill_kernel (:70) — offsets null, T = S;
//   - flash_segment_attention (wrapper :289, pallas_call :347), kernel body
//     _segment_body (:204) through _segment_kernel (:279);
//   - flash_segment_attention_int8 (wrapper :383, pallas_call :443), kernel
//     body _segment_int8_kernel (:356).
// Same math: QK^T and PV take model-dtype (bf16) operands with f32
// accumulation; key k is visible to query i of row b iff
// k <= offset[b] + i (global positions); the online softmax runs in f32
// with the -1e30 mask constant (p = 0 where s <= -1e30, l clamped to 1e-30,
// so a row that sees no key gives 0); p is rounded to bf16 before PV (l
// sums the unrounded p). The int8 cache is dequantized to the MODEL dtype
// before the dots, (float(q) * s) rounded to bf16, as the TPU kernel does
// in VMEM.
//
// Bound on an H100: tensor-core operations. A segment of S queries at
// offset o does about 4 * H * D * (S * o + S * (S + 1) / 2) flops per row
// against 989 TFLOP/s bf16; it reads the cache prefix once per head group
// (O((o + S) * Hkv * D) bytes), so past a few hundred tokens the bound is
// operations.
//
// Design: the FlashAttention-2 shape on mma.sync. A CTA of 4 warps owns one
// query tile of one (row, kv head) for HPC heads of its group (HPC = 4, 2
// or 1, the largest that divides the group; each warp owns 16 rows of one
// head), so each K/V tile is loaded once per group of heads. The key loop
// runs over [0, min(o + tile end, T)) — the tile's causal frontier — in
// tiles of BK keys, read from the cache through its batch and kv-head
// strides (a [..., :T] view of a wider cache is read in place, never
// copied), with cp.async double buffering. Keys past the frontier are
// zero-filled and masked, so the unwritten part of the cache is never read.
// Scores (QK^T) and the output accumulator live in registers as m16n8k16
// fragments; ldmatrix feeds Q and K, ldmatrix.trans feeds V, and the score
// accumulators are PV's A operand, so p goes to PV without passing through
// shared memory. Shared-memory rows are padded by 16 bytes (ldmatrix
// without bank conflicts). Past the mma the loop is bound by its scalar
// work, so the softmax runs in the log2 domain (the scale folded with
// log2(e), one ex2.approx per probability) and the per-element causal
// mask over global positions runs only on the tiles that cross a warp's
// diagonal or the frontier. int8 tiles and their scales stream into a second
// double-buffered staging area and are dequantized into the bf16 tile that
// ldmatrix reads. Offsets come from a device int32 array (no host sync per
// segment). Any S, any offset and any cache width: queries past S are not
// written. The heaviest (last) query tiles start first. Not yet: wgmma,
// TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte global → shared copy; a false `valid` zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4-byte global → shared copy (sources only 4-byte aligned), zero-fill as above
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x in one MUFU op (relative error ~2^-22, far below p's bf16 rounding);
// -1e30 gives +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename TKV, int D, int BK, int HPC>
struct Tile {
  static constexpr bool kInt8 = sizeof(TKV) == 1;
  static constexpr int kRowBlocks = kWarps / HPC;  // 16-row blocks per head
  static constexpr int kBQ = 16 * kRowBlocks;      // query positions per CTA
  static constexpr int kStride = D + 8;            // padded shared-memory row (bf16)
  // bf16 K/V tiles: double-buffered for a bf16 cache (cp.async lands there),
  // one for an int8 cache (the dequantize pass writes it)
  static constexpr int kBufs = kInt8 ? 1 : 2;
  static constexpr size_t kQElems = size_t(HPC) * kBQ * kStride;
  static constexpr size_t kKVElems = size_t(BK) * kStride;
  static constexpr size_t kRaw = kInt8 ? size_t(BK) * D : 0;    // bytes of one int8 tile
  static constexpr size_t kScales = kInt8 ? size_t(BK) : 0;     // its f32 scales
  // Q + bf16 K/V tiles + 2 x (int8 K, int8 V, K scales, V scales)
  static constexpr size_t kSmem = sizeof(bf16) * (kQElems + 2 * kBufs * kKVElems) +
                                  2 * 2 * (kRaw + sizeof(float) * kScales);
};

// four int8 values (one 32-bit word) * scale → four bf16, packed in pairs
__device__ __forceinline__ uint2 dequant4(uint32_t w, float s) {
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = float(int8_t((w >> (8 * e)) & 0xffu)) * s;
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

template <typename TKV, int D, int BK, int HPC>
__global__ void __launch_bounds__(kThreads)
flash_segment_kernel(const bf16* __restrict__ q,         // [B, S, H, D]
                     const TKV* __restrict__ k,          // [B, Hkv, T, D], strides kv_sb / kv_sh
                     const TKV* __restrict__ v,
                     const float* __restrict__ k_scale,  // [B, Hkv, T], strides sc_sb / sc_sh
                     const float* __restrict__ v_scale,
                     const int* __restrict__ offsets,    // [B] global position of q row 0
                     bf16* __restrict__ out,             // [B, S, H, D]
                     int S, int H, int Hkv, int G, int T, long long kv_sb, long long kv_sh,
                     long long sc_sb, long long sc_sh, float scale, float softcap) {
  using TL = Tile<TKV, D, BK, HPC>;
  constexpr bool kInt8 = TL::kInt8;
  constexpr int kBQ = TL::kBQ;
  constexpr int kStride = TL::kStride;
  constexpr int kDT = D / 8;                           // output n-tiles
  constexpr int kKT = BK / 8;                          // score n-tiles
  constexpr int kRowVecs = D / 8;                      // 16-byte vectors per bf16 row
  constexpr int kSrcVecs = D * int(sizeof(TKV)) / 16;  // 16-byte vectors per cache row
  constexpr int kVecElems = 16 / int(sizeof(TKV));     // cache elements per vector
  constexpr bool kQInRegs = D <= 128;  // D = 256 re-reads Q fragments from shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);     // [HPC][kBQ][kStride]
  bf16* ks = qs + TL::kQElems;                  // [kBufs][BK][kStride]
  bf16* vs = ks + TL::kBufs * TL::kKVElems;     // [kBufs][BK][kStride]
  unsigned char* staging = reinterpret_cast<unsigned char*>(vs + TL::kBufs * TL::kKVElems);
  TKV* kraw = reinterpret_cast<TKV*>(staging);                  // [2][BK][D] (int8 only)
  TKV* vraw = reinterpret_cast<TKV*>(staging + 2 * TL::kRaw);   // [2][BK][D]
  float* ksc = reinterpret_cast<float*>(staging + 4 * TL::kRaw);  // [2][BK]
  float* vsc = ksc + 2 * TL::kScales;                             // [2][BK]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane >> 2;  // fragment row (and +8)
  const int tig = lane & 3;  // fragment column pair
  const int b = blockIdx.z;
  const int groups = G / HPC;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * G + (blockIdx.y % groups) * HPC;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int hw = warp % HPC;                               // this warp's head in the CTA
  const int row0 = q_start + (warp / HPC) * 16;            // its first query (segment-local)
  const int off = offsets != nullptr ? max(offsets[b], 0) : 0;
  const TKV* kb = k + b * kv_sb + kvh * kv_sh;
  const TKV* vb = v + b * kv_sb + kvh * kv_sh;
  const float* ksb = kInt8 ? k_scale + b * sc_sb + kvh * sc_sh : nullptr;
  const float* vsb = kInt8 ? v_scale + b * sc_sb + kvh * sc_sh : nullptr;

  // Q tile → shared memory, rows past S zero-filled
  for (int i = tid; i < HPC * kBQ * kRowVecs; i += kThreads) {
    const int hh = i / (kBQ * kRowVecs);
    const int r = (i / kRowVecs) % kBQ;
    const int c = i % kRowVecs;
    const int pos = q_start + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < S) {
      val = *reinterpret_cast<const uint4*>(q + ((size_t(b) * S + pos) * H + h0 + hh) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(qs + (size_t(hh) * kBQ + r) * kStride + c * 8) = val;
  }

  // the tile's causal frontier: keys past its last query are never visited
  const int k_end = min(T, off + min(S, q_start + kBQ));
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  auto load_kv = [&](int buf, int k0) {
    for (int i = tid; i < BK * kSrcVecs; i += kThreads) {
      const int r = i / kSrcVecs;
      const int c = i % kSrcVecs;
      const int pos = k0 + r;
      const bool ok = pos < k_end;
      const size_t src = size_t(ok ? pos : 0) * D + c * kVecElems;
      if constexpr (kInt8) {
        const size_t dst = (size_t(buf) * BK + r) * D + c * kVecElems;
        cp_async16(kraw + dst, kb + src, ok);
        cp_async16(vraw + dst, vb + src, ok);
      } else {
        const size_t dst = (size_t(buf) * BK + r) * kStride + c * kVecElems;
        cp_async16(ks + dst, kb + src, ok);
        cp_async16(vs + dst, vb + src, ok);
      }
    }
    if constexpr (kInt8) {
      for (int r = tid; r < BK; r += kThreads) {
        const int pos = k0 + r;
        const bool ok = pos < k_end;
        cp_async4(ksc + buf * BK + r, ksb + (ok ? pos : 0), ok);
        cp_async4(vsc + buf * BK + r, vsb + (ok ? pos : 0), ok);
      }
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_kv(0, 0);
  __syncthreads();  // the Q tile is in shared memory

  const bf16* qw = qs + (size_t(hw) * kBQ + (warp / HPC) * 16) * kStride;
  uint32_t qf[kQInRegs ? D / 16 : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qf[kk], qw + (lane % 16) * kStride + kk * 16 + (lane / 16) * 8);
  }

  float o[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  // scores in the log2 domain: exp(x - m) == 2^(x log2(e) - m log2(e))
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale_log2 = scale * kLog2e;
  const float scale_cap = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_log2 = softcap * kLog2e;
  float m_r[2] = {kNeg, kNeg};  // running max of rows g8 and g8 + 8
  float l_r[2] = {0.f, 0.f};    // this thread's share of the running sums

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(buf ^ 1, (j + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks;
    const bf16* vt = vs;
    if constexpr (kInt8) {
      // dequantize the staged int8 tile into the bf16 tile: 8 values a step
      const TKV* kr = kraw + size_t(buf) * BK * D;
      const TKV* vr = vraw + size_t(buf) * BK * D;
      for (int i = tid; i < BK * kRowVecs; i += kThreads) {
        const int r = i / kRowVecs;
        const int c = i % kRowVecs;
        const uint2 kw = *reinterpret_cast<const uint2*>(kr + r * D + c * 8);
        const uint2 vw = *reinterpret_cast<const uint2*>(vr + r * D + c * 8);
        const float sk = ksc[buf * BK + r];
        const float sv = vsc[buf * BK + r];
        const uint2 ka = dequant4(kw.x, sk), kc = dequant4(kw.y, sk);
        const uint2 va = dequant4(vw.x, sv), vc = dequant4(vw.y, sv);
        *reinterpret_cast<uint4*>(ks + size_t(r) * kStride + c * 8) = make_uint4(ka.x, ka.y, kc.x, kc.y);
        *reinterpret_cast<uint4*>(vs + size_t(r) * kStride + c * 8) = make_uint4(va.x, va.y, vc.x, vc.y);
      }
      __syncthreads();
    } else {
      kt = ks + size_t(buf) * TL::kKVElems;
      vt = vs + size_t(buf) * TL::kKVElems;
    }
    const int k0 = j * BK;

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[kKT][4];
#pragma unroll
    for (int t = 0; t < kKT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qw + (lane % 16) * kStride + kk * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int np = 0; np < kKT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * kStride + kk * 16 +
                            ((lane / 8) & 1) * 8);
        mma_16816(s[2 * np], a, kf);
        mma_16816(s[2 * np + 1], a, kf + 2);
      }
    }

    // scale, soft cap, row maxima (over the quad); the global causal mask
    // and the frontier only on a tile that crosses this warp's first
    // query's diagonal or the frontier (warp-uniform: the rest see every key)
    const bool edge = k0 + BK - 1 > off + row0 || k0 + BK > k_end;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap > 0.f ? tanhf(s[t][e] * scale_cap) * cap_log2 : s[t][e] * scale_log2;
        if (edge) {
          const int qpos = off + row0 + g8 + (e >> 1) * 8;
          const int kpos = k0 + t * 8 + tig * 2 + (e & 1);
          if (kpos > qpos || kpos >= k_end) x = kNeg;
        }
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = exp2_approx(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[t][e];
        const float p = (x <= kNeg) ? 0.f : exp2_approx(x - m_r[e >> 1]);
        s[t][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

    // O += P V, p rounded to bf16 straight from the score accumulators
#pragma unroll
    for (int kb16 = 0; kb16 < BK / 16; ++kb16) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kb16][0], s[2 * kb16][1]);
      a[1] = pack_bf16(s[2 * kb16][2], s[2 * kb16][3]);
      a[2] = pack_bf16(s[2 * kb16 + 1][0], s[2 * kb16 + 1][1]);
      a[3] = pack_bf16(s[2 * kb16 + 1][2], s[2 * kb16 + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kb16 * 16 + ((lane / 8) & 1) * 8 + lane % 8) * kStride +
                                  dp * 16 + (lane / 16) * 8);
        mma_16816(o[2 * dp], a, vf);
        mma_16816(o[2 * dp + 1], a, vf + 2);
      }
    }
    __syncthreads();  // the tiles (and their staging buffer) are refilled from here on
  }

  // finish the row sums over the quad (l_r becomes 1 / l) and write rows
  // inside S
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
  const int h = h0 + hw;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = row0 + g8 + i * 8;
    if (pos >= S) continue;
    bf16* dst = out + ((size_t(b) * S + pos) * H + h) * D + tig * 2;
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8) =
          __floats2bfloat162_rn(o[t][2 * i] * l_r[i], o[t][2 * i + 1] * l_r[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale;
  const int* offsets;
  void* out;
  int B, S, H, Hkv, T;
  long long kv_sb, kv_sh, sc_sb, sc_sh;
  float scale, softcap;
};

template <typename TKV, int D, int BK, int HPC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using TL = Tile<TKV, D, BK, HPC>;
  const int G = a.H / a.Hkv;
  auto kernel = flash_segment_kernel<TKV, D, BK, HPC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(TL::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + TL::kBQ - 1) / TL::kBQ, a.Hkv * (G / HPC), a.B);
  kernel<<<grid, kThreads, TL::kSmem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale), a.offsets,
      static_cast<bf16*>(a.out), a.S, a.H, a.Hkv, G, a.T, a.kv_sb, a.kv_sh, a.sc_sb, a.sc_sh,
      a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename TKV, int D, int BK>
cudaError_t launch_hpc(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  if (G % 4 == 0) return launch<TKV, D, BK, 4>(a, stream);
  if (G % 2 == 0) return launch<TKV, D, BK, 2>(a, stream);
  return launch<TKV, D, BK, 1>(a, stream);
}

template <typename TKV>
cudaError_t launch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_hpc<TKV, 64, 64>(a, stream);
    case 128:
      return launch_hpc<TKV, 128, 64>(a, stream);
    case 256:
      return launch_hpc<TKV, 256, 32>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, S, H, D] bf16 contiguous; k/v cache [B, Hkv, T, D] with rows of D
// contiguous elements and element strides kv_sb (batch) / kv_sh (kv head),
// bf16 or (kv_int8 != 0) int8 with k_scale/v_scale [B, Hkv, T] f32 of
// strides sc_sb / sc_sh (else null); offsets [B] i32 on the device, or
// null for offset 0 (a prefill); out [B, S, H, D] bf16. softcap <= 0
// disables the soft cap. Returns the cudaError_t of the launch (0 =
// success).
extern "C" int lstpu_flash_segment(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const void* offsets,
                                   void* out, int B, int S, int H, int Hkv, int D, int T,
                                   long long kv_sb, long long kv_sh, long long sc_sb,
                                   long long sc_sh, float scale, float softcap, int kv_int8,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return int(cudaErrorInvalidValue);
  const Args a{q,     k,     v,     k_scale, v_scale, static_cast<const int*>(offsets),
               out,   B,     S,     H,       Hkv,     T,
               kv_sb, kv_sh, sc_sb, sc_sh,   scale,   softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(kv_int8 ? launch_d<int8_t>(D, a, st) : launch_d<bf16>(D, a, st));
}
