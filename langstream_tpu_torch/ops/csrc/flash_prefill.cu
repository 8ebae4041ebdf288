// Causal GQA flash attention for prompt prefill, bf16 in / bf16 out, sm_90a.
//
// Replaces: langstream_tpu/ops/attention.py, flash_prefill_attention
// (wrapper :143, pallas_call :171) and its kernel body _prefill_kernel (:70).
// Same math: QK^T and PV take bf16 operands with f32 accumulation, the
// online softmax runs in f32 with the -1e30 mask constant (p = 0 where
// s <= -1e30, l clamped to 1e-30 so a fully masked row gives 0), p is
// rounded to bf16 before PV (l sums the unrounded p), and key tiles above
// the diagonal are skipped.
//
// Bound on an H100: tensor-core operations. A causal prefill does about
// 2*B*H*S*(S+1)*D flops per layer (QK^T and PV over the lower triangle)
// against 989 TFLOP/s bf16, while it moves only O(B*S*(H+2*Hkv)*D) bytes,
// so at prompt widths of a few hundred tokens and up the bound is
// operations.
//
// Design (the FlashAttention-2 shape, on mma.sync). The TPU grid runs its
// key axis in order and carries m/l/acc in scratch from step to step; here
// each CTA owns one output tile and loops over the key tiles itself. A CTA
// of 4 warps covers HPC query heads of one kv head (HPC = 4, 2 or 1, the
// largest that divides the group) and 16 * 4 / HPC query positions; each
// warp owns 16 rows of one head. K/V tiles of BK keys are loaded once per
// CTA with cp.async into double-buffered shared memory (the next tile
// streams in while the current one is consumed) and shared by all the
// warps — K/V are read once per group of heads, not once per head. Scores
// (QK^T) and the output accumulator live in registers as m16n8k16 bf16
// fragments with f32 accumulation; ldmatrix feeds Q and K fragments, and
// ldmatrix.trans feeds V. The probabilities go from the score accumulators
// straight into the A operand of PV (the two layouts line up), so nothing
// but the K/V tiles passes through shared memory. Rows are padded by 16
// bytes so that ldmatrix reads are free of bank conflicts. Ragged S is
// masked at both edges (queries past S are never written, keys past S are
// zero-filled and masked). The heaviest (last) query tiles start first.
// Not yet: wgmma, TMA, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D, int BK, int HPC>
struct Tile {
  static constexpr int kRowBlocks = kWarps / HPC;  // 16-row blocks per head
  static constexpr int kBQ = 16 * kRowBlocks;      // query positions per CTA
  static constexpr int kStride = D + 8;            // padded shared-memory row (bf16)
  static constexpr size_t kQElems = size_t(HPC) * kBQ * kStride;
  static constexpr size_t kKVElems = size_t(BK) * kStride;
  static constexpr size_t kSmem = sizeof(bf16) * (kQElems + 4 * kKVElems);  // Q + 2x(K, V)
};

template <int D, int BK, int HPC>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const bf16* __restrict__ q,  // [B, S, H, D]
                     const bf16* __restrict__ k,  // [B, Hkv, S, D]
                     const bf16* __restrict__ v,  // [B, Hkv, S, D]
                     bf16* __restrict__ out,      // [B, S, H, D]
                     int S, int H, int Hkv, int G, float scale, float softcap) {
  using T = Tile<D, BK, HPC>;
  constexpr int kBQ = T::kBQ;
  constexpr int kStride = T::kStride;
  constexpr int kDT = D / 8;   // output n-tiles
  constexpr int kKT = BK / 8;  // score n-tiles
  constexpr int kRowVecs = D / 8;
  constexpr bool kQInRegs = D <= 128;  // D = 256 re-reads Q fragments from shared memory
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [HPC][kBQ][kStride]
  bf16* ks = qs + T::kQElems;                // [2][BK][kStride]
  bf16* vs = ks + 2 * T::kKVElems;           // [2][BK][kStride]

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
  const int row0 = q_start + (warp / HPC) * 16;            // its first query position
  const size_t kv_base = (size_t(b) * Hkv + kvh) * size_t(S) * D;

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

  auto load_kv = [&](int buf, int k0) {
    for (int i = tid; i < BK * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs;
      const int c = i % kRowVecs;
      const int pos = k0 + r;
      const bool ok = pos < S;
      const size_t off = kv_base + size_t(ok ? pos : 0) * D + c * 8;
      const size_t dst = (size_t(buf) * BK + r) * kStride + c * 8;
      cp_async16(ks + dst, k + off, ok);
      cp_async16(vs + dst, v + off, ok);
    }
    cp_async_commit();
  };

  // causal: key tiles past the CTA's last query position are never visited
  const int k_end = min(S, q_start + kBQ);
  const int n_tiles = (k_end + BK - 1) / BK;
  load_kv(0, 0);
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
    const bf16* kt = ks + size_t(buf) * T::kKVElems;
    const bf16* vt = vs + size_t(buf) * T::kKVElems;
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
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * kStride + kk * 16 +
                            ((lane / 8) & 1) * 8);
        mma_16816(s[2 * np], a, kb);
        mma_16816(s[2 * np + 1], a, kb + 2);
      }
    }

    // scale, soft cap, causal + ragged mask, row maxima (over the quad)
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row0 + g8 + (e >> 1) * 8;
        const int kpos = k0 + t * 8 + tig * 2 + (e & 1);
        float x = s[t][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (kpos > qpos || kpos >= S) x = kNeg;
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
      corr[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[t][e];
        const float p = (x <= kNeg) ? 0.f : expf(x - m_r[e >> 1]);
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

    // O += P V: the score accumulators of keys [16kb, 16kb + 16) are the A
    // fragment of this k-step, rounded to bf16
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kb][0], s[2 * kb][1]);
      a[1] = pack_bf16(s[2 * kb][2], s[2 * kb][3]);
      a[2] = pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]);
      a[3] = pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kb * 16 + ((lane / 8) & 1) * 8 + lane % 8) * kStride +
                                  dp * 16 + (lane / 16) * 8);
        mma_16816(o[2 * dp], a, vb);
        mma_16816(o[2 * dp + 1], a, vb + 2);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles from now
  }

  // finish the row sums over the quad and write rows inside S
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = fmaxf(l_r[i], 1e-30f);
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
          __floats2bfloat162_rn(o[t][2 * i] / l_r[i], o[t][2 * i + 1] / l_r[i]);
    }
  }
}

template <int D, int BK, int HPC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                   int Hkv, float scale, float softcap, cudaStream_t stream) {
  using T = Tile<D, BK, HPC>;
  const int G = H / Hkv;
  auto kernel = flash_prefill_kernel<D, BK, HPC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + T::kBQ - 1) / T::kBQ, Hkv * (G / HPC), B);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, H, Hkv, G, scale, softcap);
  return cudaGetLastError();
}

template <int D, int BK>
cudaError_t launch_hpc(const void* q, const void* k, const void* v, void* out, int B, int S,
                       int H, int Hkv, float scale, float softcap, cudaStream_t stream) {
  const int G = H / Hkv;
  if (G % 4 == 0) return launch<D, BK, 4>(q, k, v, out, B, S, H, Hkv, scale, softcap, stream);
  if (G % 2 == 0) return launch<D, BK, 2>(q, k, v, out, B, S, H, Hkv, scale, softcap, stream);
  return launch<D, BK, 1>(q, k, v, out, B, S, H, Hkv, scale, softcap, stream);
}

}  // namespace

// q [B, S, H, D], k/v [B, Hkv, S, D], out [B, S, H, D]; all bf16, contiguous.
// softcap <= 0 disables the logit soft cap. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int lstpu_flash_prefill_bf16(const void* q, const void* k, const void* v, void* out,
                                        int B, int S, int H, int Hkv, int D, float scale,
                                        float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return int(launch_hpc<64, 64>(q, k, v, out, B, S, H, Hkv, scale, softcap, st));
    case 128:
      return int(launch_hpc<128, 64>(q, k, v, out, B, S, H, Hkv, scale, softcap, st));
    case 256:
      return int(launch_hpc<256, 32>(q, k, v, out, B, S, H, Hkv, scale, softcap, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
