// Ragged decode attention: one query per row against its first `length`
// cache rows, sm_90a. The rows come from a page pool through a page table
// (paged layout) or from a dense head-major cache through its strides
// (dense layout). bf16 queries and output; a bf16 cache, or an int8 cache
// with per-row f32 scales. One kernel, decode_cluster_kernel, serves all
// four (a template parameter picks the cache type, a runtime flag the
// addressing) through one entry point, lstpu_decode.
//
// Replaces: langstream_tpu/ops/attention.py,
//   - ragged_paged_decode_attention (wrapper :849, pallas_call :892),
//     kernel body _paged_decode_kernel (:766), index map _paged_kv_index
//     (:833) — bf16, paged;
//   - ragged_decode_attention (wrapper :526, pallas_call :577), kernel body
//     _decode_kernel (:464) — bf16, dense;
//   - ragged_paged_decode_attention_int8 (wrapper :979, pallas_call :1026),
//     kernel body _paged_decode_int8_kernel (:907) — int8, paged;
//   - ragged_decode_attention_int8 (wrapper :670, pallas_call :731), kernel
//     body _decode_int8_kernel (:596) — int8, dense.
// Same math: q and the cache rows are widened to f32 (int8 rows are
// dequantized q*s to f32 in registers: the K scale multiplies the row's
// dot, the V scale the row's probability in PV — the same function as
// dequantizing first, rounded in another order), scores scaled by
// 1/sqrt(D) and optionally soft-capped, softmax in f32 with the -1e30 mask
// constant, p = 0 where s <= -1e30 and kept in f32 for PV, l clamped to
// 1e-30 (a row of length 0 gives 0), output rounded to bf16. Rows past a
// row's length are never visited, their scales included (the TPU kernels
// re-reference the last valid block and skip its body). Paged: the physical
// page is clamped into [0, P-1], so an unmapped sentinel entry reads some
// page instead of faulting. Dense: the length is clamped to the cache width
// T, so a row whose position ran past a [..., :T] view reads the view and
// nothing beyond it; query row b reads cache row b / qpr, so the k + 1
// queries of a flattened dense verify share their row (qpr = k + 1; the
// decode step's launch is qpr = 1).
//
// Bound on an H100: device-memory bytes. A step reads every valid K/V
// element once — sum(lengths) * Hkv * D * 2 * itemsize per layer, plus 8
// bytes of f32 scales per int8 key and kv head — at 3.35 TB/s, and does ~4
// flops per element read (86 MFLOP for 5,280 keys of llama-3-8b: 1.3 us at
// the f32 peak against 6.5 us of bf16 bytes).
//
// A tile is tr = 64 rows of one kv head (the plan's tile rows): a page [ps,
// D] of 64, an equal part of a wider page, or tr consecutive rows of a
// dense [B, Hkv, T, D] cache — in both layouts one contiguous run of bytes.
// One launch per call:
//   - grid (Hkv, B, C), cluster dims (1, 1, C), C <= 4: the C CTAs of a
//     cluster split one (row, kv head). Each takes a contiguous share of
//     ceil(n / C) of the row's n VALID tiles, n computed on the device from
//     lengths[b] (the host chose C from the table width or the view's T, so
//     no host sync). Longest rows first: the clusters of blockIdx.y = i take
//     the row of the i-th longest length, ranked on the device, so a batch's
//     longest rows do not start in the last wave and make its tail;
//   - a producer warp: one thread issues each tile's K and V as two bulk
//     copies (cp.async.bulk, the non-tensor TMA form) into a ring of >= 3
//     stages, completing on the stage's full mbarrier; a share of up to
//     `stages` tiles is in flight at once. Only the valid rows of a row's
//     last tile are copied (valid * D * itemsize bytes, a multiple of 16),
//     so a dense cache of exactly T rows is never read past its end. An
//     int8 tile's f32 scales ride the same stage: the warp's lanes copy the
//     tile's valid K and V scales with 4-byte cp.async, each lane's copies
//     counted on the full mbarrier (cp.async.mbarrier.arrive.noinc, so the
//     barrier expects 1 + 32 arrivals). A scale row need not start 16-byte
//     aligned — the engine's dense cache is max_seq_len + 1 columns wide, so
//     its 8,193-float scale rows are not — and 4-byte copies take any
//     layout;
//   - four consumer warps, each with its own online softmax over its rows
//     of every tile (no CTA barrier per tile): lanes lie along D, a chunk of
//     a row each (lanes_per_row lanes a row, so unpadded rows read without
//     bank conflicts); the G query heads share every K/V byte. The partial
//     dots of a row are reduce-scattered over its lanes, so each lane ends
//     with one head's dot and runs that head's softmax alone (one ex2 per
//     row, not G), and the row's lanes then gather the G probabilities for
//     PV; an accumulator is rescaled only when its head's max moved; a batch
//     whose rows are all valid runs without row tests, so its loads and
//     shuffles schedule freely. p stays f32 for PV (QK^T on bf16 mma.sync
//     was tried: no faster at these shapes). An int8 lane keeps half the
//     state of a bf16 one, so three CTAs share an SM. int8 elements widen
//     at full rate without I2F (a quarter-rate conversion): a byte with its
//     sign flipped is placed in the mantissa of 2^23 by one prmt, and one
//     exact FADD takes 2^23 + 128 off. Rows of a stage past `valid` hold an
//     earlier tile's bytes, or garbage: they are never loaded, nor their
//     scales, so not even 0 * NaN reaches the sums. A warp releases a stage
//     by arriving on its empty mbarrier;
//   - the warps' partials merge in shared memory (over the drained ring),
//     then, after a cluster barrier, rank 0 reads every rank's (m, l,
//     acc[G][D]) through distributed shared memory, weights them by
//     exp(m_r - M) and writes the bf16 output. A rank with no tiles arrives
//     with (-1e30, 0, 0); every rank waits at a second cluster barrier, so
//     none exits while rank 0 still reads its shared memory. Nothing goes
//     through global memory and there is no second kernel.
// decode_launch_plan (ops/attention.py) mirrors the launch (cluster size,
// tile rows, ring depth, stage and shared-memory bytes, the scale copies)
// and refuses what the copies cannot take; the shared-memory size it
// computes is passed in and checked against cluster_layout below, so the
// two cannot drift apart silently.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kCWarps = 4;                     // consumer warps
constexpr int kCThreads = 32 * (kCWarps + 1);  // + one producer warp
// CTAs splitting one (row, kv head), at most: 4 beat 8 at B = 8 and B = 32
// on an H100 (fewer CTAs pay a CTA's fixed cost — its first loads, the
// merge and two cluster barriers)
constexpr int kMaxCluster = 4;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr uint32_t align16(uint32_t x) { return (x + 15) & ~uint32_t(15); }

// lanes that share one row: enough that q and the accumulator of a lane,
// G x D / lanes_per_row floats each, stay at 64 registers (bf16) or 32
// (int8) or fewer where a row has the chunks for it (D / 8 lanes at most),
// and at least 8, so the lanes of one shared-memory phase read distinct
// 16-byte chunks (or, with 8-byte int8 chunks, one contiguous 128 bytes) —
// conflict-free on unpadded rows. int8 keeps half the state a lane so that
// three CTAs fit an SM (its ring is half as large): more warps hide more of
// the consumers' latency
template <typename TKV>
__host__ __device__ constexpr int lanes_per_row(int D, int G) {
  constexpr int f = sizeof(TKV) == 2 ? 64 : 32;
  return G * D / f < 8 ? 8 : (G * D / f > D / 8 ? D / 8 : G * D / f);
}
// elements of a row a lane reads at once: 16 bytes — 8 bf16, or 16 int8
// where the row has 16-byte chunks for all its lanes — else 8 int8 (8 bytes)
template <typename TKV>
__host__ __device__ constexpr int chunk_elems(int D, int G) {
  return sizeof(TKV) == 2 ? 8 : (lanes_per_row<TKV>(D, G) * 16 <= D ? 16 : 8);
}
// CTAs an SM is built to hold: three for an int8 cache where a lane's q and
// accumulator are 32 floats and the ring (decode_launch_plan's int8 budget,
// 72 KB: 4 stages at D = 128) fits three times; else two
template <typename TKV>
__host__ __device__ constexpr int min_ctas(int D, int G) {
  return sizeof(TKV) == 1 && D < 256 && G * D / lanes_per_row<TKV>(D, G) <= 32 ? 3 : 2;
}

// Shared-memory layout (byte offsets). The ring holds `stages` tiles: K
// rows, V rows, then (int8) the K and V scales [tr] f32; once it is
// drained, the warps' accumulators [kCWarps][G][D] f32 reuse its bytes, and
// the CTA's merged partial acc is their slot 0.
struct ClusterLayout {
  uint32_t stage, v, ksc, vsc, region, mw, lw, pm, pl, wts, inv, row, bars, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int G, int D, int tr, int stages,
                                                        int item) {
  ClusterLayout L{};
  L.v = uint32_t(tr * D * item);                           // V after K
  L.ksc = 2 * L.v;                                         // int8: f32 K scales [tr]
  L.vsc = L.ksc + (item == 1 ? uint32_t(tr * 4) : 0u);     // int8: f32 V scales [tr]
  L.stage = align16(L.vsc + (item == 1 ? uint32_t(tr * 4) : 0u));
  const uint32_t ring = uint32_t(stages) * L.stage;
  const uint32_t red = uint32_t(kCWarps * G * D * 4);
  L.region = align16(ring > red ? ring : red);
  L.mw = L.region;                          // f32 [kCWarps][G] warp maxima
  L.lw = L.mw + kCWarps * G * 4;            // f32 [kCWarps][G] warp sums
  L.pm = L.lw + kCWarps * G * 4;            // f32 [G] the CTA's partial m
  L.pl = L.pm + G * 4;                      // f32 [G] the CTA's partial l
  L.wts = L.pl + G * 4;                     // f32 [kMaxCluster][G] merge weights (rank 0)
  L.inv = L.wts + kMaxCluster * G * 4;      // f32 [G] 1 / merged l (rank 0)
  L.row = L.inv + G * 4;                    // i32: the batch row this cluster takes
  L.bars = align16(L.row + 4);              // mbarriers full[stages], empty[stages]
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
// 4 bytes from global to shared memory (the thread's own async copy)
__device__ __forceinline__ void copy4_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
// one arrival on `bar` once every earlier cp.async of this thread has landed
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kCWarps) : "memory");
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// two bf16 (one 32-bit word) → f32: a shift and a mask
__device__ __forceinline__ void widen2(uint32_t x, float* f) {
  f[0] = __uint_as_float(x << 16);
  f[1] = __uint_as_float(x & 0xffff0000u);
}
// four int8 (one 32-bit word) → f32 without I2F: with its sign bit
// flipped, byte q reads q + 128 in [0, 255]; placed in the low mantissa of
// 2^23 (bytes (u, 0, 0, 0x4B) of {0x4B000000 : u}) it reads 2^23 + q +
// 128, and one exact subtraction gives float(q)
__device__ __forceinline__ void widen4(uint32_t x, float* f) {
  const uint32_t u = x ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | e)) - 8388736.f;
}
// kE elements at p (kE * itemsize bytes, aligned to that) → f32
template <int kE>
__device__ __forceinline__ void widen(const bf16* p, float* f) {
  static_assert(kE % 8 == 0, "bf16 chunks are 16-byte loads");
#pragma unroll
  for (int h = 0; h < kE; h += 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p + h);
    widen2(w.x, f + h);
    widen2(w.y, f + h + 2);
    widen2(w.z, f + h + 4);
    widen2(w.w, f + h + 6);
  }
}
template <int kE>
__device__ __forceinline__ void widen(const int8_t* p, float* f) {
  static_assert(kE == 8 || kE == 16, "int8 chunks are 8- or 16-byte loads");
  if constexpr (kE == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    widen4(w.x, f);
    widen4(w.y, f + 4);
    widen4(w.z, f + 8);
    widen4(w.w, f + 12);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    widen4(w.x, f);
    widen4(w.y, f + 4);
  }
}

// A tile is tr rows. Paged (dense == 0): a page of ps rows holds ps / tr
// tiles; tile j of row b is part j % (ps / tr) of logical page j / (ps /
// tr), whose rows start at (clamp(table[b, page]) * Hkv + kvh) * ps of the
// pool [P, Hkv, ps, D], and whose scales start at the same index of the
// scale pool [P, Hkv, ps]. Dense: tile j is rows [j * tr, (j + 1) * tr) of
// cache row b / qpr (qpr query rows share a cache row: a flattened
// verify's k + 1 queries), whose batch / kv-head strides are rsb / rsh
// rows, and of the scales, whose strides are ssb / ssh elements; the
// length is clamped to T, and the table, P, ps and Tp are unused. k_scale / v_scale are read
// for an int8 cache only.
template <typename TKV, int D, int G>
__global__ void __launch_bounds__(kCThreads, min_ctas<TKV>(D, G))
decode_cluster_kernel(const bf16* __restrict__ q,         // [B, H, D]
                      const TKV* __restrict__ kp,         // pool or cache (see above)
                      const TKV* __restrict__ vp,
                      const float* __restrict__ k_scale,  // int8: per-row scales
                      const float* __restrict__ v_scale,
                      const int* __restrict__ lengths,    // [B]
                      const int* __restrict__ table,      // [B, Tp] (paged)
                      bf16* __restrict__ out,             // [B, H, D]
                      int H, int Hkv, int P, int ps, int tr, int Tp, int T, long long rsb,
                      long long rsh, long long ssb, long long ssh, int dense, int qpr,
                      int stages, float scale, float softcap) {
  constexpr bool kInt8 = sizeof(TKV) == 1;
  constexpr int kLPR = lanes_per_row<TKV>(D, G);
  constexpr int kE = chunk_elems<TKV>(D, G);  // elements of a chunk (one load)
  constexpr int kCPL = D / kE / kLPR;         // chunks of a row per lane
  constexpr int kDL = kE * kCPL;              // elements of a row per lane
  constexpr int kRPW = 32 / kLPR;             // rows a warp reads at once
  // row groups per softmax update: a whole 64-row tile where a lane's q and
  // accumulator are 32 floats, else 4 (2 at G = 8), so that a full batch's
  // hoisted loads fit the registers
  constexpr int kNB = G * kDL <= 32 ? 64 / (kRPW * kCWarps) : (G >= 8 ? 2 : 4);
  constexpr int kBatchRows = kNB * kRPW * kCWarps;
  // G = 8 keeps 8 dots, 8 probabilities and 128 floats of q and accumulator
  // a lane: there the test-free batch's hoisted loads spill, so it is not
  // built
  constexpr bool kFullBatches = G < 8;
  static_assert(kCPL >= 1 && kLPR * kCPL * kE == D, "lane layout");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterLayout L = cluster_layout(G, D, tr, stages, int(sizeof(TKV)));
  float* red = reinterpret_cast<float*>(smem);
  float* mw = reinterpret_cast<float*>(smem + L.mw);
  float* lw = reinterpret_cast<float*>(smem + L.lw);
  float* pm = reinterpret_cast<float*>(smem + L.pm);
  float* pl = reinterpret_cast<float*>(smem + L.pl);
  float* wts = reinterpret_cast<float*>(smem + L.wts);
  float* inv = reinterpret_cast<float*>(smem + L.inv);
  int* row_of = reinterpret_cast<int*>(smem + L.row);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * stages;

  const int kvh = blockIdx.x;
  const int n_ranks = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h0 = kvh * G;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // the producer's expect_tx, and (int8) each of its lanes' scale copies
      mbar_init(full0 + 8 * s, kInt8 ? 33 : 1);
      mbar_init(empty0 + 8 * s, kCWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // longest rows first: the clusters of blockIdx.y = i take the row of the
  // i-th longest clamped length (ties by index), so the rows that take
  // longest start in the first wave instead of making the last one's tail
  // (clusters start in blockIdx order)
  for (int r = tid; r < int(gridDim.y); r += kCThreads) {
    const auto clamp = [&](int n) { return dense ? min(max(n, 0), T) : max(n, 0); };
    const int nr = clamp(lengths[r]);
    int order = 0;
    for (int r2 = 0; r2 < int(gridDim.y); ++r2) {
      const int n2 = clamp(lengths[r2]);
      order += n2 > nr || (n2 == nr && r2 < r);
    }
    if (order == int(blockIdx.y)) *row_of = r;
  }
  __syncthreads();
  const int b = *row_of;
  const int length = dense ? min(max(lengths[b], 0), T) : max(lengths[b], 0);
  const long long cb = dense ? b / qpr : 0;  // the dense cache row query row b reads
  const int spp = ps / tr;  // tiles per page
  const int n_tiles = dense ? (length + tr - 1) / tr : min((length + tr - 1) / tr, Tp * spp);
  const int per = (n_tiles + n_ranks - 1) / n_ranks;
  const int t0 = min(rank * per, n_tiles);
  const int n_my = min(t0 + per, n_tiles) - t0;  // this rank's share

  if (warp == kCWarps) {
    // producer: lane l holds the page of tile t0 + k for k = l (mod 32)
    int page = 0;
    for (int k = 0; k < n_my; ++k) {
      if (!dense && k % 32 == 0) {
        const int j = t0 + k + lane;
        page = j < t0 + n_my ? min(max(table[size_t(b) * Tp + j / spp], 0), P - 1) : 0;
      }
      const int pg = dense ? 0 : __shfl_sync(0xffffffffu, page, k % 32);
      const int s = k % stages;
      // every lane: an int8 tile's lanes write the stage too
      if (k >= stages) mbar_wait(empty0 + 8 * s, uint32_t((k / stages) - 1) & 1u);
      const int j = t0 + k;
      const size_t row0 = dense ? size_t(cb * rsb + kvh * rsh) + size_t(j) * tr
                                : (size_t(pg) * Hkv + kvh) * ps + size_t(j % spp) * tr;
      const int valid = min(tr, length - j * tr);
      const uint32_t dst = smem_u32(smem) + uint32_t(s) * L.stage;
      if (lane == 0) {
        const uint32_t bytes = uint32_t(valid) * D * uint32_t(sizeof(TKV));
        mbar_expect_tx(full0 + 8 * s, 2 * bytes);
        bulk_load(dst, kp + row0 * D, bytes, full0 + 8 * s);
        bulk_load(dst + L.v, vp + row0 * D, bytes, full0 + 8 * s);
      }
      if constexpr (kInt8) {
        const size_t sc0 = dense ? size_t(cb * ssb + kvh * ssh) + size_t(j) * tr : row0;
        for (int i = lane; i < valid; i += 32) {
          copy4_async(dst + L.ksc + 4 * i, k_scale + sc0 + i);
          copy4_async(dst + L.vsc + 4 * i, v_scale + sc0 + i);
        }
        copies_arrive(full0 + 8 * s);
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
        widen<kE>(q + (size_t(b) * H + h0 + g) * D + kE * (jl + kLPR * c), &qf[g][kE * c]);
    // After the dots' reduce-scatter (below), lane (rr, jl) holds the whole
    // dot of ONE head, hd = jl / kRep, for its row (kRep lanes hold each
    // head); it runs the online softmax of that head only, and the G heads'
    // probabilities reach every lane of the row by shuffles for PV
    constexpr int kRep = kLPR / G;  // lanes of a row that hold one head
    static_assert(kRep >= 1, "a row has a lane for every head");
    const int hd = jl / kRep;
    float acc[G][kDL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < kDL; ++e) acc[g][e] = 0.f;
    float mh = kNeg, lh = 0.f;  // head hd's running max and sum

    for (int k = 0; k < n_my; ++k) {
      const int s = k % stages;
      mbar_wait(full0 + 8 * s, uint32_t(k / stages) & 1u);
      const int valid = min(tr, length - (t0 + k) * tr);  // rows of this stage to read
      const unsigned char* st = smem + size_t(s) * L.stage;
      const TKV* kt = reinterpret_cast<const TKV*>(st);
      const TKV* vt = reinterpret_cast<const TKV*>(st + L.v);
      const float* ksc = reinterpret_cast<const float*>(st + L.ksc);
      const float* vsc = reinterpret_cast<const float*>(st + L.vsc);
      // a batch of kBatchRows rows; a full one (every row valid) has no row
      // tests, so its loads and shuffle chains schedule freely (G < 8)
      auto batch = [&](const int r0, auto full) {
        constexpr bool kFull = decltype(full)::value;
        float sc[kNB];  // head hd's scores of this lane's kNB rows, then probabilities
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          const int first = r0 + (n * kCWarps + warp) * kRPW;  // warp-uniform
          const int row = first + rr;
          sc[n] = kNeg;
          if (kFull || first < valid) {
            float dot[G];
#pragma unroll
            for (int g = 0; g < G; ++g) dot[g] = 0.f;
            if (kFull || row < valid) {
#pragma unroll
              for (int c = 0; c < kCPL; ++c) {
                float kf[kE];
                widen<kE>(kt + size_t(row) * D + kE * (jl + kLPR * c), kf);
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                  for (int e = 0; e < kE; ++e) dot[g] = fmaf(qf[g][kE * c + e], kf[e], dot[g]);
              }
            }
            // reduce-scatter over the row's lanes: while a lane holds w > 1
            // heads, each level keeps half of them (the upper half where
            // the level's lane bit is set) and adds the partner's half
#pragma unroll
            for (int off = kLPR / 2, w = G; off > 0; off >>= 1, w = w > 1 ? w / 2 : 1) {
              const bool upper = lane & off;
#pragma unroll
              for (int i = 0; i < (G > 1 ? G / 2 : 1); ++i) {
                if (w > 1 && i < w / 2) {
                  const float send = upper ? dot[i] : dot[i + w / 2];
                  const float keep = upper ? dot[i + w / 2] : dot[i];
                  dot[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
                } else if (w == 1 && i == 0) {
                  dot[0] += __shfl_xor_sync(0xffffffffu, dot[0], off);
                }
              }
            }
            if (kFull || row < valid) {
              // int8: the row's K scale multiplies its dot (never read past valid)
              float x = dot[0] * (kInt8 ? ksc[row] * scale : scale);
              if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
              sc[n] = x;
            }
          }
        }
        // head hd's online softmax over the warp's rows (the reductions run
        // over the row bits; every lane of a head ends with the same m, l)
        float mx = kNeg;
#pragma unroll
        for (int n = 0; n < kNB; ++n) mx = fmaxf(mx, sc[n]);
#pragma unroll
        for (int off = kLPR; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(mh, mx);
        const float corr = exp2_approx((mh - m_new) * kLog2e);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          const float p = sc[n] <= kNeg ? 0.f : exp2_approx((sc[n] - m_new) * kLog2e);
          sc[n] = p;
          sum += p;
        }
#pragma unroll
        for (int off = kLPR; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        lh = lh * corr + sum;
        mh = m_new;
        // rescale only the heads whose max moved (corr is 1 exactly where
        // it did not, and warp-uniform)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float cg = __shfl_sync(0xffffffffu, corr, g * kRep);
          if (cg != 1.f) {
#pragma unroll
            for (int e = 0; e < kDL; ++e) acc[g][e] *= cg;
          }
        }
        // PV with p in f32, over the valid rows only (int8: p times the
        // row's V scale); the row's lanes gather every head's probability
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          const int row = r0 + (n * kCWarps + warp) * kRPW + rr;
          const float pv = kInt8 && (kFull || row < valid) ? sc[n] * vsc[row] : sc[n];
          float pw[G];
#pragma unroll
          for (int g = 0; g < G; ++g) pw[g] = __shfl_sync(0xffffffffu, pv, rr * kLPR + g * kRep);
          if (kFull || row < valid) {
#pragma unroll
            for (int c = 0; c < kCPL; ++c) {
              float vf[kE];
              widen<kE>(vt + size_t(row) * D + kE * (jl + kLPR * c), vf);
#pragma unroll
              for (int g = 0; g < G; ++g)
#pragma unroll
                for (int e = 0; e < kE; ++e) acc[g][kE * c + e] = fmaf(pw[g], vf[e], acc[g][kE * c + e]);
            }
          }
        }
      };
      int r0 = 0;
      if constexpr (kFullBatches)
        for (; r0 + kBatchRows <= valid; r0 += kBatchRows) batch(r0, std::true_type{});
      for (; r0 < valid; r0 += kBatchRows) batch(r0, std::false_type{});
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
          for (int e = 0; e < kE; ++e)
            red[(warp * G + g) * D + kE * (jl + kLPR * c) + e] = acc[g][kE * c + e];
    }
    if (rr == 0 && jl % kRep == 0) {
      mw[warp * G + hd] = mh;
      lw[warp * G + hd] = lh;
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
  const float *k_scale, *v_scale;
  const int *lengths, *table;
  void* out;
  int B, H, Hkv, P, ps, tr, Tp, T;
  long long rsb, rsh;  // dense: K/V strides in rows
  long long ssb, ssh;  // dense int8: scale strides in elements
  int dense, qpr, cluster, stages, smem;
  float scale, softcap;
};

template <typename TKV, int D, int G>
cudaError_t launch_cluster(const ClusterArgs& a, cudaStream_t stream) {
  const ClusterLayout L = cluster_layout(G, D, a.tr, a.stages, int(sizeof(TKV)));
  // the plan's shared memory must be this kernel's layout
  if (int(L.total) != a.smem || L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = decode_cluster_kernel<TKV, D, G>;
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
                            static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
                            a.k_scale, a.v_scale, a.lengths, a.table, static_cast<bf16*>(a.out),
                            a.H, a.Hkv, a.P, a.ps, a.tr, a.Tp, a.T, a.rsb, a.rsh, a.ssb, a.ssh,
                            a.dense, a.qpr, a.stages, a.scale, a.softcap);
}

template <typename TKV, int D>
cudaError_t launch_cluster_g(const ClusterArgs& a, cudaStream_t stream) {
  switch (a.H / a.Hkv) {
    case 1:
      return launch_cluster<TKV, D, 1>(a, stream);
    case 2:
      return launch_cluster<TKV, D, 2>(a, stream);
    case 4:
      return launch_cluster<TKV, D, 4>(a, stream);
    case 8:
      return launch_cluster<TKV, D, 8>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TKV>
cudaError_t launch_cluster_d(int D, const ClusterArgs& a, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_cluster_g<TKV, 64>(a, stream);
    case 128:
      return launch_cluster_g<TKV, 128>(a, stream);
    case 256:
      return launch_cluster_g<TKV, 256>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of decode_cluster_kernel over tiles of tile_rows rows. q [B,
// H, D] bf16; lengths [B] i32; out [B, H, D] bf16. kv_int8 0: a bf16
// cache, k_scale / v_scale unused; 1: an int8 cache with f32 scales.
// Paged (dense == 0): k/v pool [P, Hkv, page_rows, D] contiguous
// (page_rows a multiple of tile_rows), scales [P, Hkv, page_rows]
// contiguous, table [B, Tp] i32 (physical pages clamped into [0, P-1]).
// Dense: k/v cache [B, Hkv, T, D] with rows of D contiguous elements at
// element strides kv_sb / kv_sh (whole rows), scales [B, Hkv, T] at element
// strides sc_sb / sc_sh with rows of stride 1, lengths clamped to T, table
// null, page_rows unused; qpr (>= 1) query rows share a cache row (query
// row r reads cache row r / qpr, B a multiple of qpr; 1 when paged). cluster (1..8), stages and smem come from
// decode_launch_plan; smem must equal cluster_layout's total. Every K/V
// base, and every row, must be 16-byte aligned (the bulk copies' rule);
// scales need only their own 4-byte alignment. softcap <= 0 disables the
// soft cap. Returns the cudaError_t of the launch.
extern "C" int lstpu_decode(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* lengths, const void* table,
                            void* out, int B, int H, int Hkv, int D, int P, int page_rows,
                            int tile_rows, int Tp, int T, long long kv_sb, long long kv_sh,
                            long long sc_sb, long long sc_sh, int kv_int8, int dense, int qpr,
                            int cluster,
                            int stages, int smem, float scale, float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || tile_rows <= 0 || cluster < 1 ||
      cluster > kMaxCluster || stages < 1)
    return int(cudaErrorInvalidValue);
  if (dense ? (T <= 0 || kv_sb % D != 0 || kv_sh % D != 0)
            : (P <= 0 || Tp <= 0 || !table || page_rows % tile_rows != 0))
    return int(cudaErrorInvalidValue);
  if (kv_int8 && (!k_scale || !v_scale)) return int(cudaErrorInvalidValue);
  if (qpr < 1 || B % qpr != 0 || (!dense && qpr != 1)) return int(cudaErrorInvalidValue);
  const ClusterArgs a{q, k, v, static_cast<const float*>(k_scale),
                      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
                      static_cast<const int*>(table), out, B, H, Hkv, P,
                      dense ? tile_rows : page_rows, tile_rows, Tp, T, kv_sb / D, kv_sh / D,
                      sc_sb, sc_sh, dense, qpr, cluster, stages, smem, scale, softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(kv_int8 ? launch_cluster_d<int8_t>(D, a, st) : launch_cluster_d<bf16>(D, a, st));
}
