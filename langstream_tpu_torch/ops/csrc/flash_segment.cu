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
// (O((o + S) * Hkv * D) bytes from device memory), so past a few hundred
// tokens the bound is operations. Each CTA streams its K/V prefix from L2,
// so the kernel keeps the tensor cores fed and makes each K/V tile in
// shared memory feed as many rows as it can.
//
// Design: the FlashAttention-3 shape. A work item is 128 (query position,
// head) rows of one kv-head group, position-major (G = 4: 32 positions x 4
// heads), so each K/V tile in shared memory feeds every head of the group.
// The grid is persistent: one CTA per SM walks its items, heaviest first.
// Three warpgroups:
//   - a producer: one thread issues TMA loads (cp.async.bulk.tensor) of each
//     item's Q tile and of its K and V tiles (128 keys; 64 at D = 256) into
//     a ring of stages with a full and an empty mbarrier each. It runs ahead
//     into the next item while the consumers finish the current one. The
//     tensor maps take the cache view's own dims and byte strides, so a
//     [..., :T] view of a wider cache is read in place; TMA zero-fills rows
//     past T.
//   - two consumers of 64 rows each run wgmma: S = Q K^T with both operands
//     in shared memory (128-byte swizzle, K-major), O += P V with P in
//     registers as the A operand and V as a transposed (MN-major) B operand.
//     setmaxnreg moves registers from the producer to them.
// The softmax overlaps the products twice: the consumers take turns
// (ping-pong through two named barriers) issuing their wgmmas, so one
// warpgroup's softmax runs under the other's products; and each issues
// QK^T of tile j together with PV of tile j - 1, so its own PV runs while
// it takes the softmax of tile j. The scalar work stays lean: the log2
// domain with one ex2.approx per probability, 1/l once, and the causal
// mask only on tiles that cross a warp's first diagonal or the frontier;
// the rescale of O is skipped where no row max of the warp moved. Each
// item loops only to its causal frontier min(T, offset + tile end); keys
// past the frontier inside the last tile are read (they lie in the view,
// in the engine inside the segment's own rows) and masked. Offsets come
// from a device int32 array (no host sync per segment).
// int8: the producer warpgroup is also a transform stage. TMA brings the
// int8 K/V tiles (64 keys, half the bytes) into a ring of their own; the
// producer's 128 threads read the f32 scales with plain loads (scale rows
// of a sink-column cache are 8,193 floats, not the 16-byte multiple TMA
// needs), dequantize bf16(float(q) * s) — the TPU kernel's rounding — into
// the swizzled bf16 stage the consumers read (zeroing rows past the
// frontier), and arrive on its full barrier. So the dequantize runs beside
// the products instead of between them; it still takes issue slots from
// the softmax. Not yet: TMA multicast of K/V across a cluster (halving the
// L2 traffic), a TMA store of the output, fp8.

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

using bf16 = __nv_bfloat16;

constexpr int kConsumerWGs = 2;
constexpr int kThreads = 128 * (kConsumerWGs + 1);  // the consumers, then the producer
constexpr int kRows = 64 * kConsumerWGs;            // (position, head) rows of one CTA
// registers per thread at launch: __launch_bounds__(kThreads, 1) caps them
// at the register file over the threads, in steps of 8
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kAtom = 64;     // bf16 columns of one 128-byte swizzle atom row

template <typename TKV, int D>
struct Layout {
  static constexpr bool kInt8 = sizeof(TKV) == 1;
  static constexpr int kAtoms = D / kAtom;
  // keys per K/V tile: 128 where shared memory holds a ring of them, else 64
  static constexpr int kBK = kInt8 || D == 256 ? 64 : 128;
  static constexpr int kStages = D == 256 ? 2 : (kBK == 128 && D == 128 ? 3 : 4);  // bf16 ring
  static constexpr int kRawStages = kInt8 ? (D == 256 ? 1 : 2) : 0;  // int8 TMA ring
  // registers per thread after setmaxnreg: a bf16 producer is one thread
  // issuing TMA; an int8 one also dequantizes. setmaxnreg.inc only takes
  // what setmaxnreg.dec gave back, so the split must fit the CTA's launch
  // allocation (kLaunchRegs x kThreads), or the consumers wait forever.
  static constexpr int kProducerRegs = kInt8 ? (D == 256 ? 40 : 56) : 24;
  static constexpr int kConsumerRegs = kInt8 ? (D == 256 ? 232 : 224) : 240;
  static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= kLaunchRegs * kThreads,
                "register split past the CTA's launch allocation");
  static constexpr uint32_t kQBytes = uint32_t(kRows) * D * 2;
  static constexpr uint32_t kTileBytes = uint32_t(kBK) * D * 2;  // one bf16 K (or V) tile
  static constexpr uint32_t kRawBytes = uint32_t(kBK) * D;       // one int8 K (or V) tile
  // byte offsets from the 1024-aligned base (the 128-byte swizzle repeats
  // every 1024 bytes, and wgmma descriptors assume tiles aligned to it)
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kRaw = kV + kStages * kTileBytes;  // [kRawStages][K, V] int8
  static constexpr uint32_t kScales = kRaw + kRawStages * 2 * kRawBytes;  // [2][K, V][kBK] f32
  static constexpr uint32_t kBars = kScales + (kInt8 ? 2 * 2 * kBK * 4 : 0);
  // mbarriers: full[kStages], empty[kStages], raw_full[kRawStages], q_full, q_empty
  static constexpr uint32_t kEnd = kBars + 8 * (2 * kStages + kRawStages + 2);
  static constexpr uint32_t kSmem = kEnd + 1024;  // + the slack that aligns the base
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

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

// 4-d TMA tile load into shared memory, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// generic-proxy shared-memory writes made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin register values at this point of the program: the compiler may not
// move their reads or writes across (wgmma reads and writes them
// asynchronously between issue and wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// wgmma wrappers: d (f32, 64 x N over the warpgroup) += A (64 x 16 bf16) *
// B (16 x N bf16). qk: A and B from shared memory, both K-major;
// pv: A from registers, B transposed (MN-major, the V tile's rows are
// keys). The operand lists are written out, as PTX wants them.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// eight int8 values (two 32-bit words) * scale → eight bf16, rounded once.
// No int-to-float conversion (a quarter-rate op): with its sign bit
// flipped, byte q becomes q + 128 in [0, 255]; placed in the low mantissa of
// 2^23 it reads 2^23 + q + 128, and one exact subtraction gives float(q).
__device__ __forceinline__ uint4 dequant8(uint2 w, float s) {
  const uint32_t u[2] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u};
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    // bytes (u_e, 0, 0, 0x4B) from {0x4B000000 : u}
    const float biased = __uint_as_float(__byte_perm(u[e / 4], 0x4B000000u, 0x7540 | (e % 4)));
    f[e] = (biased - 8388736.f) * s;
  }
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

template <typename TKV, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_segment_kernel(const __grid_constant__ CUtensorMap q_map,  // [B, S, H, D] bf16
                     const __grid_constant__ CUtensorMap k_map,  // [B, Hkv, T, D] view
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ k_scale,  // [B, Hkv, T], strides sc_sb / sc_sh
                     const float* __restrict__ v_scale,
                     const int* __restrict__ offsets,  // [B] global position of q row 0
                     bf16* __restrict__ out,           // [B, S, H, D]
                     int B, int S, int H, int Hkv, int lg, int T, long long sc_sb,
                     long long sc_sh, float scale, float softcap) {
  using L = Layout<TKV, D>;
  constexpr int kBK = L::kBK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw0);
  const uint32_t bars = base + L::kBars;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (L::kStages + s); };
  auto raw_full = [&](int s) { return bars + 8u * (2 * L::kStages + s); };
  const uint32_t q_full = bars + 8u * (2 * L::kStages + L::kRawStages);
  const uint32_t q_empty = q_full + 8u;

  // Work items: (query tile, batch row, kv head). The grid is persistent
  // (one CTA per SM); CTA c takes items in rounds of gridDim.x, snaking
  // (c, then 2 x grid - 1 - c, ...) through an order that puts the heaviest
  // (last) query tiles first, so the rounds even out. Every role of the
  // CTA walks the same items, so rings and barriers stay in step.
  const int P = kRows >> lg;  // query positions per item (G = 1 << lg heads each)
  const int n_qt = (S + P - 1) / P;
  const int per_qt = B * Hkv;
  const int n_items = n_qt * per_qt;
  struct Item {
    int q_start, b, kvh, off, k_end, n_tiles;
  };
  auto item_at = [&](int round, Item& it) -> bool {
    const int c = (round & 1) ? int(gridDim.x) - 1 - int(blockIdx.x) : int(blockIdx.x);
    const int w = round * int(gridDim.x) + c;
    if (w >= n_items) return false;
    it.q_start = (n_qt - 1 - w / per_qt) * P;
    it.b = (w % per_qt) / Hkv;
    it.kvh = w % Hkv;
    it.off = offsets != nullptr ? max(offsets[it.b], 0) : 0;
    // the item's causal frontier: keys past its last query are never visited
    it.k_end = min(T, it.off + min(S, it.q_start + P));
    it.n_tiles = (it.k_end + kBK - 1) / kBK;
    return true;
  };
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), L::kInt8 ? 128 : 1);  // int8: every transform thread arrives
      mbar_init(empty(s), 4 * kConsumerWGs);   // one arrive per consumer warp
    }
#pragma unroll
    for (int s = 0; s < L::kRawStages; ++s) mbar_init(raw_full(s), 1);
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumerWGs);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // ---------------- producer (and, for int8, transform) warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kProducerRegs));
    const int ptid = tid - 128 * kConsumerWGs;
    // the Q tile of item number `round`, once the consumers are done with
    // the previous item's. From the second item on it is loaded after the
    // item's first kStages - 1 tiles, which take ring stages the consumers
    // free while they finish the previous item.
    auto q_after = [&](int round, const Item& it) {
      return round == 0 ? 0 : min(it.n_tiles, L::kStages - 1);
    };
    auto load_q = [&](int round, const Item& it) {
      if (round > 0) mbar_wait(q_empty, (round - 1) & 1);
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int a = 0; a < L::kAtoms; ++a)
        tma_load(base + L::kQ + a * (kRows * 128), &q_map, q_full, a * kAtom, it.kvh << lg,
                 it.q_start, it.b);
    };
    Item it{};
    int g = 0;  // tiles through the bf16 ring so far, over every item
    if constexpr (!L::kInt8) {
      if (ptid != 0) return;
      for (int round = 0; item_at(round, it); ++round) {
        const int qa = q_after(round, it);
        if (qa == 0) load_q(round, it);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % L::kStages;
          if (g >= L::kStages) mbar_wait(empty(s), (g / L::kStages - 1) & 1);
          mbar_expect_tx(full(s), 2 * L::kTileBytes);
#pragma unroll
          for (int a = 0; a < L::kAtoms; ++a) {
            const uint32_t at = s * L::kTileBytes + a * (kBK * 128);
            tma_load(base + L::kK + at, &k_map, full(s), a * kAtom, j * kBK, it.kvh, it.b);
            tma_load(base + L::kV + at, &v_map, full(s), a * kAtom, j * kBK, it.kvh, it.b);
          }
          if (j + 1 == qa) load_q(round, it);
        }
      }
    } else {
      // TMA brings int8 tiles into their own ring (raw stage r of tile g
      // is g % kRawStages, like the bf16 ring's); the 128 threads
      // dequantize each into the bf16 stage the consumers read
      auto issue_raw = [&](const Item& it, int j, int gr) {
        const int r = gr % L::kRawStages;
        const uint32_t dst = base + L::kRaw + r * 2 * L::kRawBytes;
        mbar_expect_tx(raw_full(r), 2 * L::kRawBytes);
        tma_load(dst, &k_map, raw_full(r), 0, j * kBK, it.kvh, it.b);
        tma_load(dst + L::kRawBytes, &v_map, raw_full(r), 0, j * kBK, it.kvh, it.b);
      };
      // the scales of a tile: thread i < kBK reads K's of key i, the rest
      // V's, one tile ahead, into a double-buffered [2][K, V][kBK] array;
      // keys past the frontier get scale 0, so their rows become zeros
      static_assert(2 * kBK == 128, "one scale per transform thread");
      float* scales = reinterpret_cast<float*>(sbase + L::kScales);
      constexpr int kChunks = D / 8;           // 16-byte bf16 chunks per row
      constexpr int kRowStep = 128 / kChunks;  // rows one pass of the threads covers
      constexpr int kIters = kBK / kRowStep;
      const int c = ptid % kChunks;
      for (int round = 0; item_at(round, it); ++round) {
        const int qa = q_after(round, it);
        if (ptid == 0) {
          for (int j = 0; j < min(L::kRawStages, it.n_tiles); ++j) issue_raw(it, j, g + j);
          if (qa == 0) load_q(round, it);
        }
        const float* scb =
            (ptid < kBK ? k_scale : v_scale) + it.b * sc_sb + it.kvh * sc_sh;
        auto load_scale = [&](int j) {
          const int pos = j * kBK + ptid % kBK;
          return pos < it.k_end ? __ldg(scb + pos) : 0.f;
        };
        scales[ptid] = load_scale(0);
        named_sync(3, 128);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int r = g % L::kRawStages;
          const int s = g % L::kStages;
          const float next = j + 1 < it.n_tiles ? load_scale(j + 1) : 0.f;
          mbar_wait(raw_full(r), (g / L::kRawStages) & 1);
          if (g >= L::kStages) mbar_wait(empty(s), (g / L::kStages - 1) & 1);
          const unsigned char* kr = sbase + L::kRaw + r * 2 * L::kRawBytes;
          const unsigned char* vr = kr + L::kRawBytes;
          unsigned char* kd = sbase + L::kK + s * L::kTileBytes;
          unsigned char* vd = sbase + L::kV + s * L::kTileBytes;
          const float* sct = scales + (j & 1) * 2 * kBK;
#pragma unroll
          for (int i = 0; i < kIters; ++i) {
            const int row = ptid / kChunks + i * kRowStep;
            const uint2 kw = *reinterpret_cast<const uint2*>(kr + row * D + c * 8);
            const uint2 vw = *reinterpret_cast<const uint2*>(vr + row * D + c * 8);
            // the 128-byte swizzle TMA would have applied: chunk ^ (row % 8)
            const uint32_t at = (c / 8) * (kBK * 128) + row * 128 + (((c % 8) ^ (row % 8)) * 16);
            *reinterpret_cast<uint4*>(kd + at) = dequant8(kw, sct[row]);
            *reinterpret_cast<uint4*>(vd + at) = dequant8(vw, sct[kBK + row]);
          }
          fence_proxy_async_shared();
          mbar_arrive(full(s));
          if (ptid == 0 && j + 1 == qa) load_q(round, it);
          scales[((j + 1) & 1) * 2 * kBK + ptid] = next;
          named_sync(3, 128);  // raw stage r and this tile's scales are free again
          if (ptid == 0 && j + L::kRawStages < it.n_tiles)
            issue_raw(it, j + L::kRawStages, g + L::kRawStages);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups: 64 rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kConsumerRegs));
    const int w = wg;
    const int t = tid % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g8 = lane >> 2;  // fragment row (and +8)
    const int tig = lane & 3;  // fragment column pair
    const int r0 = 64 * w + 16 * warp + g8;  // this thread's item rows r0 and r0 + 8
    const uint32_t q_tile = base + L::kQ + w * (64 * 128);

    constexpr float kLog2e = 1.4426950408889634f;
    const float scale_log2 = scale * kLog2e;
    const float scale_cap = softcap > 0.f ? scale / softcap : 0.f;
    const float cap_log2 = softcap * kLog2e;

    float o[D / 2];
    float sc[kBK / 2];          // scores, then probabilities, of this tile
    uint32_t pf[kBK / 16][4];   // p in bf16: the A operand of P V
    float m_r[2];               // running max of rows g8 and g8 + 8
    float l_r[2];               // this thread's share of the running sums
    int qpos[2];                // global positions of those rows' queries
    int diag = 0;               // this warp's first query
    Item it{};
    int g = 0;  // tiles through the bf16 ring so far, over every item

    auto issue_qk = [&](int s) {
      const uint32_t kt = base + L::kK + s * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in_atom = (kk % 4) * 32;  // 16 columns into the atom
        wgmma_qk(sc, gmma_desc(q_tile + (kk / 4) * (kRows * 128) + in_atom, 16, 1024),
                 gmma_desc(kt + (kk / 4) * (kBK * 128) + in_atom, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int s) {
      const uint32_t vt = base + L::kV + s * L::kTileBytes;
#pragma unroll
      for (int kb = 0; kb < kBK / 16; ++kb)
        wgmma_pv(o, pf[kb], gmma_desc(vt + kb * 16 * 128, kBK * 128, 1024));
      wgmma_commit();
    };
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(empty(s));
    };
    // scale, soft cap, row maxima (over the quad) and probabilities of tile
    // j; the global causal mask and the frontier only on a tile that
    // crosses this warp's first query's diagonal or the frontier (the rest
    // see every key)
    auto softmax = [&](int j, float (&corr)[2]) {
      const int k0 = j * kBK;
      const bool edge = k0 + kBK - 1 > diag || k0 + kBK > it.k_end;
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        float x = softcap > 0.f ? tanhf(sc[e] * scale_cap) * cap_log2 : sc[e] * scale_log2;
        const int row = (e % 4) / 2;
        if (edge) {
          const int kpos = k0 + 8 * (e / 4) + 2 * tig + (e & 1);
          if (kpos > qpos[row] || kpos >= it.k_end) x = kNeg;
        }
        sc[e] = x;
        mx[row] = fmaxf(mx[row], x);
      }
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
      for (int e = 0; e < kBK / 2; ++e) {
        const int row = (e % 4) / 2;
        const float x = sc[e];
        const float p = (x <= kNeg) ? 0.f : exp2_approx(x - m_r[row]);
        sc[e] = p;
        rs[row] += p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
    };
    // p rounded to bf16 straight from the score accumulators
    auto pack_p = [&]() {
#pragma unroll
      for (int kb = 0; kb < kBK / 16; ++kb) {
        pf[kb][0] = pack_bf16(sc[8 * kb + 0], sc[8 * kb + 1]);
        pf[kb][1] = pack_bf16(sc[8 * kb + 2], sc[8 * kb + 3]);
        pf[kb][2] = pack_bf16(sc[8 * kb + 4], sc[8 * kb + 5]);
        pf[kb][3] = pack_bf16(sc[8 * kb + 6], sc[8 * kb + 7]);
      }
    };

    if (w == 1) named_arrive(1, 256);  // warpgroup 0 issues first
    for (int round = 0; item_at(round, it); ++round) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qpos[i] = it.off + it.q_start + ((r0 + 8 * i) >> lg);
        m_r[i] = kNeg;
        l_r[i] = 0.f;
      }
      diag = it.off + it.q_start + ((64 * w + 16 * warp) >> lg);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

      // Every iteration below has the same shape (QK^T of tile j and PV of
      // tile j - 1 in flight, then wait for 1, then for 0), so ptxas can
      // follow which accumulators are in flight and keeps the wgmmas
      // asynchronous; tile 0 (QK^T alone) is peeled off for that.
      float corr[2];
      mbar_wait(q_full, round & 1);
      int s = g % L::kStages;
      mbar_wait(full(s), (g / L::kStages) & 1);
      named_sync(1 + w, 256);  // this warpgroup's turn on the tensor cores
      fence_regs(o);
      wgmma_fence();
      issue_qk(s);
      named_arrive(2 - w, 256);  // the other warpgroup's turn
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(0, corr);  // O is still 0: nothing to rescale
      pack_p();
      for (int j = 1; j < it.n_tiles; ++j) {
        const int prev = s;
        s = (g + j) % L::kStages;
        mbar_wait(full(s), ((g + j) / L::kStages) & 1);
        named_sync(1 + w, 256);
        fence_regs(sc);
        fence_regs(o);
        wgmma_fence();
        issue_qk(s);
        issue_pv(prev);
        named_arrive(2 - w, 256);
        wgmma_wait<1>();  // QK^T of tile j is done
        fence_regs(sc);
        softmax(j, corr);
        wgmma_wait<0>();  // P V of tile j - 1 is done: its stage is free, O is ours
        release(prev);
        fence_regs(o);
        // past the first tiles a row's max rarely moves: skip the rescale
        // where no row of the warp moved (corr is exactly 1 there)
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e % 4) / 2];
        }
        pack_p();
      }
      // every QK^T of the item is done: the producer may bring the next Q
      if (lane == 0) mbar_arrive(q_empty);
      // P V of the last tile
      fence_regs(o);
      wgmma_fence();
      issue_pv(s);
      wgmma_wait<0>();
      fence_regs(o);
      release(s);
      g += it.n_tiles;

      // finish the row sums over the quad (l_r becomes 1 / l) and write
      // the rows inside S
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
        l_r[i] = 1.f / fmaxf(l_r[i], 1e-30f);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const int pos = it.q_start + (r >> lg);
        if (pos >= S) continue;
        const int h = (it.kvh << lg) + (r & ((1 << lg) - 1));
        bf16* dst = out + ((size_t(it.b) * S + pos) * H + h) * D + tig * 2;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          *reinterpret_cast<__nv_bfloat162*>(dst + c * 8) =
              __floats2bfloat162_rn(o[4 * c + 2 * i] * l_r[i], o[4 * c + 2 * i + 1] * l_r[i]);
        }
      }
    }
    if (w == 0) named_sync(1, 256);  // take warpgroup 1's last turn signal
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// nothing links -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-d tensor map: dims innermost first, byte strides of dims 1..3, box;
// rows past a dim's end are zero-filled
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, const uint64_t* dims,
              const uint64_t* strides, const uint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale;
  const int* offsets;
  void* out;
  int B, S, H, Hkv, T;
  long long kv_sb, kv_sh, sc_sb, sc_sh;
  float scale, softcap;
};

template <typename TKV, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<TKV, D>;
  const int G = a.H / a.Hkv;
  int lg = 0;
  while ((1 << lg) < G) ++lg;
  if ((1 << lg) != G || G > 8) return cudaErrorInvalidValue;
  const int P = kRows / G;
  const uint64_t item = sizeof(TKV);
  CUtensorMap qm, km, vm;
  const uint64_t q_dims[4] = {uint64_t(D), uint64_t(a.H), uint64_t(a.S), uint64_t(a.B)};
  const uint64_t q_strides[3] = {2ull * D, 2ull * a.H * D, 2ull * a.S * a.H * D};
  const uint32_t q_box[4] = {uint32_t(kAtom), uint32_t(G), uint32_t(P), 1};
  const uint64_t kv_dims[4] = {uint64_t(D), uint64_t(a.T), uint64_t(a.Hkv), uint64_t(a.B)};
  const uint64_t kv_strides[3] = {item * D, item * uint64_t(a.kv_sh), item * uint64_t(a.kv_sb)};
  // bf16 tiles land swizzled, as wgmma reads them; int8 tiles land plain
  // for the transform threads
  const uint32_t kv_box[4] = {uint32_t(L::kInt8 ? D : kAtom), uint32_t(L::kBK), 1, 1};
  const CUtensorMapDataType kv_type =
      L::kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle kv_swizzle =
      L::kInt8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.q, q_dims, q_strides, q_box,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&km, kv_type, a.k, kv_dims, kv_strides, kv_box, kv_swizzle) ||
      !make_map(&vm, kv_type, a.v, kv_dims, kv_strides, kv_box, kv_swizzle)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_segment_kernel<TKV, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kSmem));
  if (err != cudaSuccess) return err;
  // persistent: one CTA per SM, or one per item where there are fewer
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((a.S + P - 1) / P) * a.B * a.Hkv;
  const int grid = int(items < sms ? items : sms);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      qm, km, vm, static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      a.offsets, static_cast<bf16*>(a.out), a.B, a.S, a.H, a.Hkv, lg, a.T, a.sc_sb, a.sc_sh,
      a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t launch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<TKV, 64>(a, stream);
    case 128:
      return launch<TKV, 128>(a, stream);
    case 256:
      return launch<TKV, 256>(a, stream);
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
// disables the soft cap. Every K/V byte stride and base must be a multiple
// of 16 (TMA); the wrapper's launch plan checks this before the call.
// Returns the cudaError_t of the launch (0 = success).
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
