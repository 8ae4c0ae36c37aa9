// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (Pallas TPU kernel, body _kernel; wrapper ops.py::flash_attention) and
// computes the same function: online-softmax attention, GQA (query head h
// reads kv head h / (H/KV)), scale D**-0.5, optional tanh soft-cap, masks by
// absolute position (kv_pos >= 0; causal kv_pos <= q_pos; window
// q_pos - kv_pos < window), fp32 m/l/acc, output acc / max(l, 1e-20), so a
// fully masked row gives 0.
//
// What bounds it on the H100: operations. At the serving shape (S=1024,
// D=64) each q/k/v byte feeds hundreds of multiply-adds, well above the
// ~295 operations per byte where the card stops being memory-bound, so the
// design is about keeping the tensor cores fed.
//
// bf16 inputs (the serving path) run flash_fwd_wgmma, the FlashAttention-3
// shape of the forward:
//  * A block owns 128 query rows of one (batch, head): two consumer
//    warpgroups of 64 rows each and one producer warp (288 threads, one
//    block per SM). Grid (H, B, q tiles) with the q tiles in reverse, so the
//    causal blocks with the most kv tiles start first and the short ones
//    fill the tail.
//  * The producer loads through TMA (cp.async.bulk.tensor, 4-D tensor maps
//    over the model's strided (B, S, H, D) layout; rows past S arrive as
//    zeros) into 128-byte-swizzled shared memory: Q once per block, then K
//    and V tiles into a ring of STAGES stages. A "full" mbarrier per stage
//    counts the bytes in; an "empty" mbarrier per stage (one arrival per
//    consumer warp) hands the stage back.
//  * Each consumer warpgroup computes S = Q K^T with wgmma (both operands
//    K-major in shared memory), the online softmax in registers with
//    ex2.approx (log2 e and the scale folded into one FMA), and O += P V
//    with wgmma, A = P from
//    registers (the S accumulator's layout is the A fragment's, rounded to
//    bf16 as FlashAttention-2/3 do; the Pallas body keeps P in fp32) and
//    B = V from shared memory with the transpose bit (V is d-contiguous).
//    m, l (summed from the unrounded P) and O stay fp32 in registers. A
//    tile's P V is issued after the next tile's S and runs on the tensor
//    cores while that tile's softmax runs on the CUDA cores (the
//    FlashAttention-3 intra-warpgroup overlap); its stage goes back to the
//    producer once it is done. The two warpgroups also take turns to issue
//    their wgmma (two named barriers, FlashAttention-3's ping-pong), so that
//    one's softmax tends to run while the other's products do. The first
//    tile is peeled off the loop, so that inside it every wgmma and its wait
//    are unconditional: ptxas serializes every wgmma it cannot pair with a
//    wait on all paths (its notes C7515, C7520).
//  * Tiles are classed by the producer from positions, not indices: the
//    block's least and greatest q_pos against the tile's least and greatest
//    valid kv_pos and whether any slot is empty (< 0, or past Skv). An
//    empty tile (no slot visible to any row) is neither loaded nor
//    computed; a full tile (every slot visible to every row) skips the
//    per-element mask; a partial tile masks each element against the row's
//    visible range [lo, hi] of kv positions, computed once per row. Soft-cap
//    runs only when softcap > 0.
//  * Shared memory: Q 128 x D bf16, and per stage a K and a V tile of BKV x
//    D bf16 (BKV = 128 for D = 64, 64 for D = 128), each as 64-column
//    (128-byte) blocks: D = 64 is 16 + 3 x (16 + 16) = 112 KB, D = 128 is
//    32 + 3 x (16 + 16) = 128 KB, plus 1 KB to align the ring to 1024 bytes
//    (the swizzle's period), within the 227 KB a block may have.
//
// fp32 inputs run flash_fwd_simt: fp32 arithmetic on the CUDA cores, so the
// result keeps fp32 precision (a bf16 or tf32 product would not). Its
// ceiling is the 67 TFLOP/s fp32 rate. The model serves in bf16; fp32 is for
// checks. One block per (q tile of 64 rows, q head, batch); a kv tile that no
// row of the block can see is skipped whole.
//
// Inputs are read in the model's (B, S, H, D) layout through strides, so the
// wrapper makes no transposed or padded copies. Ragged Sq and Skv are masked
// inside the kernels: rows past Sq are never stored, kv rows past Skv are
// zeros with position -1.
//
// Training needs the per-row log-sum-exp for the backward pass
// (flash_attention_bwd.cu). Both kernels take it as a template flag: the
// entry flash_attention_fwd_lse instantiates them with LSE = true and writes
// lse (B, H, Sq) fp32, natural log, +inf for a row that sees nothing; the
// serving entry flash_attention_fwd instantiates LSE = false, which compiles
// to the kernel without that store.
#include <cuda.h>           // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // kv rows per tile
constexpr float NEG_INF = -1073741824.0f;  // -2**30, as the reference

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  if (kp < 0) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && (long long)qp - (long long)kp >= (long long)window) return false;
  return true;
}

// Loads the block's query positions; returns the least and greatest of the
// rows that exist (for the conservative tile skip).
__device__ __forceinline__ void load_q_positions(const int* q_pos, int b, int q0,
                                                 int Sq, int* sQp, int* s_qmin,
                                                 int* s_qmax) {
  const int tid = threadIdx.x;
  if (tid == 0) { *s_qmin = 0x7fffffff; *s_qmax = (int)0x80000000; }
  __syncthreads();
  if (tid < BQ) {
    const int row = q0 + tid;
    const int p = row < Sq ? q_pos[(long long)b * Sq + row] : 0;
    sQp[tid] = p;
    if (row < Sq) { atomicMin(s_qmin, p); atomicMax(s_qmax, p); }
  }
  __syncthreads();
}

// Loads the tile's kv positions; true (for every thread) if any query row of
// the block can see any slot of the tile. Starts with a barrier, so the
// previous tile's shared memory is no longer read when it returns.
__device__ __forceinline__ bool load_kv_positions(const int* kv_pos, int b, int k0,
                                                  int Skv, int* sKp, int qmin,
                                                  int qmax, int causal, int window) {
  __syncthreads();
  int seen = 0;
  if (threadIdx.x < BK) {
    const int j = k0 + threadIdx.x;
    const int p = j < Skv ? kv_pos[(long long)b * Skv + j] : -1;
    sKp[threadIdx.x] = p;
    seen = p >= 0 && !(causal && p > qmax) &&
           !(window > 0 && (long long)qmin - (long long)p >= (long long)window);
  }
  return __syncthreads_or(seen) != 0;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;         // query rows per block: two warpgroups of 64
constexpr int TC_THREADS = 288;    // 2 consumer warpgroups + 1 producer warp
constexpr int CONSUMER_WARPS = 8;
constexpr int STAGES = 3;          // K/V ring depth
constexpr int CLS_PARTIAL = 0, CLS_FULL = 1, CLS_END = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct TcCfg {
  static constexpr int BKV = D == 64 ? 128 : 64;  // kv rows per tile
  static constexpr int CB = D / 64;               // 64-column (128-byte) blocks
  static constexpr int Q_BYTES = TC_BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;    // one K or one V tile
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spins until the barrier's current phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (coordinates innermost first: d, head, row,
// batch) into shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int d, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a tile stored as 128-byte rows with the
// 128-byte swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start
// address, leading byte offset (K-major: unused; MN-major: the stride from
// one 64-column block to the next), stride byte offset 1024 (8 rows).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo_bytes) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) |
         (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// named barriers 1 and 2 (0 is __syncthreads) between the two consumer
// warpgroups, 256 threads each: one warpgroup syncs, the other arrives
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that owns it
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma m64nNk16, bf16 in, fp32 accumulate. _ss: A and B from shared memory,
// both K-major; scale_d = 0 overwrites d. _rs: A from registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), B MN-major (transposed),
// accumulating into d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far below what a bf16 P keeps)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the kv positions a query at position qp sees, as [lo, hi] (empty when
// lo > hi): kv_pos >= 0; causal kv_pos <= qp; window qp - kv_pos < window
__device__ __forceinline__ int2 visible_range(int qp, int causal, int window) {
  long long lo = 0;
  if (window > 0) lo = max(lo, (long long)qp - (long long)window + 1);
  return make_int2((int)min(lo, (long long)INT_MAX), causal ? qp : INT_MAX);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// O += P V over one kv tile: BKV/16 wgmma with A = P from registers and B =
// the V tile at v_addr (MN-major: d is contiguous), committed as one group
template <int D, int BKV>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[BKV / 16][4],
                                         uint32_t v_addr) {
  wgmma_fence();   // a pipeline stage of its own (ptxas C7515 otherwise)
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk], sw128_desc(v_addr + kk * 16 * 128, BKV * 128));
  wgmma_commit();
}

template <int D, bool LSE>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ o, int Sq, int Skv,
    int H, int KV, int causal, int window, float scale, float softcap,
    float* __restrict__ lse) {
  using C = TcCfg<D>;
  constexpr int BKV = C::BKV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES], q_bar;
  __shared__ __align__(8) int s_kvpos[STAGES][BKV];
  __shared__ int s_cls[STAGES];

  // the swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + C::Q_BYTES;                 // [STAGES][CB][BKV][64]
  uint8_t* sV = sK + STAGES * C::KV_BYTES;       // [STAGES][CB][BKV][64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;   // heaviest tiles first
  const int kvh = h / (H / KV);
  // read through a shuffle so that the compiler knows them uniform over a
  // warp: a wgmma on a path it thinks divergent is serialized (ptxas C7520)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], CONSUMER_WARPS);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ---- producer warp: classify kv tiles, load Q once and K/V by TMA ----
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int r = lane; r < TC_BQ; r += 32) {
      if (q0 + r < Sq) {
        const int p = q_pos[(long long)b * Sq + q0 + r];
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      }
    }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);
    if (lane == 0) {
      mbar_expect_tx(&q_bar, C::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < C::CB; ++cb)
        tma_load_4d(sQ + cb * TC_BQ * 128, &tm_q, &q_bar, cb * 64, h, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < Skv; k0 += BKV) {
      int pos[BKV / 32];
      int kmin = INT_MAX, kmax = INT_MIN, neg = 0;
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i) {
        const int j = k0 + lane + 32 * i;
        const int p = j < Skv ? kv_pos[(long long)b * Skv + j] : -1;
        pos[i] = p;
        if (p < 0) {
          neg = 1;
        } else {
          kmin = min(kmin, p);
          kmax = max(kmax, p);
        }
      }
      kmin = warp_min(kmin);
      kmax = warp_max(kmax);
      neg = __any_sync(0xffffffffu, neg);
      const bool none = kmax < 0 ||
                        (causal && kmin > qmax) ||
                        (window > 0 && (long long)qmin - (long long)kmax >= (long long)window);
      if (none) continue;                        // empty: not loaded, not computed
      const bool full = !neg && (!causal || kmax <= qmin) &&
                        (window <= 0 || (long long)qmax - (long long)kmin < (long long)window);
      mbar_wait(&empty_bar[stage], phase ^ 1);
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i) s_kvpos[stage][lane + 32 * i] = pos[i];
      if (lane == 0) s_cls[stage] = full ? CLS_FULL : CLS_PARTIAL;
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full_bar[stage], 2 * C::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < C::CB; ++cb) {
          tma_load_4d(sK + stage * C::KV_BYTES + cb * BKV * 128, &tm_k, &full_bar[stage],
                      cb * 64, kvh, k0, b);
          tma_load_4d(sV + stage * C::KV_BYTES + cb * BKV * 128, &tm_v, &full_bar[stage],
                      cb * 64, kvh, k0, b);
        }
      }
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    mbar_wait(&empty_bar[stage], phase ^ 1);     // hand over "no more tiles"
    if (lane == 0) {
      s_cls[stage] = CLS_END;
      mbar_arrive(&full_bar[stage]);
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows in the block
    const int row_lo = q0 + r_lo, row_hi = row_lo + 8;
    const int2 vis_lo = visible_range(row_lo < Sq ? q_pos[(long long)b * Sq + row_lo] : 0,
                                      causal, window);
    const int2 vis_hi = visible_range(row_hi < Sq ? q_pos[(long long)b * Sq + row_hi] : 0,
                                      causal, window);
    // in units of log2: s * ks (no soft-cap) or tanh(s scale / cap) cap log2 e
    const float ks = softcap > 0.f ? 1.f : scale * LOG2E;
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
    const float cap_out = softcap * LOG2E;

    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * 128;
    float s[BKV / 2];
    uint32_t pa[BKV / 16][4];      // P of the previous tile, the A fragment of its P V

    // S = Q K^T for the tile in `stage` (D/16 k-steps of 16 columns, 32
    // bytes, in a 128-byte block), committed as one group. The first k-step
    // overwrites s (scale-d = 0): no other instruction may write an
    // accumulator inside the pipeline (ptxas C7515 would serialize every
    // wgmma).
    auto issue_s = [&](int stage) {
      const uint32_t k_addr = smem_u32(sK + stage * C::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const uint32_t col = (k & 3) * 32;
        wgmma_ss<BKV>(s, sw128_desc(q_addr + (k >> 2) * TC_BQ * 128 + col, 16),
                      sw128_desc(k_addr + (k >> 2) * BKV * 128 + col, 16), k > 0);
      }
      wgmma_commit();
    };
    // the online softmax of the tile in s (s[4n + e]: row lo (e < 2) or hi,
    // kv column 8n + 2t + (e & 1)): s becomes P, m and l move on; returns
    // the factors alpha by which O must be rescaled
    auto softmax = [&](int stage, int cls) {
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] = tanhf(s[i] * cap_in) * cap_out;
      }
      if (cls == CLS_PARTIAL) {
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {   // kv columns 8n + 2t, 8n + 2t + 1
          const int2 kp = *reinterpret_cast<const int2*>(&s_kvpos[stage][n * 8 + 2 * t]);
          if (kp.x < vis_lo.x || kp.x > vis_lo.y) s[4 * n] = -INFINITY;
          if (kp.y < vis_lo.x || kp.y > vis_lo.y) s[4 * n + 1] = -INFINITY;
          if (kp.x < vis_hi.x || kp.x > vis_hi.y) s[4 * n + 2] = -INFINITY;
          if (kp.y < vis_hi.x || kp.y > vis_hi.y) s[4 * n + 3] = -INFINITY;
        }
      }
      // m stays finite (NEG_INF at first), so a row with nothing visible yet
      // keeps alpha = 1 and p = exp2(-inf) = 0
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < BKV / 2; i += 4) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[i], s[i + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[i + 2], s[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo * ks), mn_hi = fmaxf(m_hi, mx_hi * ks);
      const float2 alpha = make_float2(ex2(m_lo - mn_lo), ex2(m_hi - mn_hi));
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 2; i += 4) {
        s[i] = ex2(fmaf(s[i], ks, -mn_lo));
        s[i + 1] = ex2(fmaf(s[i + 1], ks, -mn_lo));
        s[i + 2] = ex2(fmaf(s[i + 2], ks, -mn_hi));
        s[i + 3] = ex2(fmaf(s[i + 3], ks, -mn_hi));
        sum_lo += s[i] + s[i + 1];
        sum_hi += s[i + 2] + s[i + 3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
      }
      l_lo = l_lo * alpha.x + sum_lo;
      l_hi = l_hi * alpha.y + sum_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
      return alpha;
    };
    // k-step kk of P V takes kv columns 16kk..16kk+15: the S accumulators
    // of n-tiles 2kk and 2kk+1, which are the A fragment once in bf16
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // Ping-pong: the warpgroups take turns to issue their wgmma (named
    // barrier 1 + wg is this warpgroup's turn), so that one's softmax runs
    // while the other's products run. Warpgroup 0 goes first.
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    if (wg == 1) named_arrive(other_turn);

    mbar_wait(&q_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(&full_bar[stage], phase);
    int cls = __shfl_sync(0xffffffffu, s_cls[stage], 0);
    if (cls != CLS_END) {
      // the first tile: O is still 0, so there is no P V to run behind it
      named_sync(my_turn);
      issue_s(stage);
      named_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(stage, cls);
      pack_p();
      int prev = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      for (;;) {
        mbar_wait(&full_bar[stage], phase);
        cls = __shfl_sync(0xffffffffu, s_cls[stage], 0);
        if (cls == CLS_END) break;
        // S of this tile, then the previous tile's O += P V, which the
        // tensor cores run while this tile's softmax runs on the CUDA cores
        named_sync(my_turn);
        issue_s(stage);
        issue_pv<D, BKV>(acc, pa, smem_u32(sV + prev * C::KV_BYTES));
        named_arrive(other_turn);
        wgmma_wait<1>();
        fence_regs(s);
        const float2 alpha = softmax(stage, cls);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty_bar[prev]);   // its stage goes back
#pragma unroll
        for (int i = 0; i < D / 2; i += 4) {
          acc[i] *= alpha.x; acc[i + 1] *= alpha.x;
          acc[i + 2] *= alpha.y; acc[i + 3] *= alpha.y;
        }
        pack_p();
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      issue_pv<D, BKV>(acc, pa, smem_u32(sV + prev * C::KV_BYTES));  // the last tile's
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (wg == 0) named_sync(my_turn);   // takes warpgroup 1's last arrival

    const float inv_lo = 1.f / fmaxf(l_lo, 1e-20f), inv_hi = 1.f / fmaxf(l_hi, 1e-20f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (row_lo < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row_lo) * H + h) * D + c) =
            __floats2bfloat162_rn(acc[4 * n] * inv_lo, acc[4 * n + 1] * inv_lo);
      if (row_hi < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row_hi) * H + h) * D + c) =
            __floats2bfloat162_rn(acc[4 * n + 2] * inv_hi, acc[4 * n + 3] * inv_hi);
    }
    if constexpr (LSE) {
      // m is in log2 units (scores times ks, or the capped score times log2 e)
      if (t == 0 && row_lo < Sq)
        lse[((long long)b * H + h) * Sq + row_lo] =
            l_lo > 0.f ? (m_lo + log2f(l_lo)) * LN2 : INFINITY;
      if (t == 0 && row_hi < Sq)
        lse[((long long)b * H + h) * Sq + row_hi] =
            l_hi > 0.f ? (m_hi + log2f(l_hi)) * LN2 : INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int SIMT_THREADS = 256;  // 16 x 16, 4 rows x 4 kv columns each

template <int D>
constexpr int simt_smem_floats() {
  return BQ * (D + 4)      // sQ  [BQ][D+4], pre-scaled
       + D * (BK + 1)      // sKt [D][BK+1], K transposed
       + BK * D            // sV  [BK][D]
       + BQ * (BK + 4);    // sP  [BQ][BK+4], probabilities of the tile
}

template <int D, bool LSE>
__global__ void __launch_bounds__(SIMT_THREADS) flash_fwd_simt(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, float* __restrict__ o, int Sq, int Skv,
    int H, int KV, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int window, float scale,
    float softcap, float* __restrict__ lse) {
  constexpr int CO = D / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKt = sQ + BQ * (D + 4);
  float* sV = sKt + D * (BK + 1);
  float* sP = sV + BK * D;
  __shared__ int sQp[BQ];
  __shared__ int sKp[BK];
  __shared__ int s_qmin, s_qmax;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < BQ * D; i += SIMT_THREADS) {
    const int r = i / D, d = i % D, row = q0 + r;
    sQ[r * (D + 4) + d] = row < Sq ? qb[row * q_ss + d] * scale : 0.f;
  }
  load_q_positions(q_pos, b, q0, Sq, sQp, &s_qmin, &s_qmax);
  const int qmin = s_qmin, qmax = s_qmax;
  int my_qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) my_qp[i] = sQp[ty * 4 + i];

  float m[4], l[4], acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF; l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    if (!load_kv_positions(kv_pos, b, k0, Skv, sKp, qmin, qmax, causal, window))
      continue;
    for (int i = tid; i < BK * D; i += SIMT_THREADS) {
      const int j = i / D, d = i % D, row = k0 + j;
      const bool in = row < Skv;
      sKt[d * (BK + 1) + j] = in ? kb[row * k_ss + d] : 0.f;
      sV[j * D + d] = in ? vb[row * v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores for rows ty*4+i, kv columns tx + 16*c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * (D + 4) + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sKt[d * (BK + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        ok[c] = visible(my_qp[i], sKp[tx + 16 * c], causal, window);
        x = ok[c] ? x : NEG_INF;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += p;
        sP[(ty * 4 + i) * (BK + 4) + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[CO];
#pragma unroll
      for (int c = 0; c < CO; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty * 4 + i) * (BK + 4) + j];
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* orow = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    if constexpr (LSE) {
      if (tx == 0)
        lse[((long long)b * H + h) * Sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* o;
  float* lse;     // null: the serving kernels, which write no LSE
  int B, Sq, Skv, H, KV;
  const long long* st;
  int causal, window;
  float scale, softcap;
  cudaStream_t stream;
};

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a (B, S, heads, D) bf16 tensor with element strides st[0..2]
// (batch, sequence, head) and a dense D; boxes of 64 columns (128 bytes,
// the 128-byte swizzle's width) x 1 head x `rows` rows x 1 batch. Rows past
// S read as zeros. A size-1 dim's stride is free in torch; TMA wants it
// nonzero, so it gets the extent below it.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D,
              const long long* st, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[0] * 2};
  cuuint64_t below = (cuuint64_t)D * 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1 || strides[i] == 0) strides[i] = below;
    below = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool LSE>
int launch_wgmma(const Args& a) {
  using C = TcCfg<D>;
  for (int i = 0; i < 9; ++i)
    if (a.st[i] % 8) return (int)cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, a.q, a.B, a.Sq, a.H, D, a.st, TC_BQ) ||
      !make_map(&tk, a.k, a.B, a.Skv, a.KV, D, a.st + 3, C::BKV) ||
      !make_map(&tv, a.v, a.B, a.Skv, a.KV, D, a.st + 6, C::BKV))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, a.B, (a.Sq + TC_BQ - 1) / TC_BQ);
  flash_fwd_wgmma<D, LSE><<<grid, TC_THREADS, C::SMEM, a.stream>>>(
      tq, tk, tv, a.q_pos, a.kv_pos, static_cast<__nv_bfloat16*>(a.o), a.Sq, a.Skv, a.H,
      a.KV, a.causal, a.window, a.scale, a.softcap, a.lse);
  return (int)cudaGetLastError();
}

template <int D, bool LSE>
int launch_simt(const Args& a) {
  constexpr int bytes = simt_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_simt<D, LSE><<<grid, SIMT_THREADS, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.q_pos, a.kv_pos, static_cast<float*>(a.o),
      a.Sq, a.Skv, a.H, a.KV, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4],
      a.st[5], a.st[6], a.st[7], a.st[8], a.causal, a.window, a.scale, a.softcap, a.lse);
  return (int)cudaGetLastError();
}

template <bool LSE>
int run(const Args& a, int D, int dtype) {
  if (a.B <= 0 || a.Sq <= 0 || a.Skv <= 0 || a.KV <= 0 || a.H % a.KV != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return launch_simt<64, LSE>(a);
  if (dtype == 0 && D == 128) return launch_simt<128, LSE>(a);
  if (dtype == 1 && D == 64) return launch_wgmma<64, LSE>(a);
  if (dtype == 1 && D == 128) return launch_wgmma<128, LSE>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (in elements) for q, k, v:
// batch, sequence, head, in that order, nine values; the head dim is dense.
// bf16 needs strides that are multiples of 8 and 16-byte aligned pointers.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, int B, int Sq, int Skv, int H, int KV, int D,
    int dtype, const long long* strides, int causal, int window, float scale,
    float softcap, void* stream) {
  const Args a{q, k, v, q_pos, kv_pos, o, nullptr, B, Sq, Skv, H, KV, strides,
               causal, window, scale, softcap, static_cast<cudaStream_t>(stream)};
  return run<false>(a, D, dtype);
}

// The same, and the per-row log-sum-exp into lse, (B, H, Sq) fp32.
extern "C" int flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, float* lse, int B, int Sq, int Skv, int H, int KV,
    int D, int dtype, const long long* strides, int causal, int window, float scale,
    float softcap, void* stream) {
  const Args a{q, k, v, q_pos, kv_pos, o, lse, B, Sq, Skv, H, KV, strides,
               causal, window, scale, softcap, static_cast<cudaStream_t>(stream)};
  return run<true>(a, D, dtype);
}
