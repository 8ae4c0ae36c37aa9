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
//
// The TMA, mbarrier and wgmma helpers are in hopper.cuh, shared with the
// backward.
#include "hopper.cuh"

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

template <int D>
struct TcCfg {
  static constexpr int BKV = D == 64 ? 128 : 64;  // kv rows per tile
  static constexpr int CB = D / 64;               // 64-column (128-byte) blocks
  static constexpr int Q_BYTES = TC_BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;    // one K or one V tile
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES;
};

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
