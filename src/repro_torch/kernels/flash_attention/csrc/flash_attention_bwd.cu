// Flash attention backward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces no Pallas kernel: the TPU kernel (repro/kernels/flash_attention/
// kernel.py::flash_attention_pallas) has no VJP, and the JAX package trains
// through jax.grad of its jnp oracle (repro/models/attention.py::
// flash_attention_jnp). This is that gradient, for the forward of
// flash_attention.cu: given q, k, v, the forward's output o and per-row
// log-sum-exp lse (natural log; +inf for a row that sees no slot), and dO,
// it returns dq, dk, dv. With s = q.k * scale (or cap * tanh(q.k * scale /
// cap) under a soft-cap), P = exp(s - lse) on visible pairs and 0 elsewhere:
//   delta_i = sum_d dO_id O_id
//   dP = dO V^T,  dS = P * (dP - delta) (* (1 - tanh^2) under a soft-cap)
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K
// Masks are those of the forward (kv_pos >= 0; causal kv_pos <= q_pos;
// window q_pos - kv_pos < window); a row that sees nothing gets dq = 0 and
// adds nothing to dk, dv.
//
// What bounds it on the H100: operations. Per visible (q, kv) pair and head
// it does five products of length D (S, dP, dV, dK, dQ; S and dP twice, once
// in each of the two kernels below), ~14 D operations, against a few bytes
// per row: far above the ~295 operations per byte where the card stops being
// memory-bound. So the design is the forward's (flash_attention.cu): keep
// the tensor cores fed from a TMA ring.
//
// The FlashAttention-2 form, three kernels, no atomics, so every output
// element is summed by one thread in a fixed order and the result is the same
// bits from call to call:
//  * flash_bwd_delta: delta per (batch, head, row), one warp per row.
//  * flash_bwd_dkdv_wgmma: one block per (kv tile of 128 rows, kv head,
//    batch), two consumer warpgroups of 64 kv rows each and a producer
//    warpgroup of which one warp works (384 threads, one block per SM). K
//    and V of the tile come in once by TMA. The producer walks the q tiles
//    of BQ rows that can see the tile and, for each, the G = H / KV query
//    heads of the kv head; per such item it streams Q and dO (TMA) and the
//    rows' lse, delta and visible ranges (plain loads, issued before it
//    waits for a free stage) through a ring of STAGES stages with a full and
//    an empty mbarrier each, as the forward does. Per item each warpgroup
//    computes S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in
//    shared memory), P^T and dS^T in registers, then dV += P^T dO and dK +=
//    dS^T Q (wgmma, A from registers: the S^T and dP^T accumulators rounded
//    to bf16 are the A fragments; B = dO, Q MN-major with the transpose
//    bit). dK and dV are summed over the whole group in registers and
//    written once.
//  * flash_bwd_dq_wgmma: one block per (q tile of 128 rows, head, batch),
//    the forward's structure plus one product: Q and dO once by TMA, the K/V
//    tiles its rows can see through the ring, classed by the producer as the
//    forward classes them (CLS_PARTIAL / CLS_FULL / CLS_END: an empty tile
//    is neither loaded nor computed, a full one skips the per-element mask).
//    Per tile S = Q K^T and dP = dO V^T (wgmma ss), dS in registers, dQ +=
//    dS K (wgmma rs, K MN-major). lse, delta and the visible range of the
//    thread's two rows stay in registers.
// Which tiles a block sees is found by its producer from positions: a scan
// of SCAN tiles' positions with LOADS loads in flight at once gives a bit
// per tile, and only the marked tiles are loaded, classed and computed.
//
// Keeping the tensor cores busy while the CUDA cores compute P and dS (the
// exp2 of every element is the larger part):
//  * S and dP are committed as two wgmma groups, and P is computed as soon
//    as S is in, while the tensor cores run dP; then dS = P (dP - delta).
//    Under a soft-cap dS needs tanh of the raw score, which P replaces, so
//    there both are computed once both are in. The soft-cap is a template
//    flag (CAP) of both kernels, so that neither pays for the other's path.
//  * The products of an item are issued after the next item's S and dP, so
//    they run on the tensor cores while that item's P and dS are computed;
//    the item's stage goes back to the producer once they are done. (Not
//    for dK/dV at D = 128: there the previous item's fragments and the next
//    item's S^T, dP^T do not fit in registers beside dK and dV, so each
//    item's products are waited for before the next item.)
//  * The two consumer warpgroups take turns to issue their wgmma (named
//    barriers, FlashAttention-3's ping-pong, as the forward), so that one's
//    P and dS tend to run while the other's products do.
// At B=4 S=2048 H=15 KV=5 D=64 bf16 causal the three kernels read 0.36 ms
// on an NVIDIA H100 80GB HBM3 at 700 W, against 0.72 ms for the mma.sync
// design they replace (scripts/compare_kernels.py; PERF.md). The first item
// is peeled off the loop and the warp role and tile class are read through
// __shfl_sync, so that ptxas can pair every wgmma with its wait (its notes
// C7515, C7520). P and dS are rounded to bf16 for the dV, dK, dQ products,
// as the forward rounds P and as FlashAttention-2/3 do.
//
// Tile sizes and registers. A consumer thread of dK/dV holds dK and dV (D/2
// fp32 each), S^T and dP^T (BQ/2 each) and their bf16 A fragments (BQ/4
// each): BQ = 64 q rows per item for D = 64 (160 values), and a 32-row q
// item for D = 128 (176). ptxas gives a thread of a 384-thread block 168
// registers, too few for that, so the blocks take FlashAttention-3's
// setmaxnreg split: the producer warpgroup drops to 56 registers and the
// consumer warpgroups rise to 224. dQ holds dQ (D/2), S and dP of a 64-row
// kv tile (32 each) and dS's fragments (16); 128-row kv tiles spilled.
// Launch order: the heaviest tiles under a causal mask first, the low kv
// tiles (dK/dV: the tile index is the grid's slowest dimension) and the high
// q tiles (dQ, as the forward).
//
// Shared memory (1024-byte aligned, the 128-byte swizzle's period): dK/dV
// holds K and V (128 x D bf16 each) and STAGES x (Q, dO) of BQ x D: D = 64
// 32 + 4 x 16 = 96 KB, D = 128 64 + 4 x 16 = 128 KB. dQ holds Q and dO
// (128 x D each) and STAGES x (K, V) of 64 x D: 96 KB and 192 KB.
//
// fp32 runs plain CUDA-core kernels (fp32 products keep fp32 precision): for
// checks, not for speed.
#include <type_traits>

#include "hopper.cuh"

namespace {

// range of a row that does not exist: sees nothing
__device__ __forceinline__ int2 no_range() { return make_int2(INT_MAX, INT_MIN); }

// the block's least and greatest valid (>= 0) value of `v` (threads with
// `has` false take no part); needs s_red[2], ends with a barrier
__device__ __forceinline__ int2 block_minmax(int v, bool has, int* s_red) {
  if (threadIdx.x == 0) { s_red[0] = INT_MAX; s_red[1] = INT_MIN; }
  __syncthreads();
  if (has) { atomicMin(&s_red[0], v); atomicMax(&s_red[1], v); }
  __syncthreads();
  const int2 r = make_int2(s_red[0], s_red[1]);
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// one warp per (batch, row, head) in memory order; delta is (B, H, Sq)
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta(const T* __restrict__ o,
                                                       const T* __restrict__ dout,
                                                       float* __restrict__ delta,
                                                       long long rows, int Sq, int H,
                                                       int D) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* orow = o + r * D;
  const T* drow = dout + r * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = (int)(r % H);
    const long long bs = r / H;       // b * Sq + s
    const long long b = bs / Sq, s = bs % Sq;
    delta[(b * H + h) * Sq + s] = sum;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int OWN = 128;            // rows of the block's own tile: 2 warpgroups x 64
constexpr int TC_THREADS = 384;     // 2 consumer warpgroups + 1 producer warpgroup
constexpr int CONSUMER_WARPS = 8;
// registers per thread after the split (at launch 168 each, 65,536 / 384
// rounded down): the producer warpgroup gives its registers up so that the
// consumers can hold S^T, dP^T, their fragments, dK and dV
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert(PRODUCER_REGS * 128 + 2 * CONSUMER_REGS * 128 <= 168 * TC_THREADS,
              "the register split must fit what the block holds at launch");
constexpr int STAGES = 4;           // ring depth
constexpr int SCAN = 32;            // tiles whose visibility the producer finds in one pass
constexpr int LOADS = 8;            // position loads it keeps in flight

template <int D>
struct BwdCfg {
  static constexpr int CB = D / 64;                // 64-column (128-byte) blocks
  static constexpr int BQ = D == 64 ? 64 : 32;     // dK/dV: q rows per item
  // dK/dV: an item's products overlap the next item's P, dS (registers)
  static constexpr bool OVERLAP = D == 64;
  static constexpr int BKV = 64;                   // dQ: kv rows per tile
  static constexpr int OWN_BYTES = OWN * D * 2;    // K or V (dK/dV); Q or dO (dQ)
  static constexpr int QT_BYTES = BQ * D * 2;      // one Q or dO tile of an item
  static constexpr int KT_BYTES = BKV * D * 2;     // one K or V tile
  static constexpr int DKDV_SMEM = 1024 + 2 * OWN_BYTES + STAGES * 2 * QT_BYTES;
  static constexpr int DQ_SMEM = 1024 + 2 * OWN_BYTES + STAGES * 2 * KT_BYTES;
};

// P and dS of one score element from S (raw q.k), dP, the row's lse (log2
// units) and delta; `ok` false masks it (P = 0, dS = 0)
struct Score {
  float ks, cap_in, cap_out;
  // without a soft-cap: P from S alone (dS is then P (dP - delta))
  __device__ __forceinline__ float p(float s, float lse2, bool ok) const {
    return ok ? ex2(s * ks - lse2) : 0.f;
  }
  // under a soft-cap: s becomes P and dp becomes dS, which needs tanh
  __device__ __forceinline__ void capped(float& s, float& dp, float lse2, float dl,
                                         bool ok) const {
    const float th = tanhf(s * cap_in);
    const float p = ok ? ex2(th * cap_out - lse2) : 0.f;
    dp = p * (dp - dl) * (1.f - th * th);
    s = p;
  }
};

__device__ __forceinline__ Score make_score(float scale, float softcap) {
  Score f;
  f.ks = scale * LOG2E;
  f.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  f.cap_out = softcap * LOG2E;
  return f;
}

// the accumulators x (64 x N per warpgroup) rounded to bf16 as the A
// fragments of the N/16 k-steps of a product over N (see pack_p in the
// forward)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// X = A B^T over D for a warpgroup: A its 64 rows at a_addr (a tile of
// a_rows rows), B the n_rows x D tile at b_addr, both K-major in 64-column
// blocks; the first k-step overwrites x (no other instruction may write an
// accumulator inside the pipeline: ptxas C7515)
template <int D, int N>
__device__ __forceinline__ void issue_abt(float (&x)[N / 2], uint32_t a_addr, int a_rows,
                                          uint32_t b_addr) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t col = (k & 3) * 32;
    wgmma_ss<N>(x, sw128_desc(a_addr + (k >> 2) * a_rows * 128 + col, 16),
                sw128_desc(b_addr + (k >> 2) * N * 128 + col, 16), k > 0);
  }
}

// acc (64 x D) += A B over K rows: A the bf16 fragments a, B the K x D tile
// at b_addr (MN-major: D is contiguous; 64-column blocks K * 128 bytes apart)
template <int D, int K>
__device__ __forceinline__ void issue_ab(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D>(acc, a[kk], sw128_desc(b_addr + kk * 16 * 128, K * 128));
}

// one block per (kv tile of 128 rows, kv head, batch); see the header
template <int D, bool CAP>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
    int H, int KV, int causal, int window, float scale, float softcap) {
  using C = BwdCfg<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES], kv_bar;
  __shared__ __align__(16) float s_lse2[STAGES][BQ];
  __shared__ __align__(16) float s_dl[STAGES][BQ];
  __shared__ __align__(16) int2 s_rng[STAGES][BQ];
  __shared__ int s_cls[STAGES];
  __shared__ int s_kp[OWN];                      // the tile's kv positions

  uint8_t* sK = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sV = sK + C::OWN_BYTES;               // [CB][OWN][64]
  uint8_t* sQ = sV + C::OWN_BYTES;               // [STAGES][CB][BQ][64]
  uint8_t* sdO = sQ + STAGES * C::QT_BYTES;      // [STAGES][CB][BQ][64]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * OWN;               // low kv tiles (heaviest) first
  const int G = H / KV;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);   // see the forward
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], CONSUMER_WARPS);
    }
    mbar_init(&kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if-else for the roles, never rejoined, so that ptxas applies each
  // side's register count (its note C7508 otherwise)
  if (warp >= CONSUMER_WARPS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > CONSUMER_WARPS) return;           // one producer warp works
    // ---- producer warp: K, V once; (Q, dO, lse, delta, ranges) per item ----
    int kmin = INT_MAX, kmax = INT_MIN, neg = 0;
    for (int j = lane; j < OWN; j += 32) {
      const int p = k0 + j < Skv ? kv_pos[(long long)b * Skv + k0 + j] : -1;
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
    if (lane == 0) {
      mbar_expect_tx(&kv_bar, 2 * C::OWN_BYTES);
#pragma unroll
      for (int cb = 0; cb < C::CB; ++cb) {
        tma_load_4d(sK + cb * OWN * 128, &tm_k, &kv_bar, cb * 64, kvh, k0, b);
        tma_load_4d(sV + cb * OWN * 128, &tm_v, &kv_bar, cb * 64, kvh, k0, b);
      }
    }
    const int* qpos = q_pos + (long long)b * Sq;     // this batch's rows
    int stage = 0;
    uint32_t phase = 0;
    // SCAN q tiles at a time: a bit per tile in which some row's visible
    // range meets [kmin, kmax], from the rows' positions, LOADS in flight at
    // once
    for (int base = 0; kmax >= 0 && base * BQ < Sq; base += SCAN) {
      uint32_t tiles = 0;
      for (int i0 = 0; i0 < SCAN * BQ / 32; i0 += LOADS) {   // 32-row groups
        int qp[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const int row = base * BQ + 32 * (i0 + i) + lane;
          qp[i] = row < Sq ? qpos[row] : 0;
        }
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const int2 r = visible_range(qp[i], causal, window);
          const bool seen = base * BQ + 32 * (i0 + i) + lane < Sq && r.x <= r.y &&
                            r.x <= kmax && r.y >= kmin;
          if (__any_sync(0xffffffffu, seen)) tiles |= 1u << ((i0 + i) * 32 / BQ);
        }
      }
      while (tiles) {
        const int q0 = (base + __ffs(tiles) - 1) * BQ;
        tiles &= tiles - 1;
        // the rows' ranges; the tile is full if every row exists and every
        // range holds every slot of the kv tile
        int2 rng[BQ / 32];
        int ragged = 0, lo_max = INT_MIN, hi_min = INT_MAX;
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          const int row = q0 + lane + 32 * i;
          if (row < Sq) {
            rng[i] = visible_range(qpos[row], causal, window);
            lo_max = max(lo_max, rng[i].x);
            hi_min = min(hi_min, rng[i].y);
          } else {
            rng[i] = no_range();
            ragged = 1;
          }
        }
        lo_max = warp_max(lo_max);
        hi_min = warp_min(hi_min);
        const bool full = !neg && !__any_sync(0xffffffffu, ragged) && lo_max <= kmin &&
                          hi_min >= kmax;
        for (int gi = 0; gi < G; ++gi) {
          const int h = kvh * G + gi;
          const long long head = ((long long)b * H + h) * Sq;
          float l2[BQ / 32], dl[BQ / 32];
#pragma unroll
          for (int i = 0; i < BQ / 32; ++i) {
            const int row = q0 + lane + 32 * i;
            l2[i] = row < Sq ? lse[head + row] * LOG2E : INFINITY;
            dl[i] = row < Sq ? delta[head + row] : 0.f;
          }
          mbar_wait(&empty_bar[stage], phase ^ 1);
#pragma unroll
          for (int i = 0; i < BQ / 32; ++i) {
            s_lse2[stage][lane + 32 * i] = l2[i];
            s_dl[stage][lane + 32 * i] = dl[i];
            s_rng[stage][lane + 32 * i] = rng[i];
          }
          if (lane == 0) s_cls[stage] = full ? CLS_FULL : CLS_PARTIAL;
          __syncwarp();
          if (lane == 0) {
            mbar_expect_tx(&full_bar[stage], 2 * C::QT_BYTES);
#pragma unroll
            for (int cb = 0; cb < C::CB; ++cb) {
              tma_load_4d(sQ + stage * C::QT_BYTES + cb * BQ * 128, &tm_q, &full_bar[stage],
                          cb * 64, h, q0, b);
              tma_load_4d(sdO + stage * C::QT_BYTES + cb * BQ * 128, &tm_do,
                          &full_bar[stage], cb * 64, h, q0, b);
            }
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    mbar_wait(&empty_bar[stage], phase ^ 1);     // hand over "no more items"
    if (lane == 0) {
      s_cls[stage] = CLS_END;
      mbar_arrive(&full_bar[stage]);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // ---- consumer warpgroups: 64 kv rows each ----
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = wg * 64 + (warp & 3) * 16 + g;   // this thread's rows in the tile
    // the tile's kv positions, read by partial items only (registers are
    // short here)
    if (threadIdx.x < OWN)
      s_kp[threadIdx.x] = k0 + threadIdx.x < Skv ? kv_pos[(long long)b * Skv + k0 + threadIdx.x]
                                                 : -1;
    named_sync(3);
    const Score score = make_score(scale, softcap);

    float dK[D / 2], dV[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dK[i] = dV[i] = 0.f;
    float s[BQ / 2], dp[BQ / 2];           // S^T, dP^T: kv rows x q columns
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];   // P^T, dS^T of the previous item
    const uint32_t k_addr = smem_u32(sK) + wg * 64 * 128;
    const uint32_t v_addr = smem_u32(sV) + wg * 64 * 128;

    auto issue_sdp = [&](int stage) {    // S^T = K Q^T, dP^T = V dO^T
      wgmma_fence();
      issue_abt<D, BQ>(s, k_addr, OWN, smem_u32(sQ + stage * C::QT_BYTES));
      wgmma_commit();
      issue_abt<D, BQ>(dp, v_addr, OWN, smem_u32(sdO + stage * C::QT_BYTES));
      wgmma_commit();
    };
    auto issue_grads = [&](int stage) {  // dV += P^T dO, dK += dS^T Q
      wgmma_fence();   // a pipeline stage of its own (ptxas C7515 otherwise)
      issue_ab<D, BQ>(dV, pa, smem_u32(sdO + stage * C::QT_BYTES));
      issue_ab<D, BQ>(dK, da, smem_u32(sQ + stage * C::QT_BYTES));
      wgmma_commit();
    };
    // s[4n + e], dp[4n + e]: kv row lo (e < 2) or hi, q column 8n + 2t + (e & 1).
    // P^T, dS^T of the item in `stage` once S^T, dP^T are in, with L later
    // wgmma groups still pending; without a soft-cap P^T is computed as soon
    // as S^T is in, while the tensor cores run dP^T.
    auto scores = [&](int stage, int cls, auto later) {
      constexpr int L = decltype(later)::value;
      const int kp_lo = s_kp[r_lo], kp_hi = s_kp[r_lo + 8];
      auto visible = [&](int n, int4& rg) {
        rg = make_int4(INT_MIN, INT_MAX, INT_MIN, INT_MAX);
        if (cls == CLS_PARTIAL) rg = *reinterpret_cast<const int4*>(&s_rng[stage][n * 8 + 2 * t]);
      };
      if constexpr (CAP) {
        wgmma_wait<L>();
        fence_regs(s);
        fence_regs(dp);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const int c = n * 8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(&s_lse2[stage][c]);
          const float2 dl = *reinterpret_cast<const float2*>(&s_dl[stage][c]);
          int4 rg;
          visible(n, rg);
          score.capped(s[4 * n], dp[4 * n], l2.x, dl.x, kp_lo >= rg.x && kp_lo <= rg.y);
          score.capped(s[4 * n + 1], dp[4 * n + 1], l2.y, dl.y, kp_lo >= rg.z && kp_lo <= rg.w);
          score.capped(s[4 * n + 2], dp[4 * n + 2], l2.x, dl.x, kp_hi >= rg.x && kp_hi <= rg.y);
          score.capped(s[4 * n + 3], dp[4 * n + 3], l2.y, dl.y, kp_hi >= rg.z && kp_hi <= rg.w);
        }
      } else {
        wgmma_wait<L + 1>();
        fence_regs(s);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(&s_lse2[stage][n * 8 + 2 * t]);
          int4 rg;
          visible(n, rg);
          s[4 * n] = score.p(s[4 * n], l2.x, kp_lo >= rg.x && kp_lo <= rg.y);
          s[4 * n + 1] = score.p(s[4 * n + 1], l2.y, kp_lo >= rg.z && kp_lo <= rg.w);
          s[4 * n + 2] = score.p(s[4 * n + 2], l2.x, kp_hi >= rg.x && kp_hi <= rg.y);
          s[4 * n + 3] = score.p(s[4 * n + 3], l2.y, kp_hi >= rg.z && kp_hi <= rg.w);
        }
        wgmma_wait<L>();
        fence_regs(dp);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 dl = *reinterpret_cast<const float2*>(&s_dl[stage][n * 8 + 2 * t]);
          dp[4 * n] = s[4 * n] * (dp[4 * n] - dl.x);
          dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - dl.y);
          dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - dl.x);
          dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - dl.y);
        }
      }
    };

    // Ping-pong, as the forward: the warpgroups take turns to issue their
    // wgmma (named barrier 1 + wg is this warpgroup's turn), so that one's
    // P, dS run on the CUDA cores while the other's products run. Warpgroup
    // 0 goes first.
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    if (C::OVERLAP && wg == 1) named_arrive(other_turn);

    mbar_wait(&kv_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(&full_bar[stage], phase);
    int cls = __shfl_sync(0xffffffffu, s_cls[stage], 0);
    if (cls != CLS_END && !C::OVERLAP) {
      // one item at a time: its products are done before the next S^T
      for (;;) {
        issue_sdp(stage);
        scores(stage, cls, std::integral_constant<int, 0>());
        pack_a<BQ>(pa, s);
        pack_a<BQ>(da, dp);
        issue_grads(stage);
        wgmma_wait<0>();
        fence_regs(dK);
        fence_regs(dV);
        if (lane == 0) mbar_arrive(&empty_bar[stage]);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
        mbar_wait(&full_bar[stage], phase);
        cls = __shfl_sync(0xffffffffu, s_cls[stage], 0);
        if (cls == CLS_END) break;
      }
    } else if (cls != CLS_END) {
      // the first item: no products of an earlier one to run behind it
      named_sync(my_turn);
      issue_sdp(stage);
      named_arrive(other_turn);
      scores(stage, cls, std::integral_constant<int, 0>());
      pack_a<BQ>(pa, s);
      pack_a<BQ>(da, dp);
      int prev = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      for (;;) {
        mbar_wait(&full_bar[stage], phase);
        cls = __shfl_sync(0xffffffffu, s_cls[stage], 0);
        if (cls == CLS_END) break;
        // S^T, dP^T of this item, then the previous item's dV, dK products,
        // which the tensor cores run while this item's P, dS are computed
        named_sync(my_turn);
        issue_sdp(stage);
        issue_grads(prev);
        named_arrive(other_turn);
        scores(stage, cls, std::integral_constant<int, 1>());
        wgmma_wait<0>();
        fence_regs(dK);
        fence_regs(dV);
        if (lane == 0) mbar_arrive(&empty_bar[prev]);   // its stage goes back
        pack_a<BQ>(pa, s);
        pack_a<BQ>(da, dp);
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      issue_grads(prev);                               // the last item's
      wgmma_wait<0>();
      fence_regs(dK);
      fence_regs(dV);
    }
    if (C::OVERLAP && wg == 0) named_sync(my_turn);  // takes warpgroup 1's last arrival

#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = k0 + r_lo + 8 * hi;
        if (row >= Skv) continue;
        const long long i = (((long long)b * Skv + row) * KV + kvh) * D + c;
        *reinterpret_cast<__nv_bfloat162*>(dk + i) =
            __floats2bfloat162_rn(dK[4 * n + 2 * hi] * scale, dK[4 * n + 2 * hi + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + i) =
            __floats2bfloat162_rn(dV[4 * n + 2 * hi], dV[4 * n + 2 * hi + 1]);
      }
    }
  }
}

// one block per (q tile of 128 rows, head, batch), q tiles in reverse so that
// the causal tiles with the most kv tiles start first; see the header
template <int D, bool CAP>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KV, int causal,
    int window, float scale, float softcap) {
  using C = BwdCfg<D>;
  constexpr int BKV = C::BKV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES], q_bar;
  __shared__ __align__(8) int s_kvpos[STAGES][BKV];
  __shared__ int s_cls[STAGES];

  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sdO = sQ + C::OWN_BYTES;              // [CB][OWN][64]
  uint8_t* sK = sdO + C::OWN_BYTES;              // [STAGES][CB][BKV][64]
  uint8_t* sV = sK + STAGES * C::KT_BYTES;       // [STAGES][CB][BKV][64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * OWN;     // heaviest tiles first
  const int kvh = h / (H / KV);
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

  if (warp >= CONSUMER_WARPS) {                 // the roles as in dK/dV
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > CONSUMER_WARPS) return;
    // ---- producer warp: Q, dO once; K, V tiles classed as the forward's ----
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int r = lane; r < OWN; r += 32) {
      if (q0 + r < Sq) {
        const int p = q_pos[(long long)b * Sq + q0 + r];
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      }
    }
    qmin = warp_min(qmin);
    qmax = warp_max(qmax);
    if (lane == 0) {
      mbar_expect_tx(&q_bar, 2 * C::OWN_BYTES);
#pragma unroll
      for (int cb = 0; cb < C::CB; ++cb) {
        tma_load_4d(sQ + cb * OWN * 128, &tm_q, &q_bar, cb * 64, h, q0, b);
        tma_load_4d(sdO + cb * OWN * 128, &tm_do, &q_bar, cb * 64, h, q0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    const int* kpos = kv_pos + (long long)b * Skv;   // this batch's slots
    // SCAN kv tiles at a time: a bit per tile in which some slot may be seen
    // by some row of the block, from the slots' positions, LOADS in flight
    // at once
    for (int base = 0; base * BKV < Skv; base += SCAN) {
      uint32_t tiles = 0;
      for (int i0 = 0; i0 < SCAN * BKV / 32; i0 += LOADS) {  // 32-slot groups
        int kp[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const int j = base * BKV + 32 * (i0 + i) + lane;
          kp[i] = j < Skv ? kpos[j] : -1;
        }
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const bool seen = kp[i] >= 0 && !(causal && kp[i] > qmax) &&
                            !(window > 0 &&
                              (long long)qmin - (long long)kp[i] >= (long long)window);
          if (__any_sync(0xffffffffu, seen)) tiles |= 1u << ((i0 + i) * 32 / BKV);
        }
      }
      while (tiles) {
        const int k0 = (base + __ffs(tiles) - 1) * BKV;
        tiles &= tiles - 1;
        int pos[BKV / 32];
        int kmin = INT_MAX, kmax = INT_MIN, neg = 0;
#pragma unroll
        for (int i = 0; i < BKV / 32; ++i) {
          const int j = k0 + lane + 32 * i;
          const int p = j < Skv ? kpos[j] : -1;
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
        const bool full = !neg && (!causal || kmax <= qmin) &&
                          (window <= 0 || (long long)qmax - (long long)kmin < (long long)window);
        mbar_wait(&empty_bar[stage], phase ^ 1);
#pragma unroll
        for (int i = 0; i < BKV / 32; ++i) s_kvpos[stage][lane + 32 * i] = pos[i];
        if (lane == 0) s_cls[stage] = full ? CLS_FULL : CLS_PARTIAL;
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&full_bar[stage], 2 * C::KT_BYTES);
#pragma unroll
          for (int cb = 0; cb < C::CB; ++cb) {
            tma_load_4d(sK + stage * C::KT_BYTES + cb * BKV * 128, &tm_k, &full_bar[stage],
                        cb * 64, kvh, k0, b);
            tma_load_4d(sV + stage * C::KT_BYTES + cb * BKV * 128, &tm_v, &full_bar[stage],
                        cb * 64, kvh, k0, b);
          }
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    mbar_wait(&empty_bar[stage], phase ^ 1);     // hand over "no more tiles"
    if (lane == 0) {
      s_cls[stage] = CLS_END;
      mbar_arrive(&full_bar[stage]);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    // ---- consumer warpgroups: 64 query rows each ----
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = wg * 64 + (warp & 3) * 16 + g;   // this thread's rows in the block
    const int row_lo = q0 + r_lo, row_hi = row_lo + 8;
    // rows past Sq: lse +inf (P = 0) and no visible range
    const long long li = ((long long)b * H + h) * Sq;
    const bool in_lo = row_lo < Sq, in_hi = row_hi < Sq;
    const float lse2_lo = in_lo ? lse[li + row_lo] * LOG2E : INFINITY;
    const float lse2_hi = in_hi ? lse[li + row_hi] * LOG2E : INFINITY;
    const float dl_lo = in_lo ? delta[li + row_lo] : 0.f;
    const float dl_hi = in_hi ? delta[li + row_hi] : 0.f;
    const int2 vis_lo = in_lo ? visible_range(q_pos[(long long)b * Sq + row_lo], causal, window)
                              : no_range();
    const int2 vis_hi = in_hi ? visible_range(q_pos[(long long)b * Sq + row_hi], causal, window)
                              : no_range();
    const Score score = make_score(scale, softcap);

    float dQ[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dQ[i] = 0.f;
    float s[BKV / 2], dp[BKV / 2];          // S, dP: q rows x kv columns
    uint32_t da[BKV / 16][4];               // dS of the previous tile
    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * 128;
    const uint32_t do_addr = smem_u32(sdO) + wg * 64 * 128;

    auto issue_sdp = [&](int stage) {    // S = Q K^T, dP = dO V^T
      wgmma_fence();
      issue_abt<D, BKV>(s, q_addr, OWN, smem_u32(sK + stage * C::KT_BYTES));
      wgmma_commit();
      issue_abt<D, BKV>(dp, do_addr, OWN, smem_u32(sV + stage * C::KT_BYTES));
      wgmma_commit();
    };
    auto issue_grads = [&](int stage) {  // dQ += dS K
      wgmma_fence();
      issue_ab<D, BKV>(dQ, da, smem_u32(sK + stage * C::KT_BYTES));
      wgmma_commit();
    };
    // s[4n + e], dp[4n + e]: q row lo (e < 2) or hi, kv column 8n + 2t + (e & 1).
    // P, dS as in dK/dV (scores there).
    auto scores = [&](int stage, int cls, auto later) {
      constexpr int L = decltype(later)::value;
      // the element's visibility: ok[0..3] for s[4n .. 4n + 3]
      auto visible = [&](int n, bool (&ok)[4]) {
        ok[0] = ok[1] = ok[2] = ok[3] = true;
        if (cls == CLS_PARTIAL) {
          const int2 kp = *reinterpret_cast<const int2*>(&s_kvpos[stage][n * 8 + 2 * t]);
          ok[0] = kp.x >= vis_lo.x && kp.x <= vis_lo.y;
          ok[1] = kp.y >= vis_lo.x && kp.y <= vis_lo.y;
          ok[2] = kp.x >= vis_hi.x && kp.x <= vis_hi.y;
          ok[3] = kp.y >= vis_hi.x && kp.y <= vis_hi.y;
        }
      };
      if constexpr (CAP) {
        wgmma_wait<L>();
        fence_regs(s);
        fence_regs(dp);
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {
          bool ok[4];
          visible(n, ok);
          score.capped(s[4 * n], dp[4 * n], lse2_lo, dl_lo, ok[0]);
          score.capped(s[4 * n + 1], dp[4 * n + 1], lse2_lo, dl_lo, ok[1]);
          score.capped(s[4 * n + 2], dp[4 * n + 2], lse2_hi, dl_hi, ok[2]);
          score.capped(s[4 * n + 3], dp[4 * n + 3], lse2_hi, dl_hi, ok[3]);
        }
      } else {
        wgmma_wait<L + 1>();
        fence_regs(s);
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {
          bool ok[4];
          visible(n, ok);
          s[4 * n] = score.p(s[4 * n], lse2_lo, ok[0]);
          s[4 * n + 1] = score.p(s[4 * n + 1], lse2_lo, ok[1]);
          s[4 * n + 2] = score.p(s[4 * n + 2], lse2_hi, ok[2]);
          s[4 * n + 3] = score.p(s[4 * n + 3], lse2_hi, ok[3]);
        }
        wgmma_wait<L>();
        fence_regs(dp);
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {
          dp[4 * n] = s[4 * n] * (dp[4 * n] - dl_lo);
          dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - dl_lo);
          dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - dl_hi);
          dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - dl_hi);
        }
      }
    };

    // Ping-pong, as in dK/dV
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    if (wg == 1) named_arrive(other_turn);

    mbar_wait(&q_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(&full_bar[stage], phase);
    int cls = __shfl_sync(0xffffffffu, s_cls[stage], 0);
    if (cls != CLS_END) {
      named_sync(my_turn);
      issue_sdp(stage);
      named_arrive(other_turn);
      scores(stage, cls, std::integral_constant<int, 0>());
      pack_a<BKV>(da, dp);
      int prev = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      for (;;) {
        mbar_wait(&full_bar[stage], phase);
        cls = __shfl_sync(0xffffffffu, s_cls[stage], 0);
        if (cls == CLS_END) break;
        named_sync(my_turn);
        issue_sdp(stage);
        issue_grads(prev);
        named_arrive(other_turn);
        scores(stage, cls, std::integral_constant<int, 1>());
        wgmma_wait<0>();
        fence_regs(dQ);
        if (lane == 0) mbar_arrive(&empty_bar[prev]);
        pack_a<BKV>(da, dp);
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      issue_grads(prev);
      wgmma_wait<0>();
      fence_regs(dQ);
    }
    if (wg == 0) named_sync(my_turn);   // takes warpgroup 1's last arrival

#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (in_lo)
        *reinterpret_cast<__nv_bfloat162*>(dq + (((long long)b * Sq + row_lo) * H + h) * D + c) =
            __floats2bfloat162_rn(dQ[4 * n] * scale, dQ[4 * n + 1] * scale);
      if (in_hi)
        *reinterpret_cast<__nv_bfloat162*>(dq + (((long long)b * Sq + row_hi) * H + h) * D + c) =
            __floats2bfloat162_rn(dQ[4 * n + 2] * scale, dQ[4 * n + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;   // 16 x 16
constexpr int F_BM = 64;         // the block's own rows: 4 per thread row
constexpr int F_BN = 32;         // the other side's rows per step: 2 per thread column

template <int D>
constexpr int f32_smem_floats() {
  return 2 * F_BM * (D + 1) + 2 * F_BN * (D + 1) + 2 * F_BM * (F_BN + 1);
}

// P, dS for the F_BM x F_BN block of pairs (rows own, columns other) into
// sP, sdS ([F_BM][F_BN + 1]); the row side is `own` (q for dQ, kv for
// dK/dV): s = own . other over D, dp = ownd . otherd
template <int D>
__device__ __forceinline__ void f32_scores(const float* own, const float* other,
                                           const float* ownd, const float* otherd,
                                           bool own_is_q, const float* lse,
                                           const float* dl, const int2* rng,
                                           const int* kp, float scale, float softcap,
                                           float* sP, float* sdS) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][2] = {}, dp[4][2] = {};
  for (int d = 0; d < D; ++d) {
    float a[4], ad[4], o[2], od[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = own[(ty * 4 + i) * (D + 1) + d];
      ad[i] = ownd[(ty * 4 + i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      o[j] = other[(tx * 2 + j) * (D + 1) + d];
      od[j] = otherd[(tx * 2 + j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(a[i], o[j], s[i][j]);
        dp[i][j] = fmaf(ad[i], od[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty * 4 + i, c = tx * 2 + j;
      const int qi = own_is_q ? r : c, kj = own_is_q ? c : r;
      const bool ok = kp[kj] >= rng[qi].x && kp[kj] <= rng[qi].y;
      float sv = s[i][j] * scale, dfac = 1.f;
      if (softcap > 0.f) {
        const float tt = tanhf(sv / softcap);
        sv = tt * softcap;
        dfac = 1.f - tt * tt;
      }
      const float p = ok ? expf(sv - lse[qi]) : 0.f;
      sP[r * (F_BN + 1) + c] = p;
      sdS[r * (F_BN + 1) + c] = p * (dp[i][j] - dl[qi]) * dfac;
    }
}

// rows [row0, row0 + R) of one head of a dense (B, S, heads, D) fp32 tensor
// into a [R][D + 1] tile; rows at or past S are zeros
template <int D, int R>
__device__ __forceinline__ void f32_load(float* tile, const float* base, int row0, int S,
                                         long long row_stride) {
  for (int i = threadIdx.x; i < R * D; i += F_THREADS) {
    const int r = i / D, d = i % D;
    tile[r * (D + 1) + d] = row0 + r < S ? base[(long long)(row0 + r) * row_stride + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, float* __restrict__ dk, float* __restrict__ dv,
    int Sq, int Skv, int H, int KV, int causal, int window, float scale, float softcap) {
  constexpr int CO = D / 16;
  extern __shared__ float fsm[];
  float* sK = fsm;
  float* sV = sK + F_BM * (D + 1);
  float* sQ = sV + F_BM * (D + 1);
  float* sdO = sQ + F_BN * (D + 1);
  float* sP = sdO + F_BN * (D + 1);
  float* sdS = sP + F_BM * (F_BN + 1);
  __shared__ int s_kp[F_BM];
  __shared__ float s_lse[F_BN], s_dl[F_BN];
  __shared__ int2 s_rng[F_BN];
  __shared__ int s_red[2];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * F_BM, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long q_rs = (long long)H * D, kv_rs = (long long)KV * D;
  f32_load<D, F_BM>(sK, k + ((long long)b * Skv * KV + kvh) * D, k0, Skv, kv_rs);
  f32_load<D, F_BM>(sV, v + ((long long)b * Skv * KV + kvh) * D, k0, Skv, kv_rs);
  int kp = -1;
  if (tid < F_BM) {
    kp = k0 + tid < Skv ? kv_pos[(long long)b * Skv + k0 + tid] : -1;
    s_kp[tid] = kp;
  }
  const int2 kr = block_minmax(kp, kp >= 0, s_red);

  float dK[4][CO] = {}, dV[4][CO] = {};
  for (int qt = 0; qt * F_BN < Sq; ++qt) {
    const int row0 = qt * F_BN;
    int seen = 0;
    int2 r = no_range();
    if (tid < F_BN && row0 + tid < Sq && kr.x <= kr.y) {
      r = visible_range(q_pos[(long long)b * Sq + row0 + tid], causal, window);
      seen = r.x <= r.y && r.x <= kr.y && r.y >= kr.x;
    }
    if (!__syncthreads_or(seen)) continue;
    if (tid < F_BN) s_rng[tid] = r;
    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      const long long head = ((long long)b * Sq * H + h) * D;
      f32_load<D, F_BN>(sQ, q + head, row0, Sq, q_rs);
      f32_load<D, F_BN>(sdO, dout + head, row0, Sq, q_rs);
      if (tid < F_BN) {
        const long long i = ((long long)b * H + h) * Sq + row0 + tid;
        const bool in = row0 + tid < Sq;
        s_lse[tid] = in ? lse[i] : INFINITY;
        s_dl[tid] = in ? delta[i] : 0.f;
      }
      __syncthreads();
      f32_scores<D>(sK, sQ, sV, sdO, false, s_lse, s_dl, s_rng, s_kp, scale, softcap, sP,
                    sdS);
      __syncthreads();
      for (int j = 0; j < F_BN; ++j) {
        float o[CO], qq[CO];
#pragma unroll
        for (int c = 0; c < CO; ++c) {
          o[c] = sdO[j * (D + 1) + tx + 16 * c];
          qq[c] = sQ[j * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sP[(ty * 4 + i) * (F_BN + 1) + j];
          const float ds = sdS[(ty * 4 + i) * (F_BN + 1) + j];
#pragma unroll
          for (int c = 0; c < CO; ++c) {
            dV[i][c] = fmaf(p, o[c], dV[i][c]);
            dK[i][c] = fmaf(ds, qq[c], dK[i][c]);
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Skv) continue;
    const long long base = (((long long)b * Skv + row) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      dk[base + tx + 16 * c] = dK[i][c] * scale;
      dv[base + tx + 16 * c] = dV[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, float* __restrict__ dq, int Sq, int Skv, int H,
    int KV, int causal, int window, float scale, float softcap) {
  constexpr int CO = D / 16;
  extern __shared__ float fsm[];
  float* sQ = fsm;
  float* sdO = sQ + F_BM * (D + 1);
  float* sK = sdO + F_BM * (D + 1);
  float* sV = sK + F_BN * (D + 1);
  float* sP = sV + F_BN * (D + 1);
  float* sdS = sP + F_BM * (F_BN + 1);
  __shared__ int s_kp[F_BN];
  __shared__ float s_lse[F_BM], s_dl[F_BM];
  __shared__ int2 s_rng[F_BM];
  __shared__ int s_red[2];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * F_BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_rs = (long long)H * D, kv_rs = (long long)KV * D;
  const long long head = ((long long)b * Sq * H + h) * D;
  f32_load<D, F_BM>(sQ, q + head, q0, Sq, q_rs);
  f32_load<D, F_BM>(sdO, dout + head, q0, Sq, q_rs);
  int2 rng = no_range();
  if (tid < F_BM) {
    const int row = q0 + tid;
    const long long i = ((long long)b * H + h) * Sq + row;
    const bool in = row < Sq;
    if (in) rng = visible_range(q_pos[(long long)b * Sq + row], causal, window);
    s_rng[tid] = rng;
    s_lse[tid] = in ? lse[i] : INFINITY;
    s_dl[tid] = in ? delta[i] : 0.f;
  }
  const bool live = rng.x <= rng.y;
  const int qlo = block_minmax(rng.x, live, s_red).x;
  const int qhi = block_minmax(rng.y, live, s_red).y;

  float dQ[4][CO] = {};
  for (int k0 = 0; k0 < Skv; k0 += F_BN) {
    int seen = 0, p = -1;
    if (tid < F_BN && k0 + tid < Skv) {
      p = kv_pos[(long long)b * Skv + k0 + tid];
      seen = p >= 0 && p >= qlo && p <= qhi;
    }
    if (!__syncthreads_or(seen)) continue;
    if (tid < F_BN) s_kp[tid] = p;
    f32_load<D, F_BN>(sK, k + ((long long)b * Skv * KV + kvh) * D, k0, Skv, kv_rs);
    f32_load<D, F_BN>(sV, v + ((long long)b * Skv * KV + kvh) * D, k0, Skv, kv_rs);
    __syncthreads();
    f32_scores<D>(sQ, sK, sdO, sV, true, s_lse, s_dl, s_rng, s_kp, scale, softcap, sP, sdS);
    __syncthreads();
    for (int j = 0; j < F_BN; ++j) {
      float kk[CO];
#pragma unroll
      for (int c = 0; c < CO; ++c) kk[c] = sK[j * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sdS[(ty * 4 + i) * (F_BN + 1) + j];
#pragma unroll
        for (int c = 0; c < CO; ++c) dQ[i][c] = fmaf(ds, kk[c], dQ[i][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < CO; ++c) dq[head + row * q_rs + tx + 16 * c] = dQ[i][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const int *q_pos, *kv_pos;
  void *dq, *dk, *dv;
  float* delta;
  int B, Sq, Skv, H, KV, causal, window;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename T>
int launch_delta(const Args& a, int D) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, rows, a.Sq, a.H, D);
  return (int)cudaGetLastError();
}

template <int D, bool CAP>
int launch_bf16(const Args& a) {
  using C = BwdCfg<D>;
  using bf = __nv_bfloat16;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout)) % 16)
    return (int)cudaErrorMisalignedAddress;
  int err = launch_delta<bf>(a, D);
  if (err) return err;
  // dense (B, S, heads, D): element strides of batch, sequence, head
  const long long q_st[3] = {(long long)a.Sq * a.H * D, (long long)a.H * D, D};
  const long long k_st[3] = {(long long)a.Skv * a.KV * D, (long long)a.KV * D, D};
  CUtensorMap q_item, do_item, k_own, v_own, q_own, do_own, k_tile, v_tile;
  if (!make_map(&q_item, a.q, a.B, a.Sq, a.H, D, q_st, C::BQ) ||
      !make_map(&do_item, a.dout, a.B, a.Sq, a.H, D, q_st, C::BQ) ||
      !make_map(&k_own, a.k, a.B, a.Skv, a.KV, D, k_st, OWN) ||
      !make_map(&v_own, a.v, a.B, a.Skv, a.KV, D, k_st, OWN) ||
      !make_map(&q_own, a.q, a.B, a.Sq, a.H, D, q_st, OWN) ||
      !make_map(&do_own, a.dout, a.B, a.Sq, a.H, D, q_st, OWN) ||
      !make_map(&k_tile, a.k, a.B, a.Skv, a.KV, D, k_st, C::BKV) ||
      !make_map(&v_tile, a.v, a.B, a.Skv, a.KV, D, k_st, C::BKV))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<D, CAP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::DKDV_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nkt = (a.Skv + OWN - 1) / OWN, nqt = (a.Sq + OWN - 1) / OWN;
  flash_bwd_dkdv_wgmma<D, CAP><<<dim3(a.KV, a.B, nkt), TC_THREADS, C::DKDV_SMEM, a.stream>>>(
      q_item, do_item, k_own, v_own, a.lse, a.delta, a.q_pos, a.kv_pos,
      static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.Sq, a.Skv, a.H, a.KV, a.causal,
      a.window, a.scale, a.softcap);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq_wgmma<D, CAP><<<dim3(a.H, a.B, nqt), TC_THREADS, C::DQ_SMEM, a.stream>>>(
      q_own, do_own, k_tile, v_tile, a.lse, a.delta, a.q_pos, a.kv_pos,
      static_cast<bf*>(a.dq), a.Sq, a.Skv, a.H, a.KV, a.causal, a.window, a.scale,
      a.softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a) {
  int err = launch_delta<float>(a, D);
  if (err) return err;
  constexpr int bytes = f32_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_f32<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_f32<D><<<dim3((a.Skv + F_BM - 1) / F_BM, a.KV, a.B), F_THREADS, bytes,
                          a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.q_pos, a.kv_pos, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv,
      a.H, a.KV, a.causal, a.window, a.scale, a.softcap);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq_f32<D><<<dim3((a.Sq + F_BM - 1) / F_BM, a.H, a.B), F_THREADS, bytes,
                        a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      a.q_pos, a.kv_pos, static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.KV, a.causal,
      a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o, dout, dq dense (B, Sq, H, D); k, v,
// dk, dv dense (B, Skv, KV, D); lse and the scratch delta (B, H, Sq) fp32;
// positions int32 (B, Sq) and (B, Skv). bf16 pointers 16-byte aligned.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, const int* q_pos,
                                   const int* kv_pos, void* dq, void* dk, void* dv,
                                   float* delta, int B, int Sq, int Skv, int H, int KV, int D,
                                   int dtype, int causal, int window, float scale,
                                   float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,  v,   o,  dout,   lse,    q_pos, kv_pos, dq,
               dk,    dv, delta, B, Sq,    Skv,    H,     KV,     causal,
               window, scale, softcap, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && D == 64) return launch_f32<64>(a);
  if (dtype == 0 && D == 128) return launch_f32<128>(a);
  const bool cap = softcap > 0.f;
  if (dtype == 1 && D == 64) return cap ? launch_bf16<64, true>(a) : launch_bf16<64, false>(a);
  if (dtype == 1 && D == 128)
    return cap ? launch_bf16<128, true>(a) : launch_bf16<128, false>(a);
  return (int)cudaErrorInvalidValue;
}
