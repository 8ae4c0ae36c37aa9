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
// memory-bound.
//
// The FlashAttention-2 form, three kernels, no atomics, so every output
// element is summed by one thread in a fixed order and the result is the same
// bits from call to call:
//  * flash_bwd_delta: delta per (batch, head, row), one warp per row.
//  * dK/dV: one block per (kv tile of 64 rows, kv head, batch). K and V stay
//    in shared memory; the block walks the q tiles that can see its kv tile
//    and, for each, the G = H / KV query heads of its kv head, so dK and dV
//    are summed over the whole group in registers and written once.
//  * dQ: one block per (q tile of 64 rows, head, batch), walking the kv tiles
//    its rows can see; dQ is summed in registers and written once.
// Which tiles are seen is decided from positions (the tile's least and
// greatest valid kv position against each row's visible range), by all
// threads at once before the walk, so that the next tile's loads can be
// started while the current one is computed (cp.async, two stages); its
// per-row values (lse, delta, positions) are loaded into registers a tile
// ahead too and stored to shared memory after the current tile's products.
//
// bf16 runs the five products on the tensor cores with mma.sync m16n8k16
// (fp32 accumulators). Each warp owns 16 rows of the block's own tile. S
// (or S^T) and dP come out in the accumulator layout, which, rounded to bf16,
// is the A fragment of the next product (P for dV, dS for dK and dQ), so they
// never leave registers; the other operand is read with ldmatrix (.trans
// where it is stored row-major along the product's n) from 16-byte-chunk
// XOR-swizzled shared memory, conflict free. P and dS are rounded to bf16 for
// those products as the forward rounds P, and so does FlashAttention-2.
// fp32 runs plain CUDA-core kernels (fp32 products keep fp32 precision): for
// checks, not for speed. wgmma/TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;        // rows of the block's own tile (4 warps x 16)
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the kv positions a query at position qp sees, as [lo, hi] (empty when
// lo > hi): kv_pos >= 0; causal kv_pos <= qp; window qp - kv_pos < window
__device__ __forceinline__ int2 visible_range(int qp, int causal, int window) {
  long long lo = 0;
  if (window > 0) lo = max(lo, (long long)qp - (long long)window + 1);
  return make_int2((int)min(lo, (long long)INT_MAX), causal ? qp : INT_MAX);
}

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

// The tiles of `tile` rows of [0, n) in which `seen(row)` holds for some
// row, in order, into `list`; returns how many. Every thread tests rows
// threadIdx.x, + THREADS, ... (their loads all in flight), marking the
// tile's flag; warp 0 compacts the flags with ballots. `flags` and `list`
// hold ceil(n / tile) ints each. Ends with a barrier.
template <typename F>
__device__ __forceinline__ int visible_tiles(int n, int tile, int* flags, int* list,
                                             int* s_count, F seen) {
  const int nt = (n + tile - 1) / tile;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) flags[i] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    if (seen(r)) flags[r / tile] = 1;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < nt; base += 32) {
      const int f = base + lane < nt && flags[base + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[count + __popc(m & ((1u << lane) - 1u))] = base + lane;
      count += __popc(m);
    }
    if (lane == 0) *s_count = count;
  }
  __syncthreads();
  return *s_count;
}

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// bf16: mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// A tile of R rows x D bf16 in shared memory, each row D / 8 chunks of 16
// bytes; chunk c of row r sits at chunk c ^ (r & 7), so the 8 rows an
// ldmatrix reads at one column land in 8 different bank groups.
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  return base + (uint32_t)((r * (D / 8) + ((c >> 3) ^ (r & 7))) * 16);
}

// cp.async of rows [row0, row0 + R) of one head of a dense (B, S, heads, D)
// tensor into a swizzled tile; rows at or past S are zero-filled
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int row0, int S, long long row_stride) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* src = ok ? base + (long long)(row0 + r) * row_stride + c * 8 : base;
    cp_async16(tile + (r * CH + (c ^ (r & 7))) * 8, src, ok);
  }
}

// acc (16 x N) += A (16 rows of tile a from row ar, D columns) * B^T, where
// B is N rows (from row 0) x D columns of tile b: both read with ldmatrix
template <int D, int N>
__device__ __forceinline__ void gemm_abt(float (&acc)[N / 8][4], uint32_t a, int ar,
                                         uint32_t b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, tile_addr<D>(a, ar + (lane & 15), kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, tile_addr<D>(b, np * 16 + (lane & 7) + (lane >> 4) * 8,
                               kk * 16 + ((lane >> 3) & 1) * 8));
      mma16816(acc[2 * np], af, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += A (16 x K, the bf16 rounding of the accumulators x, as
// the A fragment) * B, where B is K rows x D columns of tile b (read with
// ldmatrix.trans)
template <int D, int K>
__device__ __forceinline__ void gemm_xb(float (&acc)[D / 8][4], const float (&x)[K / 8][4],
                                        uint32_t b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_t(bf, tile_addr<D>(b, kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 dp * 16 + (lane >> 4) * 8));
      mma16816(acc[2 * dp], af, bf[0], bf[1]);
      mma16816(acc[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
}

// Per element of a score accumulator: P and dS from S (raw q.k), dP, the
// element's lse (log2 units), delta and visibility. Returns P; dS in *ds.
struct Score {
  float ks, cap_in, cap_out, softcap;
  __device__ __forceinline__ float operator()(float s, float dp, float lse2, float delta,
                                              bool ok, float* ds) const {
    float sv, dfac = 1.f;
    if (softcap > 0.f) {
      const float t = tanhf(s * cap_in);
      sv = t * cap_out;
      dfac = 1.f - t * t;
    } else {
      sv = s * ks;
    }
    const float p = ok ? ex2(sv - lse2) : 0.f;
    *ds = p * (dp - delta) * dfac;
    return p;
  }
};

__device__ __forceinline__ Score make_score(float scale, float softcap) {
  Score f;
  f.softcap = softcap;
  f.ks = scale * LOG2E;
  f.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  f.cap_out = softcap * LOG2E;
  return f;
}

template <int D>
struct BwdCfg {
  static constexpr int BN = D == 64 ? 64 : 32;   // q rows per step of dK/dV (registers)
  static constexpr int TILE_BYTES = TILE * D * 2;
  static constexpr int N_BYTES = BN * D * 2;
  // dK/dV: K, V, then two stages of (Q, dO); then the visible-tile flags
  // and list, 2 x ceil(Sq / BN) ints (dQ: ceil(Skv / TILE))
  static constexpr int DKDV_SMEM = 2 * TILE_BYTES + 4 * N_BYTES;
  // dQ: Q, dO, then two stages of (K, V) of TILE rows
  static constexpr int DQ_SMEM = 6 * TILE_BYTES;
};

// one block per (kv tile, kv head, batch); see the header
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
    int H, int KV, int causal, int window, float scale, float softcap) {
  using C = BwdCfg<D>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + C::TILE_BYTES);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + 2 * C::TILE_BYTES);  // [2]
  __nv_bfloat16* sdO = sQ + 2 * BN * D;                                            // [2]
  const int nqt = (Sq + BN - 1) / BN;
  int* s_tiles = reinterpret_cast<int*>(smem + C::DKDV_SMEM);  // visible q tiles
  int* s_flags = s_tiles + nqt;
  __shared__ int s_kp[TILE];
  __shared__ float s_lse2[2][BN], s_delta[2][BN];
  __shared__ int2 s_rng[2][BN];
  __shared__ int s_red[2], s_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * TILE, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long q_rs = (long long)H * D, kv_rs = (long long)KV * D;

  load_tile<D, TILE>(sK, k + ((long long)b * Skv * KV + kvh) * D, k0, Skv, kv_rs);
  load_tile<D, TILE>(sV, v + ((long long)b * Skv * KV + kvh) * D, k0, Skv, kv_rs);
  cp_async_commit();

  int kp = -1;
  if (tid < TILE) {
    kp = k0 + tid < Skv ? kv_pos[(long long)b * Skv + k0 + tid] : -1;
    s_kp[tid] = kp;
  }
  const int2 kr = block_minmax(kp, kp >= 0, s_red);

  // the q tiles in which some row sees some slot of this kv tile
  const int n_vis = visible_tiles(Sq, BN, s_flags, s_tiles, &s_count, [&](int row) {
    const int2 r = visible_range(q_pos[(long long)b * Sq + row], causal, window);
    return kr.x <= kr.y && r.x <= r.y && r.x <= kr.y && r.y >= kr.x;
  });

  const int n_items = n_vis * G;      // (q tile, head of the group) pairs
  auto fetch = [&](int item, int st) {
    const int row0 = s_tiles[item / G] * BN, h = kvh * G + item % G;
    const long long head = ((long long)b * Sq * H + h) * D;
    load_tile<D, BN>(sQ + st * BN * D, q + head, row0, Sq, q_rs);
    load_tile<D, BN>(sdO + st * BN * D, dout + head, row0, Sq, q_rs);
    cp_async_commit();
  };
  // an item's per-row values (lse, delta, position), loaded into registers
  // one item ahead and stored to shared memory only after the current
  // item's products, so that the loads' latency hides behind them
  float n_lse = INFINITY, n_dl = 0.f;
  int n_qp = 0;
  bool n_in = false;
  auto load_rows = [&](int item) {
    const int row = s_tiles[item / G] * BN + tid, h = kvh * G + item % G;
    n_in = tid < BN && row < Sq;
    if (n_in) {
      const long long i = ((long long)b * H + h) * Sq + row;
      n_lse = lse[i];
      n_dl = delta[i];
      n_qp = q_pos[(long long)b * Sq + row];
    }
  };
  auto store_rows = [&](int st) {
    if (tid < BN) {
      s_lse2[st][tid] = n_in ? n_lse * LOG2E : INFINITY;
      s_delta[st][tid] = n_in ? n_dl : 0.f;
      s_rng[st][tid] = n_in ? visible_range(n_qp, causal, window) : no_range();
    }
  };

  float dK[D / 8][4], dV[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[i][e] = dV[i][e] = 0.f;

  const Score score = make_score(scale, softcap);
  const int kp_lo = s_kp[warp * 16 + g], kp_hi = s_kp[warp * 16 + g + 8];
  const uint32_t aK = smem_u32(sK), aV = smem_u32(sV);

  if (n_items > 0) {
    fetch(0, 0);
    load_rows(0);
    store_rows(0);
  }
  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    const bool more = it + 1 < n_items;
    if (more) {
      fetch(it + 1, st ^ 1);
      load_rows(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t aQ = smem_u32(sQ + st * BN * D), adO = smem_u32(sdO + st * BN * D);
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    gemm_abt<D, BN>(s, aK, warp * 16, aQ);     // S^T = K Q^T
    gemm_abt<D, BN>(dp, aV, warp * 16, adO);   // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);   // q row of the tile
        const int kpe = e < 2 ? kp_lo : kp_hi;
        const int2 r = s_rng[st][col];
        float ds;
        s[n][e] = score(s[n][e], dp[n][e], s_lse2[st][col], s_delta[st][col],
                        kpe >= r.x && kpe <= r.y, &ds);
        dp[n][e] = ds;
      }
    }
    gemm_xb<D, BN>(dV, s, adO);                 // dV += P^T dO
    gemm_xb<D, BN>(dK, dp, aQ);                 // dK += dS^T Q
    if (more) store_rows(st ^ 1);   // last read by item it - 1, before this barrier
    __syncthreads();                            // stage st is free again
  }
  if (n_items == 0) cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = k0 + warp * 16 + g + 8 * hi;
      if (row >= Skv) continue;
      const long long i = (((long long)b * Skv + row) * KV + kvh) * D + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + i) =
          __floats2bfloat162_rn(dK[n][2 * hi] * scale, dK[n][2 * hi + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + i) =
          __floats2bfloat162_rn(dV[n][2 * hi], dV[n][2 * hi + 1]);
    }
  }
}

// one block per (q tile, head, batch), q tiles in reverse so that the causal
// tiles with the most kv tiles start first; see the header. For D = 64 three
// blocks share an SM (at most 168 registers, no spills): this kernel alone
// measured 0.285 ms against 0.320 ms for two blocks at the training shape
// (B=4 S=2048 H=15 KV=5) on an H100 80GB HBM3 at 700 W.
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 3 : 1) flash_bwd_dq(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KV, int causal,
    int window, float scale, float softcap) {
  using C = BwdCfg<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + C::TILE_BYTES);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + 2 * C::TILE_BYTES);  // [2]
  __nv_bfloat16* sV = sK + 2 * TILE * D;                                           // [2]
  const int nkt = (Skv + TILE - 1) / TILE;
  int* s_tiles = reinterpret_cast<int*>(smem + C::DQ_SMEM);    // visible kv tiles
  int* s_flags = s_tiles + nkt;
  __shared__ int s_kp[2][TILE];
  __shared__ int s_red[2], s_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_rs = (long long)H * D, kv_rs = (long long)KV * D;
  const long long head = ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Skv * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * KV + kvh) * D;

  load_tile<D, TILE>(sQ, q + head, q0, Sq, q_rs);
  load_tile<D, TILE>(sdO, dout + head, q0, Sq, q_rs);
  cp_async_commit();

  // the block's rows: their visible ranges, and the union of them
  int2 rng = no_range();
  if (tid < TILE && q0 + tid < Sq)
    rng = visible_range(q_pos[(long long)b * Sq + q0 + tid], causal, window);
  const bool live = rng.x <= rng.y;
  const int qlo = block_minmax(rng.x, live, s_red).x;
  const int qhi = block_minmax(rng.y, live, s_red).y;

  // the kv tiles in which some slot is seen by some row
  const int n_vis = visible_tiles(Skv, TILE, s_flags, s_tiles, &s_count, [&](int j) {
    const int p = kv_pos[(long long)b * Skv + j];
    return qlo <= qhi && p >= 0 && p >= qlo && p <= qhi;
  });

  // this thread's two rows (g, g + 8 of its warp's 16)
  float lse2[2], dl[2];
  int2 rg[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + warp * 16 + g + 8 * hi;
    const bool in = row < Sq;
    const long long i = ((long long)b * H + h) * Sq + row;
    lse2[hi] = in ? lse[i] * LOG2E : INFINITY;
    dl[hi] = in ? delta[i] : 0.f;
    rg[hi] = in ? visible_range(q_pos[(long long)b * Sq + row], causal, window) : no_range();
  }

  auto fetch = [&](int item, int st) {
    const int kt = s_tiles[item];
    load_tile<D, TILE>(sK + st * TILE * D, kb, kt * TILE, Skv, kv_rs);
    load_tile<D, TILE>(sV + st * TILE * D, vb, kt * TILE, Skv, kv_rs);
    cp_async_commit();
  };
  // a tile's kv positions, loaded one tile ahead (as load_rows in dK/dV)
  int n_kp = -1;
  auto load_kp = [&](int item) {
    const int j = s_tiles[item] * TILE + tid;
    n_kp = tid < TILE && j < Skv ? kv_pos[(long long)b * Skv + j] : -1;
  };
  auto store_kp = [&](int st) {
    if (tid < TILE) s_kp[st][tid] = n_kp;
  };

  float dQ[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[i][e] = 0.f;

  const Score score = make_score(scale, softcap);
  const uint32_t aQ = smem_u32(sQ), adO = smem_u32(sdO);

  if (n_vis > 0) {
    fetch(0, 0);
    load_kp(0);
    store_kp(0);
  }
  for (int it = 0; it < n_vis; ++it) {
    const int st = it & 1;
    const bool more = it + 1 < n_vis;
    if (more) {
      fetch(it + 1, st ^ 1);
      load_kp(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t aK = smem_u32(sK + st * TILE * D), aV = smem_u32(sV + st * TILE * D);
    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int i = 0; i < TILE / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    gemm_abt<D, TILE>(s, aQ, warp * 16, aK);    // S = Q K^T
    gemm_abt<D, TILE>(dp, adO, warp * 16, aV);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const int kpe = s_kp[st][n * 8 + 2 * t + (e & 1)];
        float ds;
        score(s[n][e], dp[n][e], lse2[hi], dl[hi], kpe >= rg[hi].x && kpe <= rg[hi].y, &ds);
        dp[n][e] = ds;
      }
    }
    gemm_xb<D, TILE>(dQ, dp, aK);               // dQ += dS K
    if (more) store_kp(st ^ 1);
    __syncthreads();
  }
  if (n_vis == 0) cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = q0 + warp * 16 + g + 8 * hi;
      if (row >= Sq) continue;
      *reinterpret_cast<__nv_bfloat162*>(dq + head + (long long)row * q_rs + c) =
          __floats2bfloat162_rn(dQ[n][2 * hi] * scale, dQ[n][2 * hi + 1] * scale);
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

template <int D>
int launch_bf16(const Args& a) {
  using C = BwdCfg<D>;
  using bf = __nv_bfloat16;
  int err = launch_delta<bf>(a, D);
  if (err) return err;
  const int nqt = (a.Sq + C::BN - 1) / C::BN, nkt = (a.Skv + TILE - 1) / TILE;
  const int smem_kv = C::DKDV_SMEM + 2 * nqt * (int)sizeof(int);
  const int smem_q = C::DQ_SMEM + 2 * nkt * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_q);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<D><<<dim3(nkt, a.KV, a.B), THREADS, smem_kv, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      static_cast<const bf*>(a.dout), a.lse, a.delta, a.q_pos, a.kv_pos,
      static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.Sq, a.Skv, a.H, a.KV, a.causal,
      a.window, a.scale, a.softcap);
  err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq<D><<<dim3((a.Sq + TILE - 1) / TILE, a.H, a.B), THREADS, smem_q, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      static_cast<const bf*>(a.dout), a.lse, a.delta, a.q_pos, a.kv_pos,
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
  if (dtype == 1 && D == 64) return launch_bf16<64>(a);
  if (dtype == 1 && D == 128) return launch_bf16<128>(a);
  return (int)cudaErrorInvalidValue;
}
