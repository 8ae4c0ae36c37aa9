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
// design is about keeping the tensor cores fed:
//
//  * bf16 inputs (the serving path) run flash_fwd_mma: both products on the
//    tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate). Four
//    warps own 16 query rows each; the scores never leave registers: the
//    fp32 accumulator fragment of S = QK^T is exactly the A fragment of
//    P V once rounded to bf16, so P goes from one mma to the next without
//    shared memory (as in FlashAttention-2). P is rounded to bf16 for the
//    second product, as FlashAttention-2 does. That differs from the Pallas
//    body this replaces, which casts q, k and v to fp32 and so keeps P in
//    fp32 (the TPU's default matmul precision may round likewise; not
//    measured). m, l (summed from the unrounded P) and the output
//    accumulator stay fp32.
//  * fp32 inputs run flash_fwd_simt: fp32 arithmetic on the CUDA cores, so
//    the result keeps fp32 precision (a bf16 or tf32 mma would not). Its
//    ceiling is the 67 TFLOP/s fp32 rate. The model serves in bf16; fp32 is
//    for checks.
//
// Design for the card rather than the TPU grid (both kernels):
//  * One block per (q tile of 64 rows, q head, batch). The TPU kernel's
//    sequential "arbitrary" kv grid axis becomes a loop inside the block,
//    and the online-softmax state (m, l, acc) lives in registers for the
//    whole loop instead of in VMEM scratch between grid steps.
//  * Each kv tile of 64 rows is staged in shared memory and shared by the
//    block; padded rows keep the fragment loads free of bank conflicts.
//  * Inputs are read in the model's (B, S, H, D) layout through strides, so
//    the wrapper makes no transposed or padded copies. Ragged Sq and Skv are
//    masked inside the kernel: rows past Sq are never stored, kv rows past
//    Skv are zero-filled and get position -1.
//  * A kv tile in which no slot can be seen by any query row of the block
//    (empty slots, causal future, outside the window) is skipped whole.
//    Skipping changes no result: such a tile leaves m, l and acc as they
//    are. Under a causal mask this halves the work.
//
// Still to come (later work): wgmma and TMA, a pipelined producer warp,
// ldmatrix, and a backward kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// rows [r0, r0+64) of a (S, D) matrix with row stride `ss` (elements) into
// shared memory with row stride D+8; rows past S are zeros. 16-byte copies:
// the wrapper guarantees 16-byte aligned rows.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int r0, int S) {
  constexpr int V = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BK * V; i += MMA_THREADS) {
    const int r = i / V, c = (i % V) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ o, int Sq,
    int Skv, int H, int KV, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int window, float scale,
    float softcap) {
  constexpr int KS = D / 16;   // k-steps of QK^T
  constexpr int DN = D / 8;    // n-tiles of the output
  constexpr int LD = D + 8;    // padded shared row
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LD];
  __shared__ int sQp[BQ];
  __shared__ int sKp[BK];
  __shared__ int s_qmin, s_qmax;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, thread in group
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  load_q_positions(q_pos, b, q0, Sq, sQp, &s_qmin, &s_qmax);
  const int qmin = s_qmin, qmax = s_qmax;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;   // this thread's two rows
  const int qp_lo = sQp[r_lo], qp_hi = sQp[r_hi];

  // Q fragments (A operand, row-major 16x16 per k-step), staged through sK
  load_tile<D>(sK, qb, q_ss, q0, Sq);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = ld32(&sK[r_lo * LD + c]);
    qa[ks][1] = ld32(&sK[r_hi * LD + c]);
    qa[ks][2] = ld32(&sK[r_lo * LD + c + 8]);
    qa[ks][3] = ld32(&sK[r_hi * LD + c + 8]);
  }

  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    if (!load_kv_positions(kv_pos, b, k0, Skv, sKp, qmin, qmax, causal, window))
      continue;
    load_tile<D>(sK, kb, k_ss, k0, Skv);
    load_tile<D>(sV, vb, v_ss, k0, Skv);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 kv columns; fragment c0,c1 in row r_lo at
    // columns n*8 + 2t, +1; c2,c3 in row r_hi
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = &sK[(n * 8 + g) * LD + ks * 16 + 2 * t];
        mma_bf16(s[n], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], ld32(kr), ld32(kr + 8));
      }
    }

    // online softmax; the four threads of a row group share rows r_lo, r_hi
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const int kp = sKp[n * 8 + 2 * t + (e & 1)];
        x = visible(e < 2 ? qp_lo : qp_hi, kp, causal, window) ? x : NEG_INF;
        s[n][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = e < 2 ? mn_lo : mn_hi;
        // masked entries hold NEG_INF; exp gives 0 unless the row saw
        // nothing yet (mn == NEG_INF), which the test excludes
        s[n][e] = s[n][e] > NEG_INF ? expf(s[n][e] - mn) : 0.f;
      }
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      acc[n][0] *= al_lo; acc[n][1] *= al_lo;
      acc[n][2] *= al_hi; acc[n][3] *= al_hi;
    }

    // O += P V: the S fragments of n-tiles 2kk, 2kk+1 are the A fragment
    // of k-step kk; B is V[kv][d] with kv rows 16kk + 2t, +1 (and +8)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = &sV[(kk * 16 + 2 * t) * LD + g];
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const __nv_bfloat16* vr = v0 + n * 8;
        const uint32_t b0 = pack_raw(vr[0], vr[LD]);
        const uint32_t b1 = pack_raw(vr[8 * LD], vr[9 * LD]);
        mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  const float inv_lo = 1.f / fmaxf(l_lo, 1e-20f), inv_hi = 1.f / fmaxf(l_hi, 1e-20f);
  const int row_lo = q0 + r_lo, row_hi = q0 + r_hi;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_lo < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row_lo) * H + h) * D + c) =
          __floats2bfloat162_rn(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    if (row_hi < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row_hi) * H + h) * D + c) =
          __floats2bfloat162_rn(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
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

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS) flash_fwd_simt(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, float* __restrict__ o, int Sq, int Skv,
    int H, int KV, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int window, float scale,
    float softcap) {
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
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* o;
  int B, Sq, Skv, H, KV;
  const long long* st;
  int causal, window;
  float scale, softcap;
  cudaStream_t stream;
};

template <int D>
int launch_mma(const Args& a) {
  for (int i = 0; i < 9; ++i)
    if (a.st[i] % 8) return (int)cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_mma<D><<<grid, MMA_THREADS, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.q_pos, a.kv_pos,
      static_cast<__nv_bfloat16*>(a.o), a.Sq, a.Skv, a.H, a.KV, a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.st[8], a.causal,
      a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_simt(const Args& a) {
  constexpr int bytes = simt_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_simt<D><<<grid, SIMT_THREADS, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.q_pos, a.kv_pos, static_cast<float*>(a.o),
      a.Sq, a.Skv, a.H, a.KV, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4],
      a.st[5], a.st[6], a.st[7], a.st[8], a.causal, a.window, a.scale, a.softcap);
  return (int)cudaGetLastError();
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
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, q_pos, kv_pos, o, B, Sq, Skv, H, KV, strides,
               causal, window, scale, softcap, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && D == 64) return launch_simt<64>(a);
  if (dtype == 0 && D == 128) return launch_simt<128>(a);
  if (dtype == 1 && D == 64) return launch_mma<64>(a);
  if (dtype == 1 && D == 128) return launch_mma<128>(a);
  return (int)cudaErrorInvalidValue;
}
