// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a): CUDA C++ with a
// plain C entry.
//
// Replaces repro/kernels/ssd/kernel.py::ssd_pallas (Pallas TPU kernel, body
// _kernel; wrapper ops.py::ssd) and computes the same function. For each
// (batch b, head h), over chunks of cl rows, with cum the within-chunk prefix
// sum of dA = dt * A:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//        + exp(cum_i) C_i . S_prev                                  (inter)
//   S    = exp(cum_end) S_prev + sum_j exp(cum_end - cum_j) dt_j x_j B_j^T
// with S (P x N) fp32 carried from chunk to chunk and returned after the
// last. x, B and C are bf16 or fp32; dt and A are fp32; every sum is fp32,
// as in the Pallas body, which casts every operand to fp32.
//
// What bounds it on the H100: at the serving shape (B=4, L=1024, H=64, P=64,
// G=1, N=128, cl=256) the function needs 1.30e10 operations against 79 MB of
// input and output: 0.0132 ms at the 989 TFLOP/s bf16 tensor-core rate,
// 0.0235 ms at 3.35 TB/s, so on the tensor cores it is bound by bytes (on
// the CUDA cores, by the 67 TFLOP/s fp32 rate: 0.195 ms).
//
// bf16 inputs (the serving path): one wrapper call runs four kernels, the
// passes of the plain version (ssd_ref), with scratch from the wrapper:
//  1. ssd_cb, per (b, chunk, group, 64 x 64 tile i >= j): CB = C B^T, once
//     per group and not per head, lower tiles only, into fp32 scratch
//     (b, G, nc, cl, cl).
//  2. ssd_chunk_state, per (b, chunk, head): cum, the within-chunk prefix
//     sum, in fp64 and rounded once (as chunk_cumsum), into scratch
//     (b, H, nc, cl); and the chunk's own state
//     S_c = sum_j (exp(cum_end - cum_j) dt_j x_j) (x) B_j into scratch
//     (b, nc, H, P, N). 1,024 blocks at the serving shape.
//  3. ssd_state_pass, per (b, head, 4 of the P x N values): T_n =
//     exp(cum_end,n) T_{n-1} + S_n, overwriting S_n with T_{n-1}, the state
//     entering chunk n, and writing the final state. It is a chain of
//     dependent loads, so four chunks' loads are in flight at once.
//  4. ssd_chunk_scan, per (b, chunk, head, 64-row i-tile): y_i =
//     exp(cum_i) C_i R_n + sum_{j <= i} W_ij x_j, W = CB o exp(cum_i -
//     cum_j) o dt_j, masked inside the exponent. Rows at or past L act as
//     dt = 0, x = B = C = 0 and are never stored. The inter-chunk product
//     is cut by p-columns per warp, so that each fp32 R value is split once
//     per block; the intra-chunk one by rows, so that each W value (an exp)
//     is made once.
// The passes run in stream order, four launches per call.
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate) with fp32 accuracy: a product of two bf16 values is exact in
// fp32, so C B^T is exact up to summation order. The three products with an
// fp32 operand (W x, (w o x)^T B, C R) split it into three bf16 parts, hi =
// bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), whose sum is v to
// ~2^-24 relative, and issue three mma into one fp32 accumulator; the other
// operand (x, B, C) is bf16 and exact. One bf16 pass would err by ~2^-9 of
// each term, which the checks' 1e-5 of the terms' magnitudes refuses.
// Tiles are loaded with cp.async (16 bytes, zero-fill past the ragged end)
// into double-buffered shared memory, rows padded so that ldmatrix and the
// fragment loads are free of bank conflicts; values become fp32 only in
// registers.
//
// fp32 inputs run ssd_fwd_f32: one block per (head, batch) walking the
// chunks, every product fp32 on the CUDA cores, the state in shared memory.
// It is for checks; the model serves in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // fp32 kernel: a 16 x 16 grid of threads
constexpr int TILE = 64;         // rows of a chunk per tile
constexpr int MAX_CHUNK = 256;   // == THREADS: one thread per row in the scan
constexpr int TS = TILE + 4;     // padded row of a transposed tile, in floats

// K consecutive floats from shared memory, as 16-byte loads where K allows.
template <int K>
__device__ __forceinline__ void lds(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

// dst[k * TS + i] = src[(row0 + i) * rstride + k], k < W, i < TILE: a tile
// stored transposed; rows at or past `valid` are zero and are not read.
template <int W>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int row0,
                                                int valid, long long rstride) {
  for (int e = threadIdx.x; e < TILE * W; e += THREADS) {
    const int i = e / W, k = e % W;
    dst[k * TS + i] = i < valid ? src[(long long)(row0 + i) * rstride + k] : 0.f;
  }
}

// dst[i * W + k] = src[(row0 + i) * rstride + k]: a tile as it lies.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int valid, long long rstride) {
  for (int e = threadIdx.x; e < TILE * W; e += THREADS) {
    const int i = e / W, k = e % W;
    dst[i * W + k] = i < valid ? src[(long long)(row0 + i) * rstride + k] : 0.f;
  }
}

template <int P, int N>
constexpr int smem_bytes() {
  return MAX_CHUNK * (int)sizeof(double) +
         (2 * N * TS + TILE * P + TILE * TS + N * P + 2 * MAX_CHUNK + TILE) *
             (int)sizeof(float);
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_fwd_f32(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ state, int L, int H, int G, int cl) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  constexpr int RP = P / 16;     // y columns per thread
  constexpr int SP = P / 16;     // state rows per thread
  constexpr int SN = N / 16;     // state columns per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* scan = reinterpret_cast<double*>(smem_raw);       // [MAX_CHUNK]
  float* Ct = reinterpret_cast<float*>(scan + MAX_CHUNK);   // [N][TS]   C_i^T
  float* Bt = Ct + N * TS;       // [N][TS] B_j^T; the state pass keeps B_j as [TILE][N]
  float* Xs = Bt + N * TS;       // [TILE][P]  x_j
  float* Wt = Xs + TILE * P;     // [TILE][TS] W^T
  float* St = Wt + TILE * TS;    // [N][P]     S^T
  float* cum = St + N * P;       // [MAX_CHUNK]
  float* dts = cum + MAX_CHUNK;  // [MAX_CHUNK]
  float* wst = dts + MAX_CHUNK;  // [TILE]     exp(cum_end - cum_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a = A[h];
  const int nc = (L + cl - 1) / cl;
  const int nt = (cl + TILE - 1) / TILE;
  const long long xrow = (long long)H * P;   // row stride of x and y (B, L, H, P)
  const long long brow = (long long)G * N;   // row stride of B and C (B, L, G, N)
  const float* xb = x + (long long)b * L * xrow + (long long)h * P;
  float* yb = y + (long long)b * L * xrow + (long long)h * P;
  const float* Bb = Bm + (long long)b * L * brow + (long long)g * N;
  const float* Cb = Cm + (long long)b * L * brow + (long long)g * N;
  const float* dtb = dt + (long long)b * L * H + h;

  for (int e = tid; e < N * P; e += THREADS) St[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int l0 = c * cl;
    const int rows = min(cl, L - l0);         // rows of this chunk that exist

    // dt, and the prefix sum of dA = dt * A (fp32 product) in fp64
    const float d = tid < rows ? dtb[(long long)(l0 + tid) * H] : 0.f;
    dts[tid] = d;
    scan[tid] = (double)(d * a);
    __syncthreads();
    for (int off = 1; off < MAX_CHUNK; off <<= 1) {
      const double v = tid >= off ? scan[tid - off] : 0.0;
      __syncthreads();
      scan[tid] += v;
      __syncthreads();
    }
    cum[tid] = (float)scan[tid];
    __syncthreads();
    const float cum_end = cum[cl - 1];

    // ---- y of the chunk, one i-tile at a time ----
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * TILE;
      load_transposed<N>(Ct, Cb, l0 + i0, rows - i0, brow);
      float acc[4][RP] = {};
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TILE;
        load_transposed<N>(Bt, Bb, l0 + j0, rows - j0, brow);
        load_rows<P>(Xs, xb, l0 + j0, rows - j0, xrow);
        __syncthreads();
        // W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
        float s[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
          lds(Ct + n * TS + ty * 4, cv);
          lds(Bt + n * TS + tx * 4, bv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) s[r][q] += cv[r] * bv[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tx * 4 + q;
          float w[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty * 4 + r;
            w[r] = j <= i ? s[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
          *reinterpret_cast<float4*>(Wt + (tx * 4 + q) * TS + ty * 4) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();
        // y_i += W x_j
#pragma unroll 4
        for (int j = 0; j < TILE; ++j) {
          float wv[4], xv[RP];
          lds(Wt + j * TS + ty * 4, wv);
          lds(Xs + j * P + tx * RP, xv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < RP; ++q) acc[r][q] += wv[r] * xv[q];
        }
        __syncthreads();
      }
      // inter-chunk term exp(cum_i) C_i . S_prev, then store the valid rows
      float acc2[4][RP] = {};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[RP];
        lds(Ct + n * TS + ty * 4, cv);
        lds(St + n * P + tx * RP, sv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) acc2[r][q] += cv[r] * sv[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i < rows) {
          const float e = expf(cum[i]);
          float* yp = yb + (long long)(l0 + i) * xrow + tx * RP;
#pragma unroll
          for (int q = 0; q < RP; ++q) yp[q] = acc[r][q] + e * acc2[r][q];
        }
      }
      __syncthreads();
    }

    // ---- state: S = exp(cum_end) S + sum_j exp(cum_end - cum_j) dt_j x_j B_j^T
    const int tp = tid / 16, tn = tid % 16;
    float sacc[SP][SN] = {};
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * TILE;
      load_rows<N>(Bt, Bb, l0 + j0, rows - j0, brow);
      load_rows<P>(Xs, xb, l0 + j0, rows - j0, xrow);
      if (tid < TILE) wst[tid] = expf(cum_end - cum[j0 + tid]) * dts[j0 + tid];
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        const float w = wst[j];
        float xv[SP], bv[SN];
        lds(Xs + j * P + tp * SP, xv);
        lds(Bt + j * N + tn * SN, bv);
#pragma unroll
        for (int p = 0; p < SP; ++p) {
          const float u = xv[p] * w;
#pragma unroll
          for (int k = 0; k < SN; ++k) sacc[p][k] += u * bv[k];
        }
      }
      __syncthreads();
    }
    const float decay = expf(cum_end);
#pragma unroll
    for (int p = 0; p < SP; ++p)
#pragma unroll
      for (int k = 0; k < SN; ++k) {
        float* sp = St + (tn * SN + k) * P + tp * SP + p;
        *sp = decay * *sp + sacc[p][k];
      }
    __syncthreads();
  }

  float* sb = state + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) sb[e] = St[(e % N) * P + e / N];
}

// ---------------------------------------------------------------------------
// bf16: four passes on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is then
// not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// rows [r0, r0 + TILE) of a row-major bf16 matrix (row stride rs elements,
// W columns) into shared memory as [TILE][W + 8] (the 16-byte pad keeps
// eight consecutive rows on distinct banks); rows at or past `valid` are
// zeros. NT threads share the copy.
template <int W, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long rs,
                                                int r0, int valid) {
  constexpr int V = W / 8;
  for (int e = threadIdx.x; e < TILE * V; e += NT) {
    const int r = e / V, c = (e % V) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * (W + 8) + c, ok ? src + (long long)(r0 + r) * rs + c : src, ok);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b: mma.sync m16n8k16, bf16 in, fp32 accumulate. a is the row-major
// 16 x 16 A fragment, (b0, b1) the column-major 16 x 8 B fragment.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from a row-major [k][n] tile, transposed: with
// lane l addressing row k0 + ((l >> 3) & 1) * 8 + (l & 7), column n0 +
// (l >> 4) * 8, r[0], r[1] are the B fragment of n-tile n0 and r[2], r[3]
// that of n-tile n0 + 8, for k-rows k0..k0+15.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// Two fp32 values, each split into three bf16 parts, hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid) (each difference exact in fp32), so
// that hi + mid + lo equals v to ~2^-24 relative; packed two to a register,
// v0 in the low half.
struct Split3 {
  uint32_t hi, mid, lo;
};
__device__ __forceinline__ Split3 split3(float v0, float v1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(hi), r1 = v1 - __high2float(hi);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 lo =
      __floats2bfloat162_rn(r0 - __low2float(mid), r1 - __high2float(mid));
  return {as_u32(hi), as_u32(mid), as_u32(lo)};
}

// c += (hi + mid + lo) b, smallest part first
__device__ __forceinline__ void mma_split_a(float (&c)[4], const Split3 (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  const uint32_t lo[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
  const uint32_t mid[4] = {a[0].mid, a[1].mid, a[2].mid, a[3].mid};
  const uint32_t hi[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  mma16816(c, lo, b0, b1);
  mma16816(c, mid, b0, b1);
  mma16816(c, hi, b0, b1);
}

// ---- pass 1: CB = C B^T per (b, chunk, group), lower 64 x 64 tiles ----
template <int N>
__global__ void __launch_bounds__(128) ssd_cb(const bf16* __restrict__ Bm,
                                              const bf16* __restrict__ Cm,
                                              float* __restrict__ cb, int L, int G, int cl,
                                              int nc) {
  constexpr int LD = N + 8;
  __shared__ __align__(16) bf16 sC[TILE * LD];
  __shared__ __align__(16) bf16 sB[TILE * LD];
  int it = 0, jt = blockIdx.x;                   // pair index -> (it, jt <= it)
  while (jt > it) jt -= ++it;
  const int c = blockIdx.y, b = blockIdx.z / G, grp = blockIdx.z % G;
  const int l0 = c * cl, rows = min(cl, L - l0);
  const long long rs = (long long)G * N;
  const long long base = ((long long)b * L + l0) * rs + (long long)grp * N;
  load_tile_async<N, 128>(sC, Cm + base, rs, it * TILE, rows - it * TILE);
  load_tile_async<N, 128>(sB, Bm + base, rs, jt * TILE, rows - jt * TILE);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  float acc[8][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
    const bf16* ca = sC + (warp * 16 + gq) * LD + k0 + 2 * t;
    const uint32_t a[4] = {ld32(ca), ld32(ca + 8 * LD), ld32(ca + 8), ld32(ca + 8 * LD + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* bb = sB + (n * 8 + gq) * LD + k0 + 2 * t;
      mma16816(acc[n], a, ld32(bb), ld32(bb + 8));
    }
  }
  float* out = cb + (((long long)b * G + grp) * nc + c) * cl * cl;
  const int i_lo = it * TILE + warp * 16 + gq, i_hi = i_lo + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int j = jt * TILE + n * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? i_lo : i_hi, jj = j + (e & 1);
      if (i < cl && jj < cl) out[(long long)i * cl + jj] = acc[n][e];
    }
  }
}

// ---- pass 2: cum and the chunk's own state, per (b, chunk, head) ----
template <int P, int N>
struct StateCfg {
  static constexpr int MT = P / 16;                              // m-tiles (p)
  static constexpr int NTL = N / 8;                              // n-tiles (n)
  static constexpr int NPW = NTL * MT / 8 > 2 ? NTL * MT / 8 : 2;  // n-tiles a warp
  static constexpr int WARPS = MT * (NTL / NPW);                 // warps with work, <= 8
  static constexpr int XLD = P + 8, BLD = N + 8;
  static constexpr int SMEM = 2 * TILE * (XLD + BLD) * (int)sizeof(bf16);
};

template <int P, int N>
__global__ void __launch_bounds__(256) ssd_chunk_state(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, float* __restrict__ cum_out, float* __restrict__ states,
    int L, int H, int G, int cl, int nc) {
  using S = StateCfg<P, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);      // [2][TILE][XLD]  x_j
  bf16* sB = sX + 2 * TILE * S::XLD;             // [2][TILE][BLD]  B_j
  __shared__ float s_w[MAX_CHUNK];
  __shared__ double s_part[8];

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l0 = c * cl, rows = min(cl, L - l0);
  const int nt = (cl + TILE - 1) / TILE;
  const long long xs = (long long)H * P, bs = (long long)G * N;
  const bf16* xb = x + ((long long)b * L + l0) * xs + (long long)h * P;
  const bf16* Bb = Bm + ((long long)b * L + l0) * bs + (long long)grp * N;

  load_tile_async<P, 256>(sX, xb, xs, 0, rows);  // the first tile loads during the scan
  load_tile_async<N, 256>(sB, Bb, bs, 0, rows);
  cp_async_commit();

  // cum: prefix sum of dA = dt * A (an fp32 product) in fp64, rounded once
  const float d = tid < rows ? dt[((long long)b * L + l0 + tid) * H + h] : 0.f;
  double v = (double)(d * A[h]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) s_part[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += s_part[w];
  const float cumf = (float)v;
  if (tid < cl) cum_out[(((long long)b * H + h) * nc + c) * cl + tid] = cumf;
  s_w[tid] = cumf;
  __syncthreads();
  const float w = expf(s_w[cl - 1] - cumf) * d;  // exp(cum_end - cum_j) dt_j
  __syncthreads();
  s_w[tid] = w;

  // S[p][n] = sum_j (w_j x_j[p]) B_j[n]: A = w o x (fp32, split), B = B_j
  const int mt = warp % S::MT, ng = warp / S::MT;
  const int gq = lane >> 2, t = lane & 3, p_lo = mt * 16 + gq;
  float acc[S::NPW][4] = {};
  for (int jt = 0; jt < nt; ++jt) {
    const int buf = jt & 1;
    if (jt + 1 < nt) {
      const int r1 = (jt + 1) * TILE;
      load_tile_async<P, 256>(sX + (buf ^ 1) * TILE * S::XLD, xb, xs, r1, rows - r1);
      load_tile_async<N, 256>(sB + (buf ^ 1) * TILE * S::BLD, Bb, bs, r1, rows - r1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp < S::WARPS) {
      const bf16* X = sX + buf * TILE * S::XLD;
      const bf16* Bt = sB + buf * TILE * S::BLD;
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        const int j = kk * 16 + 2 * t;           // A columns j, j+1, j+8, j+9
        const float* wj = s_w + jt * TILE + j;
        auto xa = [&](int dj, int dp) {
          return wj[dj] * __bfloat162float(X[(j + dj) * S::XLD + p_lo + dp]);
        };
        const Split3 a[4] = {split3(xa(0, 0), xa(1, 0)), split3(xa(0, 8), xa(1, 8)),
                             split3(xa(8, 0), xa(9, 0)), split3(xa(8, 8), xa(9, 8))};
        const int m = lane >> 3, r = lane & 7;
#pragma unroll
        for (int n = 0; n < S::NPW; n += 2) {
          uint32_t bq[4];
          ldsm_x4_trans(bq, Bt + (kk * 16 + (m & 1) * 8 + r) * S::BLD +
                                (ng * S::NPW + n) * 8 + (m >> 1) * 8);
          mma_split_a(acc[n], a, bq[0], bq[1]);
          mma_split_a(acc[n + 1], a, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();
  }
  if (warp < S::WARPS) {
    float* out = states + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int n = 0; n < S::NPW; ++n) {
      const int col = (ng * S::NPW + n) * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + p_lo * N + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + (p_lo + 8) * N + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---- pass 3: the states entering each chunk, per (b, head, 4 values) ----
__global__ void __launch_bounds__(256) ssd_state_pass(float* __restrict__ states,
                                                      const float* __restrict__ cum,
                                                      float* __restrict__ final_state,
                                                      int PN, int H, int cl, int nc) {
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* cum_end = cum + ((long long)b * H + h) * nc * cl + (cl - 1);
  float4 T = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int AHEAD = 4;                       // chunks whose loads are in flight together
  for (int n0 = 0; n0 < nc; n0 += AHEAD) {
    float4 s[AHEAD];
    float a[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (n0 + k < nc) {
        a[k] = cum_end[(long long)(n0 + k) * cl];
        s[k] = *reinterpret_cast<const float4*>(
            states + (((long long)b * nc + n0 + k) * H + h) * PN + e);
      }
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (n0 + k < nc) {
        *reinterpret_cast<float4*>(states + (((long long)b * nc + n0 + k) * H + h) * PN + e) =
            T;                                   // R_n: the state entering chunk n
        const float d = expf(a[k]);
        T = make_float4(d * T.x + s[k].x, d * T.y + s[k].y, d * T.z + s[k].z,
                        d * T.w + s[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(final_state + ((long long)b * H + h) * PN + e) = T;
}

// ---- pass 4: y, per (b, chunk, head, 64-row i-tile) ----
template <int P, int N>
struct ScanCfg {
  static constexpr int XLD = P + 8, CLD = N + 8, RLD = N + 8, YLD = P + 8;
  static constexpr int NTP = P / 8;              // n-tiles of y (p)
  // R [P][RLD], later the inter-chunk sums Y [TILE][YLD], in one region
  static constexpr int R_FLOATS = P * RLD > TILE * YLD ? P * RLD : TILE * YLD;
  static constexpr int SMEM = (2 * TILE * XLD + TILE * CLD) * (int)sizeof(bf16) +
                              R_FLOATS * (int)sizeof(float);
};

template <int P, int N>
__global__ void __launch_bounds__(128) ssd_chunk_scan(
    const bf16* __restrict__ x, const float* __restrict__ dt, const bf16* __restrict__ Cm,
    const float* __restrict__ cb, const float* __restrict__ cum,
    const float* __restrict__ states, bf16* __restrict__ y, int L, int H, int G, int cl,
    int nc) {
  using S = ScanCfg<P, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);                  // [2][TILE][XLD]  x_j
  bf16* sC = sX + 2 * TILE * S::XLD;                         // [TILE][CLD]     C_i
  float* sR = reinterpret_cast<float*>(sC + TILE * S::CLD);  // [P][RLD]        R, then Y
  __shared__ float s_cum[MAX_CHUNK], s_dt[MAX_CHUNK];

  const int it = blockIdx.x, h = blockIdx.y, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int grp = h / (H / G);
  const int l0 = c * cl, rows = min(cl, L - l0), i0 = it * TILE;
  if (i0 >= rows) return;                        // a tile of padding rows only
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const long long xs = (long long)H * P, bs = (long long)G * N;
  const bf16* xb = x + ((long long)b * L + l0) * xs + (long long)h * P;

  load_tile_async<N, 128>(sC, Cm + ((long long)b * L + l0) * bs + (long long)grp * N, bs, i0,
                          rows - i0);
  if (c > 0) {
    const float* R = states + (((long long)b * nc + c) * H + h) * P * N;
    for (int e = tid; e < P * N / 4; e += 128) {
      const int r = e / (N / 4), k = (e % (N / 4)) * 4;
      cp_async16(sR + r * S::RLD + k, R + r * N + k, true);
    }
  }
  load_tile_async<P, 128>(sX, xb, xs, 0, rows);
  cp_async_commit();
  const float* cumb = cum + (((long long)b * H + h) * nc + c) * cl;
  for (int j = tid; j < i0 + TILE; j += 128) {
    s_cum[j] = j < cl ? cumb[j] : 0.f;
    s_dt[j] = j < rows ? dt[((long long)b * L + l0 + j) * H + h] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int i_lo = i0 + warp * 16 + gq, i_hi = i_lo + 8;    // rows in the chunk
  const float cum_lo = s_cum[i_lo], cum_hi = s_cum[i_hi];
  float acc[S::NTP][4] = {};
  if (c > 0) {
    // acc = exp(cum_i) C_i R^T: M = 64 rows, N = P, K = N, A = C_i (bf16),
    // B = R (fp32, split). Warp w takes p-columns 16w..16w+15 of every row,
    // so that each R value is split once per block (the bf16 C fragments
    // are re-read instead); the sums reach the row layout of acc through
    // shared memory.
    float yi[4][2][4] = {};
    if (2 * warp < S::NTP) {
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        Split3 rb[2][2];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const float* rr = sR + ((2 * warp + nn) * 8 + gq) * S::RLD + k0 + 2 * t;
          const float2 r0 = *reinterpret_cast<const float2*>(rr);
          const float2 r1 = *reinterpret_cast<const float2*>(rr + 8);
          rb[nn][0] = split3(r0.x, r0.y);
          rb[nn][1] = split3(r1.x, r1.y);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const bf16* ca = sC + (mt * 16 + gq) * S::CLD + k0 + 2 * t;
          const uint32_t a[4] = {ld32(ca), ld32(ca + 8 * S::CLD), ld32(ca + 8),
                                 ld32(ca + 8 * S::CLD + 8)};
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            mma16816(yi[mt][nn], a, rb[nn][0].lo, rb[nn][1].lo);
            mma16816(yi[mt][nn], a, rb[nn][0].mid, rb[nn][1].mid);
            mma16816(yi[mt][nn], a, rb[nn][0].hi, rb[nn][1].hi);
          }
        }
      }
    }
    __syncthreads();                             // R is read: its space takes Y
    float* Y = sR;                               // [TILE][YLD]
    if (2 * warp < S::NTP) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          float* yp = Y + (mt * 16 + gq) * S::YLD + (2 * warp + nn) * 8 + 2 * t;
          *reinterpret_cast<float2*>(yp) = make_float2(yi[mt][nn][0], yi[mt][nn][1]);
          *reinterpret_cast<float2*>(yp + 8 * S::YLD) =
              make_float2(yi[mt][nn][2], yi[mt][nn][3]);
        }
    }
    __syncthreads();
    const float e_lo = expf(cum_lo), e_hi = expf(cum_hi);
#pragma unroll
    for (int n = 0; n < S::NTP; ++n) {
      const float* yp = Y + (warp * 16 + gq) * S::YLD + n * 8 + 2 * t;
      const float2 v_lo = *reinterpret_cast<const float2*>(yp);
      const float2 v_hi = *reinterpret_cast<const float2*>(yp + 8 * S::YLD);
      acc[n][0] = e_lo * v_lo.x; acc[n][1] = e_lo * v_lo.y;
      acc[n][2] = e_hi * v_hi.x; acc[n][3] = e_hi * v_hi.y;
    }
  }

  // acc += W x_j over j-tiles jt <= it: A = W (fp32, split), B = x_j
  const float* cbb = cb + (((long long)b * G + grp) * nc + c) * cl * cl;
  auto weight = [&](int i, float cum_i, int j) {   // masked inside the exponent
    if (j > i || j >= cl || i >= cl) return 0.f;
    return cbb[(long long)i * cl + j] * expf(cum_i - s_cum[j]) * s_dt[j];
  };
  const int m = lane >> 3, r = lane & 7;
  for (int jt = 0; jt <= it; ++jt) {
    const int buf = jt & 1;
    if (jt < it) {
      load_tile_async<P, 128>(sX + (buf ^ 1) * TILE * S::XLD, xb, xs, (jt + 1) * TILE,
                              rows - (jt + 1) * TILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* X = sX + buf * TILE * S::XLD;
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const int jb = jt * TILE + kk * 16;
      if (jb > i0 + warp * 16 + 15) break;       // j > i for every row of the warp
      const int j = jb + 2 * t;
      const Split3 a[4] = {
          split3(weight(i_lo, cum_lo, j), weight(i_lo, cum_lo, j + 1)),
          split3(weight(i_hi, cum_hi, j), weight(i_hi, cum_hi, j + 1)),
          split3(weight(i_lo, cum_lo, j + 8), weight(i_lo, cum_lo, j + 9)),
          split3(weight(i_hi, cum_hi, j + 8), weight(i_hi, cum_hi, j + 9))};
#pragma unroll
      for (int n = 0; n < S::NTP; n += 2) {
        uint32_t bq[4];
        ldsm_x4_trans(bq, X + (kk * 16 + (m & 1) * 8 + r) * S::XLD + n * 8 + (m >> 1) * 8);
        mma_split_a(acc[n], a, bq[0], bq[1]);
        mma_split_a(acc[n + 1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }

  bf16* yb = y + ((long long)b * L + l0) * xs + (long long)h * P;
#pragma unroll
  for (int n = 0; n < S::NTP; ++n) {
    const int col = n * 8 + 2 * t;
    if (i_lo < rows)
      *reinterpret_cast<__nv_bfloat162*>(yb + i_lo * xs + col) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (i_hi < rows)
      *reinterpret_cast<__nv_bfloat162*>(yb + i_hi * xs + col) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

template <int P, int N>
int launch_f32(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, float* state, int B, int L, int H, int G,
               int cl, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_f32<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_f32<P, N><<<dim3(H, B), THREADS, bytes, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), state, L, H, G, cl);
  return (int)cudaGetLastError();
}

// the four passes, in stream order
template <int P, int N>
int launch_bf16(const void* x, const float* dt, const float* A, const void* Bm,
                const void* Cm, void* y, float* state, float* cb, float* cum,
                float* states, int B, int L, int H, int G, int cl, cudaStream_t stream) {
  const int nc = (L + cl - 1) / cl, nt = (cl + TILE - 1) / TILE;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  ssd_cb<N><<<dim3(nt * (nt + 1) / 2, nc, B * G), 128, 0, stream>>>(Bb, Cb, cb, L, G, cl, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  using SC = StateCfg<P, N>;
  err = cudaFuncSetAttribute(ssd_chunk_state<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SC::SMEM);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state<P, N><<<dim3(H, nc, B), 256, SC::SMEM, stream>>>(
      xb, dt, A, Bb, cum, states, L, H, G, cl, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ssd_state_pass<<<dim3((P * N / 4 + 255) / 256, H, B), 256, 0, stream>>>(
      states, cum, state, P * N, H, cl, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  using SS = ScanCfg<P, N>;
  err = cudaFuncSetAttribute(ssd_chunk_scan<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SS::SMEM);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan<P, N><<<dim3(nt, H, B * nc), 128, SS::SMEM, stream>>>(
      xb, dt, Cb, cb, cum, states, static_cast<bf16*>(y), L, H, G, cl, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (B, L, H, P) and Bm, Cm (B, L, G, N) in one dtype (0 = float32,
// 1 = bfloat16); dt (B, L, H) and A (H,) float32; state (B, H, P, N)
// float32, written. All contiguous. cl: chunk length, 1..256. bf16 also
// takes fp32 scratch, written: cb (B, G, nc, cl, cl), cum (B, H, nc, cl) and
// states (B, nc, H, P, N), nc = ceil(L / cl), and needs cl % 8 == 0 and
// 16-byte aligned x, Bm, Cm; fp32 ignores the scratch.
// Returns the CUDA error code of the first launch that failed (0 on success).
extern "C" int ssd_fwd(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, void* y, float* state,
                       float* cb, float* cum, float* states,
                       int B, int L, int H, int P, int G, int N, int cl,
                       int dtype, void* stream) {
  if (B <= 0 || L <= 0 || G <= 0 || H % G != 0 || cl <= 0 || cl > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (cl % 8 || cb == nullptr || cum == nullptr || states == nullptr)
      return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
         reinterpret_cast<uintptr_t>(Cm)) % 16)
      return (int)cudaErrorMisalignedAddress;
    if (P == 64 && N == 128)
      return launch_bf16<64, 128>(x, dt, A, Bm, Cm, y, state, cb, cum, states, B, L, H, G,
                                  cl, s);
    if (P == 16 && N == 16)
      return launch_bf16<16, 16>(x, dt, A, Bm, Cm, y, state, cb, cum, states, B, L, H, G,
                                 cl, s);
  } else if (dtype == 0) {
    if (P == 64 && N == 128)
      return launch_f32<64, 128>(x, dt, A, Bm, Cm, y, state, B, L, H, G, cl, s);
    if (P == 16 && N == 16)
      return launch_f32<16, 16>(x, dt, A, Bm, Cm, y, state, B, L, H, G, cl, s);
  }
  return (int)cudaErrorInvalidValue;
}
