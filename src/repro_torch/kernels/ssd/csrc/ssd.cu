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
// last. x, B and C are bf16 or fp32; dt and A are fp32; every product and sum
// is fp32 on the CUDA cores, as in the Pallas body, which casts every operand
// to fp32 (no bf16 or TF32 products: they would change the numbers).
//
// What bounds it on the H100: operations. At the serving shape (B=4,
// L=1024, H=64, P=64, G=1, N=128, cl=256) the function needs 1.30e10
// operations against 79 MB of input and output: 0.195 ms at the 67 TFLOP/s
// fp32 rate, 0.024 ms at 3.35 TB/s. The design keeps every intermediate on
// chip so that the operations are all that is left:
//
//  * One block per (head, batch). The TPU kernel carries S in VMEM scratch
//    along a sequential chunk axis of its grid; here the chunk loop runs
//    inside the block and S lives in shared memory for the whole sequence.
//    That is 256 blocks at the serving shape, about two waves on 132 SMs.
//  * A whole chunk's fp32 C and B tiles (2 x 128 KB at cl=256, N=128) do not
//    fit in the 227 KB a block may have, so the chunk is cut into 64-row
//    tiles: for each i-tile and each j-tile j <= i the block forms the
//    64 x 64 W = (C_i B_j^T) * exp(cum_i - cum_j) * dt_j, masked before the
//    exp, and accumulates y_i += W x_j in registers; then adds
//    exp(cum_i) C_i S_prev. S is updated only after every i-tile, so the
//    inter-chunk term reads the state from before the chunk.
//  * 256 threads as a 16 x 16 grid; each thread owns a 4 x (P/16) block of
//    y and a (P/16) x (N/16) block of S. C, B and W are staged transposed
//    (rows padded to 68 floats) so the inner loops read 16-byte vectors
//    without bank conflicts.
//  * The within-chunk prefix sum is a block-wide scan in fp64, rounded to
//    fp32 once: the plain version does the same, so both sides get the same
//    cum, whose rounding exp(cum_i - cum_j) would otherwise amplify.
//  * Ragged L: rows at or past L act as dt = 0, x = B = C = 0 (the JAX
//    wrapper's padding) and are never stored; the wrapper makes no copies.
//
// What it leaves for later work (it stays as it is, with its time):
//  * With G = 1 all heads share B and C, so the per-(b, h) blocks recompute
//    the same C B^T H times (64x at the serving shape). The Pallas kernel does
//    the same (its STREAMING_OPERANDS note). Computing it once per group is
//    the first thing to remove.
//  * Diagonal tiles compute their masked half; CUDA cores instead of tensor
//    cores (bf16 mma.sync for C B^T is exact in fp32); no pipelining of the
//    tile loads; one block per SM (140 KB of shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // a 16 x 16 grid of threads
constexpr int TILE = 64;         // rows of a chunk per tile
constexpr int MAX_CHUNK = 256;   // == THREADS: one thread per row in the scan
constexpr int TS = TILE + 4;     // padded row of a transposed tile, in floats

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
template <int W, typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, int row0,
                                                int valid, long long rstride) {
  for (int e = threadIdx.x; e < TILE * W; e += THREADS) {
    const int i = e / W, k = e % W;
    dst[k * TS + i] = i < valid ? to_f32(src[(long long)(row0 + i) * rstride + k]) : 0.f;
  }
}

// dst[i * W + k] = src[(row0 + i) * rstride + k]: a tile as it lies.
template <int W, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int valid, long long rstride) {
  for (int e = threadIdx.x; e < TILE * W; e += THREADS) {
    const int i = e / W, k = e % W;
    dst[i * W + k] = i < valid ? to_f32(src[(long long)(row0 + i) * rstride + k]) : 0.f;
  }
}

template <int P, int N>
constexpr int smem_bytes() {
  return MAX_CHUNK * (int)sizeof(double) +
         (2 * N * TS + TILE * P + TILE * TS + N * P + 2 * MAX_CHUNK + TILE) *
             (int)sizeof(float);
}

template <int P, int N, typename T>
__global__ void __launch_bounds__(THREADS) ssd_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
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
  const T* xb = x + (long long)b * L * xrow + (long long)h * P;
  T* yb = y + (long long)b * L * xrow + (long long)h * P;
  const T* Bb = Bm + (long long)b * L * brow + (long long)g * N;
  const T* Cb = Cm + (long long)b * L * brow + (long long)g * N;
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
          T* yp = yb + (long long)(l0 + i) * xrow + tx * RP;
#pragma unroll
          for (int q = 0; q < RP; ++q) store(yp + q, acc[r][q] + e * acc2[r][q]);
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

template <int P, int N, typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int B, int L, int H, int G,
           int cl, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<P, N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_kernel<P, N, T><<<dim3(H, B), THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, L, H, G, cl);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (B, L, H, P) and Bm, Cm (B, L, G, N) in one dtype (0 = float32,
// 1 = bfloat16); dt (B, L, H) and A (H,) float32; state (B, H, P, N)
// float32, written. All contiguous. cl: chunk length, 1..256.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssd_fwd(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, void* y, float* state,
                       int B, int L, int H, int P, int G, int N, int cl,
                       int dtype, void* stream) {
  if (B <= 0 || L <= 0 || G <= 0 || H % G != 0 || cl <= 0 || cl > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128 && dtype == 0)
    return launch<64, 128, float>(x, dt, A, Bm, Cm, y, state, B, L, H, G, cl, s);
  if (P == 64 && N == 128 && dtype == 1)
    return launch<64, 128, __nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, L, H, G, cl, s);
  if (P == 16 && N == 16 && dtype == 0)
    return launch<16, 16, float>(x, dt, A, Bm, Cm, y, state, B, L, H, G, cl, s);
  if (P == 16 && N == 16 && dtype == 1)
    return launch<16, 16, __nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, L, H, G, cl, s);
  return (int)cudaErrorInvalidValue;
}
