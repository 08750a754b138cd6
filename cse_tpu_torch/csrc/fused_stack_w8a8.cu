// Hopper (sm_90a) port of cse_tpu/ops/fused_stack.py::_stack_kernel_w8a8
// (:130) with _qdot (:115): the inference stack whose four projections per
// layer run int8 x int8 -> int32 with a per-output-channel weight scale s
// (fused_stack.py::quantize_stacked, :159) and a dynamic scale per activation
// row. The host wrapper is cse_tpu_torch/ops/fused_stack_w8a8.py; the stack's
// LayerNorm (fp32 out) and attention (bf16 operands, fp32 out) are the
// serving kernels of fused_stack.cu.
//
//   (a) quantize_rows_kernel: one warp per fp32 row of K <= 1024 values:
//       sa = max(max |h|, 1e-12) / 127, q = round-half-even(h / sa) with a
//       true division (__fdiv_rn, never __fdividef), written as int8, and sa.
//       Bit-exact against the plain version. Bound by bytes (reads 4 B,
//       writes 1 B per element). A separate pass rather than a LayerNorm
//       epilogue: the attention and FFN1 outputs need the same pass, and it
//       keeps the LN kernel shared with the other paths.
//   (b) linear_w8a8_kernel: C = A[M, K] . W[K, N] with A int8 row-major and W
//       read transposed (Wt [N, K], each output channel's K bytes
//       contiguous), on the int8 tensor cores (mma.sync m16n8k32 s8 x s8 ->
//       s32; 128 x 128 tiles, 64-byte k steps in a 4-stage cp.async ring;
//       ldmatrix loads the int8 fragments, whose byte layout is that of the
//       bf16 m16n8k16 fragments). Integer accumulation is exact. The epilogue
//       forms y = float(acc) * sa[row] * s[col] in that order in fp32, then
//       y + b (QKV, fp32 out), relu(y + b) (FFN1, fp32 out: it is quantized
//       again) or (r + y) + b into the fp32 residual r (out-proj, FFN2), the
//       association JAX writes. At M ~ 5e5 rows, K, N <= 1024 the fp32
//       output and residual traffic outweighs the 1,979 TOP/s of int8 work:
//       bound by bytes, like the bf16 GEMM of fused_stack.cu.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

enum Epilogue { EPI_BIAS = 0, EPI_RELU = 1, EPI_RESIDUAL = 2 };

// ---------------------------------------------------------------- (a) quantizer
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const float* __restrict__ h, int8_t* __restrict__ q, float* __restrict__ sa, long long M,
                     int K) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* hr = h + row * K;
  float m = 0.f;
  for (int i = lane; i < K; i += 32) m = fmaxf(m, fabsf(hr[i]));
  const float s = __fdiv_rn(fmaxf(warp_max(m), 1e-12f), 127.0f);
  int8_t* qr = q + row * K;
  for (int i = lane; i < K; i += 32) qr[i] = (int8_t)__float2int_rn(__fdiv_rn(hr[i], s));
  if (lane == 0) sa[row] = s;
}

// ---------------------------------------------------------------- (b) int8 GEMM
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;  // BK in bytes (= int8 values)
constexpr int LDS = BK + 16;                            // 80-byte rows: ldmatrix conflict-free
constexpr int A_STAGE = BM * LDS, B_STAGE = BN * LDS;
constexpr size_t LINEAR_W8A8_SMEM = STAGES * (A_STAGE + B_STAGE);

// d += a[16 x 32] . b[32 x 8], int8 operands, int32 accumulators
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const int8_t* p) {
  ldmatrix_x4(r, reinterpret_cast<const bf16*>(p));
}

// 8 warps as 2 (M) x 4 (N), each 64 x 32 of the 128 x 128 tile. Requires
// K % 16 == 0, N % 8 == 0 and 16-byte aligned A and Wt (the host checks).
template <int EPI>
__global__ void __launch_bounds__(256, 2)
linear_w8a8_kernel(const int8_t* __restrict__ A, const float* __restrict__ sa, const int8_t* __restrict__ Wt,
                   const float* __restrict__ s, const float* __restrict__ bias, float* __restrict__ C, int M,
                   int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // [STAGES][BM][LDS]
  int8_t* Bs = As + STAGES * A_STAGE;            // [STAGES][BN][LDS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nN = (N + BN - 1) / BN;
  const int bm = (blockIdx.x / nN) * BM, bn = (blockIdx.x % nN) * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  int acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto load_tile = [&](int stage, int k0) {
    int8_t* as = As + stage * A_STAGE;
    int8_t* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 bytes, for A and for Wt
      const int c = tid + i * 256, r = c >> 2, kc = (c & 3) * 16, gk = k0 + kc;
      const bool pa = bm + r < M && gk < K, pb = bn + r < N && gk < K;
      cp_async16(as + r * LDS + kc, pa ? A + (long long)(bm + r) * K + gk : A, pa);
      cp_async16(bs + r * LDS + kc, pb ? Wt + (long long)(bn + r) * K + gk : Wt, pb);
    }
  };

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {  // one commit group per stage, even if empty
    if (st < nk) load_tile(st, st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; stage (kt - 1) is free
    if (kt + STAGES - 1 < nk) load_tile((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const int8_t* as = As + (kt % STAGES) * A_STAGE;
    const int8_t* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(af[i], as + (wm + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 16);
      // bfr[j]: {b0, b1} of n8 tile 2j, then {b0, b1} of n8 tile 2j + 1
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4(bfr[j], bs + (wn + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8_16832(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2], bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: {0, 1} at (lane / 4, 2 * (lane % 4) + {0, 1}), {2, 3} eight rows down
  const int r0 = bm + wm + (lane >> 2), c0 = bn + wn + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + i * 16 + h * 8;
      if (r >= M) continue;
      const float ar = sa[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j * 8;
        if (c >= N) continue;  // N % 8 == 0: c < N implies c + 1 < N
        // _rn intrinsics: each step rounded on its own, never fused into an FMA
        float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2]), ar), s[c]);
        float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2 + 1]), ar), s[c + 1]);
        float2* out = reinterpret_cast<float2*>(C + (long long)r * N + c);
        if (EPI == EPI_RESIDUAL) {
          const float2 x = *out;
          y0 = __fadd_rn(__fadd_rn(x.x, y0), bias[c]);
          y1 = __fadd_rn(__fadd_rn(x.y, y1), bias[c + 1]);
        } else {
          y0 = __fadd_rn(y0, bias[c]);
          y1 = __fadd_rn(y1, bias[c + 1]);
          if (EPI == EPI_RELU) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
        }
        *out = make_float2(y0, y1);
      }
    }
}

template <int EPI>
cudaError_t launch_linear_w8a8(const int8_t* a, const float* sa, const int8_t* wt, const float* s, const float* bias,
                               float* c, int M, int N, int K, cudaStream_t st) {
  static bool ready = false;
  const cudaError_t e = allow_smem(linear_w8a8_kernel<EPI>, LINEAR_W8A8_SMEM, ready);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  linear_w8a8_kernel<EPI><<<(unsigned)blocks, 256, LINEAR_W8A8_SMEM, st>>>(a, sa, wt, s, bias, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q[M, K] int8 and sa[M] fp32 = the row quantization of h[M, K] fp32.
int cse_quantize_rows(const void* h, void* q, void* sa, long long M, int K, void* stream) {
  quantize_rows_kernel<<<(unsigned)((M + 7) / 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<int8_t*>(q), static_cast<float*>(sa), M, K);
  return (int)cudaGetLastError();
}

// c[M, N] fp32 = epilogue(a[M, K] (int8) . wt[N, K]^T (int8) * sa[M] * s[N], bias[N]);
// epilogue 0: y + bias; 1: relu(y + bias); 2: c = (c + y) + bias.
int cse_linear_w8a8(const void* a, const void* sa, const void* wt, const void* s, const void* bias, void* c,
                    int epi, long long M, int N, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t *ap = static_cast<const int8_t*>(a), *wp = static_cast<const int8_t*>(wt);
  const float *sap = static_cast<const float*>(sa), *sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(bias);
  float* cp = static_cast<float*>(c);
  switch (epi) {
    case EPI_BIAS: return (int)launch_linear_w8a8<EPI_BIAS>(ap, sap, wp, sp, bp, cp, (int)M, N, K, st);
    case EPI_RELU: return (int)launch_linear_w8a8<EPI_RELU>(ap, sap, wp, sp, bp, cp, (int)M, N, K, st);
    case EPI_RESIDUAL: return (int)launch_linear_w8a8<EPI_RESIDUAL>(ap, sap, wp, sp, bp, cp, (int)M, N, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
