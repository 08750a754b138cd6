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
//       read K-major (Wt [N, K], each output channel's K bytes contiguous:
//       the layout ops/fused_stack.py::stack_weights keeps, so no call
//       copies it), on Hopper's int8 tensor cores (wgmma s8 x s8 -> s32)
//       with TMA loads and stores, persistent and warp-specialised as
//       fused_stack.cu's bf16 GEMM (its design below). Integer accumulation
//       is exact. The epilogue forms y = float(acc) * sa[row] * s[col] in
//       that order in fp32, then y + b (QKV, fp32 out), relu(y + b) (FFN1,
//       fp32 out: it is quantized again) or (r + y) + b into the fp32
//       residual r (out-proj, FFN2), the association JAX writes. At M ~ 5e5
//       rows, K, N <= 1024 the fp32 output and residual traffic outweighs the
//       1,979 TOP/s of int8 work: bound by bytes.
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
// int8 x int8 -> int32 on Hopper's tensor cores: wgmma + TMA, persistent and
// warp-specialised, on common.cuh's machinery (TMA ring, K-major
// descriptors, setmaxnreg hand-over, swizzled epilogue tile). At the main
// path's shapes the bytes bound it (the fp32 outputs and the residual's
// read-modify-write are ~86% of them), so the design keeps device memory
// busy:
//   - the work units are the output's 128 x 128 tiles (for K 1024, pairs of
//     them side by side, NG = 2), in (panel of 128 rows, N) order, dealt to
//     one block per SM in turn (unit blockIdx.x, + gridDim.x, ...): the
//     blocks end within one unit of each other, and at any time they write
//     neighbouring tiles, whole rows of the output together;
//   - warp 0 loads by TMA in 128-byte k-chunks (128 int8, one swizzle row):
//     each unit's A panel (128 x K) through a two-slot ring (the blocks that
//     share a panel read it at about the same time, so it comes from device
//     memory once and from L2 after), and Wt's chunks (128 columns x 128 k)
//     through a four-slot ring from L2. With NG = 2 both tiles of a unit
//     share each A chunk. Out-of-range rows and columns of a box are
//     zero-filled, so ragged M, N and K need no code;
//   - two consumer warpgroups run wgmma m64n128k32 s8 on 64 rows each (both
//     operands K-major, 128-byte swizzled as TMA writes them) and release
//     each slot as its products retire;
//   - the epilogue writes into one of two swizzled fp32 tiles in shared
//     memory, which warp 1 writes out by TMA while the consumers run the
//     next tile and fill the other one; for EPI_RESIDUAL warp 1 first loads
//     the residual tile into that buffer by TMA, as soon as the store that
//     used it two tiles before has read it. The tile goes out in boxes of
//     16 rows x 32 columns, a slab of 16 rows at a time, so that each row's
//     512 bytes reach device memory together, with the L2 told to evict
//     them first (on the H100 faster than boxes of 128 rows, PERF.md);
//   - setmaxnreg hands the producer warpgroup's registers to the consumers.
namespace w8 {
constexpr int BM = 128, BN = 128, BK = 128;  // output tile; k-chunk in bytes (= int8 values)
constexpr int SLOTS = 2;                      // A chunk slots
constexpr int W_SLOTS = 4;                    // Wt chunk slots
constexpr int BUFS = 2;                       // epilogue tiles
constexpr int CHUNK = BM * BK;                // 16 KB: 128 rows x 128 k (A), or 128 columns x 128 k (Wt)
constexpr int STAGE = BM * BN * 4;            // 64 KB: one fp32 epilogue tile
constexpr int CR = 16;                        // rows of an epilogue box: [16 rows][32 columns]
// shared memory: A slots | Wt slots | epilogue tiles | barriers, after 1 KB alignment
constexpr int OFF_W = SLOTS * CHUNK, OFF_STAGE = OFF_W + W_SLOTS * CHUNK, OFF_BAR = OFF_STAGE + BUFS * STAGE;
constexpr size_t SMEM = 1024 + OFF_BAR + 8 * (2 * SLOTS + 2 * W_SLOTS + 2 * BUFS);
}  // namespace w8

template <int EPI, int NG>
__global__ void __launch_bounds__(WS_THREADS, 1)
linear_w8a8_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
                   const __grid_constant__ CUtensorMap tmC, const float* __restrict__ sa,
                   const float* __restrict__ s, const float* __restrict__ bias, int M, int N, int K) {
  using namespace w8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* As = smem;
  unsigned char* Ws = smem + OFF_W;
  unsigned char* Cs = smem + OFF_STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  const TmaRing<SLOTS> aring{bars};                // A chunks
  const TmaRing<W_SLOTS> wring{bars + 2 * SLOTS};  // Wt chunks
  // epilogue tile b: sready[b] completes when it may be written (and holds the residual),
  // sfull[b] when the consumers have written it
  uint64_t *sready = bars + 2 * (SLOTS + W_SLOTS), *sfull = sready + BUFS;

  const int NT = (N + BN - 1) / BN, KC = (K + BK - 1) / BK, NU = NT / NG;  // NU units a panel
  const int units = (M + BM - 1) / BM * NU;
  // unit u of the output: panel u / NU, N tiles (u % NU) NG .. + NG - 1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    aring.init(8);  // one release per consumer warp
    wring.init(8);
    for (int b = 0; b < BUFS; ++b) {
      mbar_init(&sready[b], 1);
      mbar_init(&sfull[b], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup: warp 0 loads, warp 1 stores
    ws_producer_regs();
    if (warp == 0 && lane == 0) {
      int ai = 0, wi = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x)
        for (int kc = 0; kc < KC; ++kc, ++ai) {
          tma_load_2d(As + (ai % SLOTS) * CHUNK, &tmA, kc * BK, u / NU * BM, aring.fill(ai, CHUNK));
          for (int gi = 0; gi < NG; ++gi, ++wi)
            tma_load_2d(Ws + (wi % W_SLOTS) * CHUNK, &tmW, kc * BK, ((u % NU) * NG + gi) * BN,
                        wring.fill(wi, CHUNK));
        }
    } else if (warp == 1 && lane == 0) {
      // the block's tile i (of unit blockIdx.x + (i / NG) gridDim.x) in the consumers' order, in
      // epilogue tile i % 2
      const int T = (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * NG;
      auto tile = [&](int i, int& p, int& nt) {
        const int u = blockIdx.x + i / NG * gridDim.x;
        p = u / NU;
        nt = (u % NU) * NG + i % NG;
      };
      const uint64_t pol = l2_evict_first();  // the outputs are not read again here
      auto ready = [&](int i) {  // tile i may be written: load its residual, or just say so
        uint64_t* bar = &sready[i & 1];
        if (EPI == EPI_RESIDUAL) {
          int p, nt;
          tile(i, p, nt);
          const int boxes = min(4, (N - nt * BN + 31) / 32);  // 32-column boxes that start inside N
          mbar_expect_tx(bar, boxes * 16384);
          for (int r = 0; r < BM; r += CR)
            for (int b = 0; b < boxes; ++b)
              tma_load_2d(Cs + (i & 1) * STAGE + b * 16384 + r * 128, &tmC, nt * BN + b * 32, p * BM + r, bar);
        } else {
          mbar_arrive(bar);
        }
      };
      for (int i = 0; i < T && i < BUFS; ++i) ready(i);
      for (int i = 0; i < T; ++i) {
        int p, nt;
        tile(i, p, nt);
        mbar_wait(&sfull[i & 1], (i >> 1) & 1);
        for (int r = 0; r < BM; r += CR)  // a slab of rows at a time
          for (int b = 0; b < 4; ++b)
            if (nt * BN + b * 32 < N)
              tma_store_2d_hint(&tmC, nt * BN + b * 32, p * BM + r, Cs + (i & 1) * STAGE + b * 16384 + r * 128, pol);
        tma_store_commit();
        if (i + BUFS < T) {
          tma_store_wait_read();  // tile i's buffer has been read out
          ready(i + BUFS);
        }
      }
      tma_store_wait_all();
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows 64 c .. 64 c + 63 of each tile
  ws_consumer_regs();
  const int c = (warp >> 2) - 1;  // warpgroup 0 / 1
  const int g = lane >> 2, q = lane & 3;
  const int row0 = c * 64 + (warp & 3) * 16 + g;  // the thread's rows in the tile: row0, row0 + 8
  int ai = 0, wi = 0, t = 0;
  int acc[NG][64];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int p = u / NU, n0 = (u % NU) * NG;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[gi][i] = 0;
    for (int kc = 0; kc < KC; ++kc, ++ai) {
      aring.wait(ai);
      const unsigned char* a = As + (ai % SLOTS) * CHUNK + c * (64 * 128);
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) wring.wait(wi + gi);
      wgmma_fence();
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const unsigned char* w = Ws + ((wi + gi) % W_SLOTS) * CHUNK;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k32_s8(acc[gi], desc_k_major(a, kk), desc_k_major(w, kk), 1);
      }
      wgmma_commit();
      wgmma_wait0();  // the slots go back as soon as the chunk's products retire
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) fence_regs(acc[gi]);
      if (lane == 0) {
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) wring.release(wi + gi);
        aring.release(ai);
      }
      wi += NG;
    }

    const int r0 = p * BM + row0;
    const float ar[2] = {r0 < M ? sa[r0] : 0.f, r0 + 8 < M ? sa[r0 + 8] : 0.f};
#pragma unroll
    for (int gi = 0; gi < NG; ++gi, ++t) {
      const int nt = n0 + gi;
      unsigned char* buf = Cs + (t & 1) * STAGE;
      mbar_wait(&sready[t & 1], (t >> 1) & 1);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * q, gc = nt * BN + col;  // N % 8 == 0: gc < N implies gc + 1 < N
        const float s0 = gc < N ? s[gc] : 0.f, s1 = gc < N ? s[gc + 1] : 0.f;
        const float b0 = gc < N ? bias[gc] : 0.f, b1 = gc < N ? bias[gc + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // _rn intrinsics: each step rounded on its own, never fused into an FMA
          float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[gi][4 * j + 2 * h]), ar[h]), s0);
          float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[gi][4 * j + 2 * h + 1]), ar[h]), s1);
          float2* pc = reinterpret_cast<float2*>(buf + stage_off_f32(row0 + 8 * h, col));
          if (EPI == EPI_RESIDUAL) {
            const float2 x = *pc;
            y0 = __fadd_rn(__fadd_rn(x.x, y0), b0);
            y1 = __fadd_rn(__fadd_rn(x.y, y1), b1);
          } else {
            y0 = __fadd_rn(y0, b0);
            y1 = __fadd_rn(y1, b1);
            if (EPI == EPI_RELU) {
              y0 = fmaxf(y0, 0.f);
              y1 = fmaxf(y1, 0.f);
            }
          }
          *pc = make_float2(y0, y1);
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&sfull[t & 1]);
    }
  }
}

template <int EPI>
cudaError_t launch_linear_w8a8(const int8_t* a, const float* sa, const int8_t* wt, const float* s, const float* bias,
                               float* c, int M, int N, int K, cudaStream_t st) {
  using namespace w8;
  if (M < 1 || N < 1 || K < 1 || K % 16 || N % 8) return cudaErrorInvalidValue;  // TMA: 16-byte row strides
  static bool ready1 = false, ready2 = false;
  cudaError_t e = allow_smem(linear_w8a8_kernel<EPI, 1>, SMEM, ready1);
  if (e == cudaSuccess) e = allow_smem(linear_w8a8_kernel<EPI, 2>, SMEM, ready2);
  if (e != cudaSuccess) return e;
  const CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8, F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap ta, tw, tc;
  if (!tensor_map(&ta, U8, a, 1, K, M, BK, BM) || !tensor_map(&tw, U8, wt, 1, K, N, BK, BN) ||
      !tensor_map(&tc, F32, c, 4, N, M, 32, CR))
    return cudaErrorInvalidValue;
  const int NT = (N + BN - 1) / BN;
  // A streamed (K > 256): two N tiles a pass over K, so each A chunk is read once for both
  const int NG = (K + BK - 1) / BK > SLOTS && NT % 2 == 0 ? 2 : 1;
  const int blocks = min((M + BM - 1) / BM * (NT / NG), sm_count());
  if (NG == 2)
    linear_w8a8_kernel<EPI, 2><<<blocks, WS_THREADS, SMEM, st>>>(ta, tw, tc, sa, s, bias, M, N, K);
  else
    linear_w8a8_kernel<EPI, 1><<<blocks, WS_THREADS, SMEM, st>>>(ta, tw, tc, sa, s, bias, M, N, K);
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
// epilogue 0: y + bias; 1: relu(y + bias); 2: c = (c + y) + bias. Needs K % 16
// == 0, N % 8 == 0 and 16-byte aligned a, wt and c.
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
