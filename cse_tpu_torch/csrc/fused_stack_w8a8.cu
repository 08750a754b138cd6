// Hopper (sm_90a) port of cse_tpu/ops/fused_stack.py::_stack_kernel_w8a8
// (:130) with _qdot (:115): the inference stack whose four projections per
// layer run int8 x int8 -> int32 with a per-output-channel weight scale s
// (fused_stack.py::quantize_stacked, :159) and a dynamic scale per activation
// row. The host wrapper is cse_tpu_torch/ops/fused_stack_w8a8.py; the stack's
// attention (bf16 operands, fp32 out) and final LayerNorm are the serving
// kernels of fused_stack.cu. The TPU kernel quantizes each fp32 row in VMEM
// right where _qdot needs it (:149-154); here the two LayerNorms of a layer
// write int8 themselves (c) and the whole FFN is one kernel (d), so of a
// layer's fp32 rows only the attention output goes through device memory to
// be quantized (a).
//
//   (a) quantize_rows_kernel: one warp per fp32 row of K <= 1024 values:
//       sa = max(max |h|, 1e-12) / 127, q = round-half-even(h / sa) with a
//       true division (__fdiv_rn, never __fdividef), written as int8, and sa.
//       Bit-exact against the plain version. Bound by bytes (reads 4 B,
//       writes 1 B per element). The attention output's quantizer.
//   (b) linear_w8a8_kernel: C = A[M, K] . W[K, N] with A int8 row-major and W
//       read K-major (Wt [N, K], each output channel's K bytes contiguous:
//       the layout ops/fused_stack.py::stack_weights keeps, so no call
//       copies it), on Hopper's int8 tensor cores (wgmma s8 x s8 -> s32)
//       with TMA loads and stores, persistent and warp-specialised as
//       fused_stack.cu's bf16 GEMM (its design below). Integer accumulation
//       is exact. The epilogue forms y = float(acc) * sa[row] * s[col] in
//       that order in fp32, then y + b (QKV, fp32 out), relu(y + b) (fp32
//       out) or (r + y) + b into the fp32 residual r (out-proj), the
//       association JAX writes. At M ~ 5e5 rows, K, N <= 1024 the fp32
//       output and residual traffic outweighs the 1,979 TOP/s of int8 work:
//       bound by bytes.
//   (c) layer_norm_quant_kernel: LN (fused_stack.cu's layer_norm_kernel<float>
//       arithmetic, summation order included) and (a)'s quantizer in one
//       pass over D = 256 fp32 rows, the normalised row kept in registers:
//       1284 bytes a row instead of 3332 for LN (fp32 out) then (a). Bound
//       by bytes; its design below.
//   (d) ffn_w8a8_kernel: r = (r + qdot(relu(qdot(hq, W1) + b1), W2)) + b2
//       in place, D = 256, F = 1024, the [M, 1024] hidden never in device
//       memory: the FFN1 tiles are computed twice (the row max first, then
//       the int8 payload into shared memory, FFN2's A operand). (b)'s
//       epilogues and (a)'s quantizer, step for step: the same bits as the
//       three launches it replaces. Bound by its epilogues on the CUDA
//       cores (against 1.5x the int8 work on the tensor cores and 2308
//       bytes a row), so each warpgroup runs an epilogue while its next
//       products are on the tensor cores; its design below.
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

// float(acc) for |acc| <= 2^22 (an int8 product over K <= 256) without a
// conversion instruction (those issue at a quarter of the FP32 rate): the
// integer added into the mantissa of 1.5 x 2^23, then 1.5 x 2^23 taken away,
// both exact.
constexpr float MAGIC = 12582912.0f;  // 1.5 x 2^23: its ulp is 1
constexpr int MAGIC_BITS = 0x4B400000;
__device__ __forceinline__ float small_int_to_float(int acc) {
  return __fsub_rn(__int_as_float(MAGIC_BITS + acc), MAGIC);
}
// no memory access moves across it: bounds how many loads the compiler hoists (and so the registers they hold)
__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }
// (b)'s EPI_RELU on one accumulator, each step rounded on its own:
// relu(float(acc) * ar * s + b), float(acc) by small_int_to_float; lin_epi
// without the ReLU
__device__ __forceinline__ float lin_epi(int acc, float ar, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(small_int_to_float(acc), ar), s), b);
}
__device__ __forceinline__ float relu_epi(int acc, float ar, float s, float b) {
  return fmaxf(lin_epi(acc, ar, s, b), 0.f);
}
// round-half-even(y / s) for |y / s| <= 128 as (a) computes it, rint of the
// correctly rounded quotient (__fdiv_rn), without the division: t = y * rc
// (rc = 1 / s rounded) is y / s within 2^-23 |t|, and the correctly rounded
// quotient within 2^-24 |t| more, so rint(t) (t + 1.5 x 2^23 rounds it, half
// to even) is (a)'s integer unless t lies within 1.8e-7 |t| of a
// half-integer: then `near` is set, and the caller takes the division
// (quant_int; ffn_w8a8_kernel's rare second loop).
__device__ __forceinline__ int quant_fast(float y, float rc, bool& near) {
  const float t = __fmul_rn(y, rc), big = __fadd_rn(t, MAGIC);
  near |= fabsf(fabsf(__fsub_rn(t, __fsub_rn(big, MAGIC))) - 0.5f) <= 2.5e-7f * fabsf(t);
  return __float_as_int(big) - MAGIC_BITS;
}
__device__ __forceinline__ int quant_int(float y, float s, float rc) {
  bool near = false;
  const int q = quant_fast(y, rc, near);
  return near ? __float2int_rn(__fdiv_rn(y, s)) : q;
}

// ---------------------------------------------------------------- (c) LN -> int8
// One warp per row of D = 256 fp32 values, 8 a lane, in a persistent grid
// (SMs x the blocks the occupancy query fits; rows dealt to the warps in
// turn). A row comes in by two 16-byte streamed loads a lane, the warp's
// next row issued before this one is reduced; a 1 KB stage per warp in
// shared memory turns them into the lane-strided order of
// layer_norm_kernel<float> (lane l holds elements l, l + 32, ...), whose sums
// and roundings this repeats expression for expression, so the LN values
// equal its fp32 output bit for bit. (a)'s quantizer runs on those values in
// registers (quant_int: (a)'s integers); the int8 row goes back through the
// stage and out as 8 bytes a lane.
namespace lnq {
constexpr int D = 256, V = D / 32, WARPS = 8, THREADS = WARPS * 32;
}

__global__ void __launch_bounds__(lnq::THREADS)
layer_norm_quant_kernel(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
                        int8_t* __restrict__ q, float* __restrict__ sa, long long M, float eps) {
  using namespace lnq;
  __shared__ __align__(16) float stage[WARPS][D];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage[w];
  float gv[V], bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    gv[j] = g[lane + 32 * j];
    bv[j] = b[lane + 32 * j];
  }
  const long long step = (long long)gridDim.x * WARPS;
  long long row = (long long)blockIdx.x * WARPS + w;
  float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
  if (row < M) {
    const float4* xr = reinterpret_cast<const float4*>(x + row * D);
    a0 = __ldcs(xr + lane);
    a1 = __ldcs(xr + 32 + lane);
  }
  for (; row < M; row += step) {
    reinterpret_cast<float4*>(st)[lane] = a0;
    reinterpret_cast<float4*>(st)[32 + lane] = a1;
    __syncwarp();
    if (row + step < M) {  // the warp's next row, in flight while this one is reduced
      const float4* xr = reinterpret_cast<const float4*>(x + (row + step) * D);
      a0 = __ldcs(xr + lane);
      a1 = __ldcs(xr + 32 + lane);
    }
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = st[lane + 32 * j];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) s += v[j];
    const float mean = warp_sum(s) / D;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - mean;
      var += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(var) / D + eps);
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = (v[j] - mean) * rstd * gv[j] + bv[j];
      m = fmaxf(m, fabsf(v[j]));
    }
    const float sc = __fdiv_rn(fmaxf(warp_max(m), 1e-12f), 127.0f), rc = __frcp_rn(sc);
    __syncwarp();  // every lane has read its values out of the stage
    int8_t* sq = reinterpret_cast<int8_t*>(st);
#pragma unroll
    for (int j = 0; j < V; ++j) sq[lane + 32 * j] = (int8_t)quant_int(v[j], sc, rc);
    __syncwarp();
    reinterpret_cast<uint2*>(q + row * D)[lane] = reinterpret_cast<const uint2*>(sq)[lane];
    if (lane == 0) sa[row] = sc;
    __syncwarp();  // the stage is read out before the next row overwrites it
  }
}

cudaError_t launch_layer_norm_quant(const float* x, const float* g, const float* b, int8_t* q, float* sa, long long M,
                                    float eps, cudaStream_t st) {
  static int per_sm = 0;
  if (!per_sm) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_norm_quant_kernel, lnq::THREADS, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  const long long rows_blocks = (M + lnq::WARPS - 1) / lnq::WARPS, fit = (long long)sm_count() * per_sm;
  const long long blocks = rows_blocks < fit ? rows_blocks : fit;
  layer_norm_quant_kernel<<<(unsigned)blocks, lnq::THREADS, 0, st>>>(x, g, b, q, sa, M, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- (d) the int8 FFN
// FFN1, its ReLU, the hidden's row quantizer and FFN2 with the residual in
// one kernel, at the model's widths (D = 256, F = 1024). Persistent: one
// block of 384 threads per SM walks panels of 128 rows (blockIdx.x, +
// gridDim.x, ...); consumer warpgroup c takes rows 64 c .. 64 c + 63 of each
// panel as its own unit (its hq rows, its hidden, its residual, at its own
// pace), and each row's max is reduced inside one warp (the quad that holds
// the row).
//
// What bounds it: the epilogues on the CUDA cores. Per unit the tensor cores
// run 1.5x the int8 work of the two products (FFN1 twice, below); the CUDA
// cores run the FFN1 dequantise-and-max, the dequantise-and-quantise (some
// 16 instructions an element) and the residual epilogue, more than twice as
// long; the 2308 bytes a row (hq and sa read, r read and written) take less
// than either. A schedule that waits on each tile's products before its
// epilogue adds the two up (PERF.md: products alone 0.39 of 1.24 ms at M =
// 506,016), so this one keeps products in flight behind the epilogues:
//   - warp 0 loads by TMA, in the consumers' order, through one ring of five
//     16 KB slots that both warpgroups read (a slot goes back when all eight
//     consumer warps have released it): per panel hq's two 128-byte
//     k-chunks, then for each of 2 x 8 FFN1 tiles (128 output channels) its
//     two 64-channel halves, each with both k-chunks of W1, then FFN2's two
//     128-column halves in 8 k-chunks of W2 each; each block starts at its
//     own tile and k-chunk (blockIdx.x % 8) and k-chunk order of W1, so that
//     the SMs spread their reads over W rather than all asking L2 for one
//     chunk at once. W2 is prefetched into L2 at the start, and each
//     panel's residual rows (cp.async.bulk.prefetch) as its hq is loaded;
//   - a warpgroup takes its 64 hq rows out of the ring into registers
//     (ldmatrix, 32 a thread) and releases the slots at once: FFN1 reads its
//     A operand from registers for all 16 tiles, which leaves shared memory
//     room for five slots;
//   - FFN1 runs as a pipeline of half tiles (wgmma m64n64k32 s8 over K =
//     256, one commit group each, 32 accumulator registers): a half's
//     epilogue runs while the warpgroup's next half is on the tensor cores,
//     and a half's fill goes back as soon as that half retires. The
//     pipeline drains every two tiles: the compiler follows the groups in
//     flight through straight code only (around a loop it serialises every
//     wgmma), and four or eight tiles of straight code ran slower on the H100;
//   - pass 1 (tiles 0-7): y = relu(float(acc) * sa * s1 + b1), rounded step
//     by step as (b)'s EPI_RELU (float(acc) by small_int_to_float: the
//     conversion instructions issue at a quarter rate), and each row's
//     running max |y|; nothing is stored. Then sa2 = max(rowmax, 1e-12) /
//     127, as (a) takes it;
//   - pass 2 (tiles 8-15): the same tiles again (integer sums are exact, so
//     y repeats pass 1's), each y rounded to int8 as (a) rounds it (a true
//     division only near a rounding tie: quant_int, run only on the column
//     pairs that met one), and stored into the warpgroup's 64 x 1024 int8
//     buffer in shared memory, K-major with TMA's 128-byte swizzle: FFN2's A
//     operand;
//   - FFN2: one 128-column half at a time (64 accumulator registers), a
//     commit group per k-chunk, kept in flight (a k-chunk's fill goes back
//     once the next one is issued and it has retired). The half's residual
//     rows are read into registers before its products, so their latency
//     passes under them; then r = (r + float(acc) * sa2 * s2) + b2 as (b)'s
//     EPI_RESIDUAL, written in 8-byte runs of each row;
//   - s1, b1, s2 and b2 are copied into shared memory once: read from L1 or
//     L2 at each use, their latency bound the epilogues;
//   - setmaxnreg hands the producer warpgroup's registers to the consumers.
// Shared memory: hidden 128 KB + ring 80 KB + vectors 10 KB; one block per
// SM.
namespace ffn {
constexpr int D = 256, F = 1024;
constexpr int BM = 128;                         // rows a panel: a unit of 64 a warpgroup
constexpr int CHUNK = 128 * 128;                // 16 KB: 128 rows (or output channels) x 128 k
constexpr int HALF = 64 * 128;                  // 8 KB: a warpgroup's 64 rows of a chunk
constexpr int KCH = F / 128;                    // FFN1 column tiles = FFN2 k-chunks
constexpr int W_SLOTS = 5;
constexpr int TILES = 2 * KCH;                  // FFN1 tiles a unit: two passes
constexpr int GROUP = 2;                        // FFN1 tiles a stretch of the half-tile pipeline
constexpr int STEPS = KCH;                      // FFN2 steps a 128-column half: one k-chunk each
constexpr int FILLS = 2 + 2 * TILES + 2 * KCH;  // ring fills a panel: hq, W1, W2
constexpr int VEC = 2 * F + 2 * D;              // s1, b1, s2, b2 (fp32)
// shared memory: hidden (2 warpgroups x KCH halves) | ring slots | s1 b1 s2 b2 | barriers
constexpr int OFF_W = 2 * KCH * HALF, OFF_VEC = OFF_W + W_SLOTS * CHUNK, OFF_BAR = OFF_VEC + VEC * 4;
constexpr size_t SMEM = 1024 + OFF_BAR + 8 * 2 * W_SLOTS;
bool smem_ready = false;
}  // namespace ffn

// `bytes` (a multiple of 16, 16-byte aligned) of global memory into L2
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(reinterpret_cast<uint64_t>(p)), "r"(bytes)
               : "memory");
}
// the box of `map` at (c0, c1) into L2
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1)
               : "memory");
}
// the 128 threads of one warpgroup (named barrier id > 0)
__device__ __forceinline__ void warpgroup_sync(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

__global__ void __launch_bounds__(WS_THREADS, 1)
ffn_w8a8_kernel(const __grid_constant__ CUtensorMap tmH, const __grid_constant__ CUtensorMap tmW1,
                const __grid_constant__ CUtensorMap tmW2, const float* __restrict__ sa, const float* __restrict__ s1,
                const float* __restrict__ b1, const float* __restrict__ s2, const float* __restrict__ b2,
                float* __restrict__ r, int M) {
  using namespace ffn;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* A2 = smem;
  unsigned char* Ws = smem + OFF_W;
  float* vec = reinterpret_cast<float*>(smem + OFF_VEC);
  const float *vs1 = vec, *vb1 = vec + F, *vs2 = vec + 2 * F, *vb2 = vec + 2 * F + D;
  const TmaRing<W_SLOTS> ring{reinterpret_cast<uint64_t*>(smem + OFF_BAR)};  // hq, W1 and W2 chunks
  const int units = (M + BM - 1) / BM;  // panels
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the block's turn in W: FFN1 column tiles and FFN2 k-chunks from o on, FFN1's two k-chunks in order p, so
  // that the SMs read different chunks at any time; integer sums and a row max do not depend on the order
  const int o = blockIdx.x % KCH, p = (blockIdx.x / KCH) & 1;
  for (int i = threadIdx.x; i < VEC; i += WS_THREADS)  // the epilogues' vectors, once: every unit reads them
    vec[i] = i < F ? s1[i] : i < 2 * F ? b1[i - F] : i < 2 * F + D ? s2[i - 2 * F] : b2[i - 2 * F - D];
  if (threadIdx.x == 0) {
    ring.init(8);  // one release per consumer warp
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup: warp 0 loads
    ws_producer_regs();
    if (warp == 0 && lane == 0) {
      for (int i = 0; i < 2 * KCH; ++i)  // W2 into L2 now, long before the first FFN2 asks for it
        tma_prefetch_2d(&tmW2, (i % KCH) * 128, (i / KCH) * 128);
      int fi = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const long long row0 = (long long)u * BM;  // the panel's residual rows into L2
        const unsigned bytes = (unsigned)(M - row0 < BM ? M - row0 : BM) * D * 4;
        for (unsigned off = 0; off < bytes; off += 16384)
          prefetch_l2(r + row0 * D + off / 4, bytes - off < 16384u ? bytes - off : 16384u);
        for (int kc = 0; kc < 2; ++kc, ++fi)  // hq's k-chunks in W1's order
          tma_load_2d(Ws + (fi % W_SLOTS) * CHUNK, &tmH, (kc ^ p) * 128, u * BM, ring.fill(fi, CHUNK));
        for (int i = 0; i < 2 * TILES; ++i, ++fi) {  // FFN1 tile i / 2, its 64-column half i % 2: both k-chunks
          uint64_t* bar = ring.fill(fi, CHUNK);
          for (int kc = 0; kc < 2; ++kc)
            tma_load_2d(Ws + (fi % W_SLOTS) * CHUNK + kc * HALF, &tmW1, (kc ^ p) * 128,
                        (((i >> 1) + o) % KCH) * 128 + (i & 1) * 64, bar);
        }
        for (int i = 0; i < 2 * KCH; ++i, ++fi)  // FFN2 column half i / 8, k-chunk (i % 8 + o) % 8
          tma_load_2d(Ws + (fi % W_SLOTS) * CHUNK, &tmW2, ((i % KCH + o) % KCH) * 128, (i / KCH) * 128,
                      ring.fill(fi, CHUNK));
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows 64 c .. 64 c + 63 of each panel
  ws_consumer_regs();
  const int c = (warp >> 2) - 1;
  const int g = lane >> 2, qd = lane & 3;
  const int rl = (warp & 3) * 16 + g;  // the thread's rows among the warpgroup's 64: rl, rl + 8
  unsigned char* A2c = A2 + c * KCH * HALF;

  for (int u = blockIdx.x, fi = 0; u < units; u += gridDim.x, fi += FILLS) {
    const int gr = u * BM + c * 64 + rl;  // the thread's first row of the matrix
    const float ar[2] = {gr < M ? sa[gr] : 0.f, gr + 8 < M ? sa[gr + 8] : 0.f};
    float mx[2] = {0.f, 0.f}, sa2[2] = {0.f, 0.f}, rc[2] = {0.f, 0.f};
    // the unit's hq rows as FFN1's A fragments, k-chunk kc (in W1's order), k32 step s
    unsigned ha[2][4][4];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      ring.wait(fi + kc);
      const int m = lane >> 3, row = c * 64 + (warp & 3) * 16 + (m & 1) * 8 + (lane & 7);
      const unsigned char* h = Ws + ((fi + kc) % W_SLOTS) * CHUNK + row * 128;
#pragma unroll
      for (int s = 0; s < 4; ++s)  // 128-byte swizzle: 16-byte chunk (2 s + m / 2) ^ (row % 8)
        ldmatrix_x4(ha[kc][s], reinterpret_cast<const bf16*>(h + (((2 * s + (m >> 1)) ^ (lane & 7)) << 4)));
    }
    __syncwarp();
    if (lane == 0) {
      ring.release(fi);
      ring.release(fi + 1);
    }

    // FFN1 tile t's products for its 64-column half hb into acc (32 registers), one commit group, from the
    // half's own fill (its 64 output channels, both k-chunks)
    auto issue = [&](int(&acc)[32], int t, int hb) {
      const int w = fi + 2 + 2 * t + hb;
      ring.wait(w);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64k32_s8_rs(acc, ha[kc][s], desc_k_major(Ws + (w % W_SLOTS) * CHUNK + kc * HALF, s), kc | s);
      wgmma_commit();
    };
    // the epilogue of tile t's half hb (column pairs j = 8 hb .. 8 hb + 7; acc[4 (j % 8) + e]). Pass 1 (t < 8):
    // each row's running max |y|. Pass 2: y as int8 into the hidden buffer, the half's integers by quant_fast
    // before its stores, and quant_int only in a second loop, on the column pairs where the first met a near
    // tie (a branch, or a store before a load, inside the first loop would serialise it)
    auto epilogue = [&](int(&acc)[32], int t, int hb, bool pass2) {
      const int ct = (t + o) % KCH;
      const float* s1t = vs1 + ct * 128 + 64 * hb + 2 * qd;
      const float* b1t = vb1 + ct * 128 + 64 * hb + 2 * qd;
      if (!pass2) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 sc = *reinterpret_cast<const float2*>(s1t + 8 * j);
          const float2 bb = *reinterpret_cast<const float2*>(b1t + 8 * j);
#pragma unroll
          for (int h = 0; h < 2; ++h)  // max relu(y) = max(0, max y): mx starts at 0
            mx[h] = fmaxf(mx[h], fmaxf(lin_epi(acc[4 * j + 2 * h], ar[h], sc.x, bb.x),
                                       lin_epi(acc[4 * j + 2 * h + 1], ar[h], sc.y, bb.y)));
        }
        return;
      }
      unsigned char* dst = A2c + ct * HALF;
      auto put = [&](int j, unsigned pk) {  // K-major, 128-byte swizzle: 16-byte chunk (col / 16) ^ (row % 8)
        const int col = 64 * hb + 8 * j + 2 * qd;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rl + 8 * h;
          *reinterpret_cast<unsigned short*>(dst + row * 128 + (((col >> 4) ^ (row & 7)) << 4) + (col & 15)) =
              (unsigned short)(pk >> (16 * h));
        }
      };
      unsigned nears = 0u, pk[8];  // bit j: column pair j met a near tie; pk[j]: its int8, row rl low, rl + 8 high
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(s1t + 8 * j);
        const float2 bb = *reinterpret_cast<const float2*>(b1t + 8 * j);
        bool near = false;
        pk[j] = 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q0 = quant_fast(relu_epi(acc[4 * j + 2 * h], ar[h], sc.x, bb.x), rc[h], near);
          const int q1 = quant_fast(relu_epi(acc[4 * j + 2 * h + 1], ar[h], sc.y, bb.y), rc[h], near);
          pk[j] |= ((unsigned)(q0 & 0xff) | ((unsigned)(q1 & 0xff) << 8)) << (16 * h);
        }
        if (near) nears |= 1u << j;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) put(j, pk[j]);
      // rare: those pairs' integers again, each by quant_int, one pair at a time, its four accumulators picked
      // out by selects (one call site of the division's slow path, not 32: those would hold the fast loop's
      // registers hostage); the accumulators made opaque first, so nothing of the fast loop is kept for it
      fence_regs(acc);
      compiler_fence();
#pragma unroll 1
      for (unsigned m = nears; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        int a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = acc[e];
#pragma unroll
          for (int jj = 1; jj < 8; ++jj) a[e] = j == jj ? acc[4 * jj + e] : a[e];
        }
        const float2 sc = *reinterpret_cast<const float2*>(s1t + 8 * j);
        const float2 bb = *reinterpret_cast<const float2*>(b1t + 8 * j);
        unsigned q = 0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q0 = quant_int(relu_epi(a[2 * h], ar[h], sc.x, bb.x), sa2[h], rc[h]);
          const int q1 = quant_int(relu_epi(a[2 * h + 1], ar[h], sc.y, bb.y), sa2[h], rc[h]);
          q |= ((unsigned)(q0 & 0xff) | ((unsigned)(q1 & 0xff) << 8)) << (16 * h);
        }
        put(j, q);
      }
    };
    // the pipeline, GROUP tiles at a time: each half's epilogue runs while the warpgroup's next half is on
    // the tensor cores, and every group has retired by the end of the stretch
    auto release = [&](int t, int hb) {  // half hb of tile t has retired: its fill goes back
      if (lane == 0) ring.release(fi + 2 + 2 * t + hb);
    };
    int acc_a[32], acc_b[32];
    auto tile_group = [&](int t, bool pass2) {  // tiles t .. t + GROUP - 1
      issue(acc_a, t, 0);
      issue(acc_b, t, 1);
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        wgmma_wait1();
        fence_regs(acc_a);
        release(t + i, 0);
        epilogue(acc_a, t + i, 0, pass2);
        if (i + 1 < GROUP) {
          issue(acc_a, t + i + 1, 0);
          wgmma_wait1();
        } else {
          wgmma_wait0();
        }
        fence_regs(acc_b);
        release(t + i, 1);
        epilogue(acc_b, t + i, 1, pass2);
        if (i + 1 < GROUP) issue(acc_b, t + i + 1, 1);
      }
    };
#pragma unroll 1
    for (int t = 0; t < KCH; t += GROUP) tile_group(t, false);  // pass 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // pass 1 done: the quad that shares a row holds all its columns
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      sa2[h] = __fdiv_rn(fmaxf(mx[h], 1e-12f), 127.0f);
      rc[h] = __frcp_rn(sa2[h]);
    }
#pragma unroll 1
    for (int t = KCH; t < TILES; t += GROUP) tile_group(t, true);  // pass 2
    fence_proxy_async();  // the hidden's generic stores -> visible to wgmma
    warpgroup_sync(1 + c);

    // FFN2, one 128-column half at a time (64 accumulator registers, not 128)
#pragma unroll 1
    for (int nh = 0; nh < 2; ++nh) {
      // the half's residual, read now: in flight while the products run
      float2 x[2][16];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          x[h][j] = gr + 8 * h < M ? *reinterpret_cast<const float2*>(r + (long long)(gr + 8 * h) * D + nh * 128 +
                                                                      8 * j + 2 * qd)
                                   : make_float2(0.f, 0.f);
      int acc[64];
      const int w2 = fi + 2 + 2 * TILES + nh * KCH;
#pragma unroll 1
      for (int st = 0; st < STEPS; ++st) {
        const int w = w2 + st;
        ring.wait(w);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k32_s8(acc, desc_k_major(A2c + (st + o) % KCH * HALF, kk),
                              desc_k_major(Ws + (w % W_SLOTS) * CHUNK, kk), st | kk);
        wgmma_commit();
        if (st > 0) {  // the k-chunk before has retired: its fill goes back
          wgmma_wait1();
          if (lane == 0) ring.release(w - 1);
        }
      }
      wgmma_wait0();
      fence_regs(acc);
      if (lane == 0) ring.release(w2 + STEPS - 1);
      // (b)'s EPI_RESIDUAL: r = (r + y) + b2, y = float(acc) * sa2 * s2
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (gr + 8 * h >= M) continue;
        float* rr = r + (long long)(gr + 8 * h) * D + nh * 128 + 2 * qd;
        const float *s2h = vs2 + nh * 128 + 2 * qd, *b2h = vb2 + nh * 128 + 2 * qd;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int e = 4 * j + 2 * h;
          const float2 sc = *reinterpret_cast<const float2*>(s2h + 8 * j);
          const float2 bb = *reinterpret_cast<const float2*>(b2h + 8 * j);
          const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[e]), sa2[h]), sc.x);
          const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[e + 1]), sa2[h]), sc.y);
          __stcs(reinterpret_cast<float2*>(rr + 8 * j), make_float2(__fadd_rn(__fadd_rn(x[h][j].x, y0), bb.x),
                                                                     __fadd_rn(__fadd_rn(x[h][j].y, y1), bb.y)));
        }
      }
    }
  }
}

cudaError_t launch_ffn_w8a8(const int8_t* hq, const float* sa, const int8_t* w1t, const float* s1, const float* b1,
                            const int8_t* w2t, const float* s2, const float* b2, float* r, int M, cudaStream_t st) {
  using namespace ffn;
  if (M < 1) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(ffn_w8a8_kernel, SMEM, smem_ready);
  if (e != cudaSuccess) return e;
  const CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap th, t1, t2;
  if (!tensor_map(&th, U8, hq, 1, D, M, 128, BM) || !tensor_map(&t1, U8, w1t, 1, D, F, 128, 64) ||
      !tensor_map(&t2, U8, w2t, 1, F, D, 128, 128))
    return cudaErrorInvalidValue;
  const int blocks = min((M + BM - 1) / BM, sm_count());
  ffn_w8a8_kernel<<<blocks, WS_THREADS, SMEM, st>>>(th, t1, t2, sa, s1, b1, s2, b2, r, M);
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

// q[M, D] int8 and sa[M] fp32 = the row quantization of LN(x[M, D]) (scale g,
// bias b, eps), the LN being cse_layer_norm's fp32 output. Needs D == 256
// and a 16-byte aligned x.
int cse_layer_norm_quant(const void* x, const void* g, const void* b, void* q, void* sa, long long M, int D, float eps,
                         void* stream) {
  if (D != lnq::D || M < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_layer_norm_quant(static_cast<const float*>(x), static_cast<const float*>(g),
                                      static_cast<const float*>(b), static_cast<int8_t*>(q), static_cast<float*>(sa),
                                      M, eps, static_cast<cudaStream_t>(stream));
}

// r[M, D] = (r + qdot(q, w2t) * s2) + b2 with q, sa2 the row quantization of
// h = relu(hq[M, D] . w1t[F, D]^T * sa * s1 + b1): FFN1 as cse_linear_w8a8's
// epilogue 1, cse_quantize_rows, FFN2 as epilogue 2, in one launch. Needs
// D == 256, F == 1024 and 16-byte aligned hq, w1t, w2t and r.
int cse_ffn_w8a8(const void* hq, const void* sa, const void* w1t, const void* s1, const void* b1, const void* w2t,
                 const void* s2, const void* b2, void* r, long long M, int D, int F, void* stream) {
  if (D != ffn::D || F != ffn::F) return (int)cudaErrorInvalidValue;
  return (int)launch_ffn_w8a8(static_cast<const int8_t*>(hq), static_cast<const float*>(sa),
                              static_cast<const int8_t*>(w1t), static_cast<const float*>(s1),
                              static_cast<const float*>(b1), static_cast<const int8_t*>(w2t),
                              static_cast<const float*>(s2), static_cast<const float*>(b2), static_cast<float*>(r),
                              (int)M, static_cast<cudaStream_t>(stream));
}

// info[3] of a kernel: {registers a thread, local-memory bytes a thread,
// resident blocks per SM}; kernel 0: layer_norm_quant_kernel, kernel 1: ffn_w8a8_kernel.
int cse_w8a8_kernel_info(int kernel, int* info) {
  if (kernel == 0) return (int)kernel_info((const void*)layer_norm_quant_kernel, lnq::THREADS, 0, info);
  if (kernel != 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(ffn_w8a8_kernel, ffn::SMEM, ffn::smem_ready);
  return (int)(e != cudaSuccess ? e : kernel_info((const void*)ffn_w8a8_kernel, WS_THREADS, ffn::SMEM, info));
}

}  // extern "C"
