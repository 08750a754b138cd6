// Hopper (sm_90a) port of cse_tpu/ops/fused_stack.py::_stack_kernel.
//
// The TPU kernel pushes a block of sequences through all 8 pre-LN layers of
// a TransformerStack in one program, with the stack's 12.6 MB of bf16
// weights and the fp32 residual resident in 100 MB of VMEM. An SM has at
// most 227 KB of shared memory, so this port splits the stack into three
// kernels that the host wrapper (cse_tpu_torch/ops/fused_stack.py) launches
// 8 x (LN, QKV, attention, out-proj, LN, FFN1, FFN2) + final LN = 57 times
// per stack call, keeping the residual stream fp32 in device memory:
//
// The training path (fused_train.cu, ops/fused_train.py) runs its forward
// and replay on these kernels too: the attention optionally writes each
// row's max and 1/z, and the GEMM has a fourth epilogue for the backward's
// dX product through the ReLU.
//
//   (a) layer_norm_kernel: one warp per row, fp32 stats (eps passed in),
//       writes LN(x) in the compute dtype (or the output dtype for the
//       final LN). Bound by bytes: reads 4 B and writes 2-4 B per element.
//   (b) linear_*_kernel: C = A[M,K] . W[K,N] with cd operands and fp32
//       accumulation, epilogue +bias (fp32 out), +bias+relu (cd out), or
//       +bias added into the fp32 residual in place (and EPI_RELU_GRAD,
//       below). bf16 runs on Hopper's wgmma with TMA loads and stores in a
//       persistent, warp-specialised kernel (its design below); fp32 runs on
//       CUDA-core FMAs (64x64 tiles), never TF32. At M ~ 5e5 rows and
//       K, N <= 1024 the bytes bound it: the fp32 qkv write and the fp32
//       residual read-modify-write outweigh the operations.
//   (c) attention_*_kernel: masked MHSA of one (sequence, head) per block
//       over the packed fp32 qkv, head width HD a template argument (4, 8,
//       16, 32, 64; hd 4 in common.cuh's Head<8>-shaped tiles). The TPU kernel's arithmetic: q*scale, k and v rounded to
//       cd, fp32 scores, m = max over the L keys, p = exp(s - m), z summed
//       from the unrounded p, cd(p).cd(v) in fp32, divided by z after PV.
//       bf16, routed by L alone:
//         L <= 256, attention_strip_bf16_kernel: the block stages q, k and v
//           of all its rows as bf16 in shared memory once (common.cuh's
//           stage_qkv_bf16, shared with kernel_parts.cu); a warp owns 16
//           queries and keeps their scores against every key in registers
//           (s[NB][2][4], NB = 8 or 16 blocks of 16 keys): one product, one
//           exponential per score (p = 2^(s log2(e) - m log2(e)) in one FMA
//           and one ex2), the row max and sum by quad shuffles, one PV.
//         L > 256, attention_bf16_kernel: K and V in tiles of 256 keys and
//           two passes (the row max; then p, z and PV), the scores
//           recomputed in the second rather than stored.
//       fp32 (the parity path) runs CUDA-core FMAs with expf. At the
//       serving shapes the fp32 qkv read (bytes) bounds it.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- (a) LN
template <typename TO>
__global__ void __launch_bounds__(256)
layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, TO* __restrict__ out, long long M,
                  int D, float eps) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += xr[i];
  const float mean = warp_sum(s) / D;
  float v = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = xr[i] - mean;
    v += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / D + eps);
  TO* orow = out + row * D;
  for (int i = lane; i < D; i += 32) orow[i] = from_f<TO>((xr[i] - mean) * rstd * g[i] + b[i]);
}

// ---------------------------------------------------------------- (b) GEMM
// EPI_RELU_GRAD (the training backward's dX GEMM through the FFN's ReLU):
// C (cd) = where(mask > 0, acc + bias, 0) with mask the forward's relu output
// (cd), and the fp32 column sums of that value over each 128-row M tile
// written to colsum[tile][N] -- the bias gradient's per-tile partials.
enum Epilogue { EPI_BIAS = 0, EPI_RELU = 1, EPI_RESIDUAL = 2, EPI_RELU_GRAD = 3 };

// bf16 x bf16 -> fp32 on Hopper's tensor cores: wgmma + TMA, persistent and
// warp-specialised. At the main path's shapes (M ~ 5e5 rows, K, N <= 1024)
// the bytes bound it (the fp32 outputs and the residual's read-modify-write
// outweigh the operations ~2.4x), so the design keeps device memory busy:
//   - one block per SM walks 128-row panels of A (blockIdx.x, + gridDim.x,
//     ...), and within a panel every 128-column tile of the output;
//   - warp 0 loads by TMA: for K <= 256 the panel's A (128 x K) stays in
//     shared memory across all the panel's N tiles (each A row is read from
//     device memory once); beyond, A's 64-wide k-chunks stream through the
//     same four slots, and two N tiles share each pass over K (NG = 2, two
//     sets of accumulators), so A is still read once per panel. W's chunks
//     (64 x 128) stream through a five-slot ring; W is small and is read
//     from L2. Out-of-range rows and columns of a box are zero-filled, so
//     ragged M, N and K need no code;
//   - two consumer warpgroups run wgmma m64n128k16 on 64 rows each (A
//     K-major, W N-major through the transpose bit, both 128-byte swizzled
//     as TMA writes them) and release each slot as its products retire;
//   - the epilogue adds bias (and the residual, or applies the ReLU or the
//     ReLU-gradient mask) from registers into a swizzled tile in shared
//     memory, which warp 1 writes out by TMA in whole lines while the
//     consumers run the next tile; for EPI_RESIDUAL and EPI_RELU_GRAD warp 1
//     first loads the residual or mask tile into that buffer by TMA, ahead
//     of the epilogue, as soon as the previous tile's store has read it;
//   - setmaxnreg hands the producer warpgroup's registers to the consumers.
// Numerics, as linear_plain's: bf16 products summed in fp32, then
// (acc + bias) [+ residual], rounded once to the output type.
namespace gemm {
constexpr int BM = 128, BN = 128, BK = 64;  // output tile; k-chunk (64 bf16 = one 128-byte swizzle row)
constexpr int SLOTS = 4;                     // A chunk slots
constexpr int W_SLOTS = 5;                   // W chunk slots (5 beat 4 by 1-4%, PERF.md)
constexpr int A_CHUNK = BM * BK * 2;         // 16 KB: 128 rows x 64 k
constexpr int W_CHUNK = 2 * SW_BOX;          // 16 KB: 64 k rows x 128 columns, two 64-column boxes
constexpr int STAGE = BM * BN * 4;           // 64 KB: the epilogue tile (fp32; bf16 uses half)
// shared memory: A slots | W slots | epilogue tile | column-sum scratch | barriers, after 1 KB alignment
constexpr int OFF_W = SLOTS * A_CHUNK, OFF_STAGE = OFF_W + W_SLOTS * W_CHUNK, OFF_RED = OFF_STAGE + STAGE;
constexpr int OFF_BAR = OFF_RED + 8 * BN * 4;
constexpr size_t SMEM = 1024 + OFF_BAR + 8 * (2 * SLOTS + 2 * W_SLOTS + 2);
}  // namespace gemm

template <int EPI, int NG>
__global__ void __launch_bounds__(WS_THREADS, 1)
linear_bf16_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
                   const __grid_constant__ CUtensorMap tmC, const __grid_constant__ CUtensorMap tmX,
                   const float* __restrict__ bias, float* __restrict__ colsum, int M, int N, int K) {
  using namespace gemm;
  constexpr bool F32_OUT = EPI == EPI_BIAS || EPI == EPI_RESIDUAL;
  constexpr bool LOADS_X = EPI == EPI_RESIDUAL || EPI == EPI_RELU_GRAD;  // tmX: the residual (= C) or the mask
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* As = smem;
  unsigned char* Ws = smem + OFF_W;
  unsigned char* Cs = smem + OFF_STAGE;
  float* red = reinterpret_cast<float*>(smem + OFF_RED);  // [8 warps][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  const TmaRing<SLOTS> aring{bars};                // A chunks
  const TmaRing<W_SLOTS> wring{bars + 2 * SLOTS};  // W chunks
  uint64_t *sready = bars + 2 * (SLOTS + W_SLOTS), *sfull = sready + 1;

  const int panels = (M + BM - 1) / BM, NT = (N + BN - 1) / BN, KC = (K + BK - 1) / BK;
  const bool resident = KC <= SLOTS;  // A's panel stays for all its N tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    aring.init(8);  // one release per consumer warp
    wring.init(8);
    mbar_init(sready, 1);
    mbar_init(sfull, 8);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup: warp 0 loads, warp 1 stores
    ws_producer_regs();
    if (warp == 0 && lane == 0) {
      int ai = 0, wi = 0;
      for (int p = blockIdx.x; p < panels; p += gridDim.x)
        for (int n0 = 0; n0 < NT; n0 += NG) {
          const bool fresh = !resident || n0 == 0;
          for (int kc = 0; kc < KC; ++kc) {
            if (fresh) {
              uint64_t* full = aring.fill(ai, A_CHUNK);
              tma_load_2d(As + (ai % SLOTS) * A_CHUNK, &tmA, kc * BK, p * BM, full);
              ++ai;
            }
            for (int gi = 0; gi < NG; ++gi, ++wi) {
              unsigned char* w = Ws + (wi % W_SLOTS) * W_CHUNK;
              uint64_t* full = wring.fill(wi, W_CHUNK);
              tma_load_2d(w, &tmW, (n0 + gi) * BN, kc * BK, full);
              tma_load_2d(w + SW_BOX, &tmW, (n0 + gi) * BN + 64, kc * BK, full);
            }
          }
        }
    } else if (warp == 1 && lane == 0) {
      // tile i's store, then (ahead of tile i + 1's epilogue) its residual or mask
      constexpr int NBOX = F32_OUT ? 4 : 2, BOXC = F32_OUT ? 32 : 64;
      auto store = [&](int p, int nt) {
        for (int b = 0; b < NBOX; ++b)
          if (nt * BN + b * BOXC < N) tma_store_2d(&tmC, nt * BN + b * BOXC, p * BM, Cs + b * 16384);
        tma_store_commit();
      };
      int i = 0, pp = 0, pnt = 0;
      for (int p = blockIdx.x; p < panels; p += gridDim.x)
        for (int nt = 0; nt < NT; ++nt, ++i) {
          if (i > 0) {
            mbar_wait(sfull, (i - 1) & 1);
            store(pp, pnt);
            tma_store_wait_read();
          }
          if (LOADS_X) {
            mbar_expect_tx(sready, NBOX * 16384);
            for (int b = 0; b < NBOX; ++b) tma_load_2d(Cs + b * 16384, &tmX, nt * BN + b * BOXC, p * BM, sready);
          } else {
            mbar_arrive(sready);
          }
          pp = p;
          pnt = nt;
        }
      if (i > 0) {
        mbar_wait(sfull, (i - 1) & 1);
        store(pp, pnt);
        tma_store_wait_all();
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows 64 c .. 64 c + 63 of each tile
  ws_consumer_regs();
  const int c = (warp >> 2) - 1, cw = warp - 4;  // warpgroup 0 / 1; consumer warp 0 .. 7
  const int g = lane >> 2, q = lane & 3;
  const int row0 = c * 64 + (warp & 3) * 16 + g;  // the thread's rows in the tile: row0, row0 + 8
  int ai = 0, wi = 0, t = 0, pbase = 0;
  float acc[NG][64];
  for (int p = blockIdx.x; p < panels; p += gridDim.x)
    for (int n0 = 0; n0 < NT; n0 += NG) {
      const bool fresh = !resident || n0 == 0, last = !resident || n0 + NG >= NT;
      if (fresh) pbase = ai;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[gi][i] = 0.f;
      for (int kc = 0; kc < KC; ++kc) {
        const int aidx = pbase + kc;
        if (fresh) aring.wait(aidx);
        const unsigned char* a = As + (aidx % SLOTS) * A_CHUNK + c * (64 * 128);
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) wring.wait(wi + gi);
        wgmma_fence();
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) wgmma_chunk64<0>(acc[gi], a, Ws + ((wi + gi) % W_SLOTS) * W_CHUNK);
        wgmma_commit();
        wgmma_wait0();  // the slots go back as soon as the chunk's products retire
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) fence_regs(acc[gi]);
        if (lane == 0) {
#pragma unroll
          for (int gi = 0; gi < NG; ++gi) wring.release(wi + gi);
          if (last) aring.release(aidx);
        }
        wi += NG;
      }
      if (fresh) ai += KC;

#pragma unroll
      for (int gi = 0; gi < NG; ++gi, ++t) {
        const int nt = n0 + gi;
        // epilogue: (acc + bias) [+ residual | relu | mask] into the staged tile
        mbar_wait(sready, t & 1);
        float cs[16][2];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * q, gc = nt * BN + col;
          const float b0 = gc < N ? bias[gc] : 0.f, b1 = gc + 1 < N ? bias[gc + 1] : 0.f;
          cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 8 * h;
            float v0 = acc[gi][4 * j + 2 * h] + b0, v1 = acc[gi][4 * j + 2 * h + 1] + b1;
            if (F32_OUT) {
              float2* pc = reinterpret_cast<float2*>(Cs + stage_off_f32(r, col));
              if (EPI == EPI_RESIDUAL) {
                const float2 x = *pc;
                v0 += x.x;
                v1 += x.y;
              }
              *pc = make_float2(v0, v1);
            } else {
              __nv_bfloat162* pc = reinterpret_cast<__nv_bfloat162*>(Cs + stage_off_bf16(r, col));
              if (EPI == EPI_RELU) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              } else {  // EPI_RELU_GRAD: the mask is 0 past M and N, so those add nothing below
                const float2 m = __bfloat1622float2(*pc);
                v0 = m.x > 0.f ? v0 : 0.f;
                v1 = m.y > 0.f ? v1 : 0.f;
                cs[j][0] += v0;
                cs[j][1] += v1;
              }
              *pc = __floats2bfloat162_rn(v0, v1);
            }
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(sfull);
        if (EPI == EPI_RELU_GRAD) {
          // column sums over the tile's 128 rows: the thread's 2 rows, the 8
          // lanes of a column (lane / 4), then the 8 consumer warps in order
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = cs[j][e];
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
              if (g == 0) red[cw * BN + 8 * j + 2 * q + e] = v;
            }
          asm volatile("bar.sync 1, 256;\n" ::: "memory");
          const int ct = threadIdx.x - 128;
          if (ct < BN && nt * BN + ct < N) {
            float v = red[ct];
#pragma unroll
            for (int w = 1; w < 8; ++w) v += red[w * BN + ct];
            colsum[(long long)p * N + nt * BN + ct] = v;
          }
          asm volatile("bar.sync 1, 256;\n" ::: "memory");
        }
      }
    }
}

// acc + bias -> C | relu(acc + bias) -> C | added into the residual C, all fp32
template <int EPI>
__device__ __forceinline__ float epilogue_f32(float acc, int r, int c, int N,
                                              const float* __restrict__ bias, float* C,
                                              const float* __restrict__ mask) {
  const float v = acc + bias[c];
  const long long idx = (long long)r * N + c;
  float* p = C + idx;
  const float o = EPI == EPI_BIAS ? v : EPI == EPI_RELU ? fmaxf(v, 0.f)
                  : EPI == EPI_RELU_GRAD ? (mask[idx] > 0.f ? v : 0.f) : *p + v;
  *p = o;
  return o;
}

// fp32 x fp32 -> fp32 on CUDA-core FMAs (the parity path; no TF32).
// 64 x 64 tile, 256 threads with 4 x 4 outputs each.
template <int EPI>
__global__ void __launch_bounds__(256)
linear_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                  const float* __restrict__ bias, void* C, int M, int N, int K,
                  const float* __restrict__ mask, float* __restrict__ colsum) {
  __shared__ float As[16][64 + 4];  // transposed: As[k][m]
  __shared__ float Bs[16][64];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nN = (N + 63) / 64;
  const int bm = (blockIdx.x / nN) * 64, bn = (blockIdx.x % nN) * 64;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, r = e >> 4, k = e & 15;
      const int gr = bm + r, gk = k0 + k;
      As[k][r] = (gr < M && gk < K) ? A[(long long)gr * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, k = e >> 6, c = e & 63;
      const int gk = k0 + k, gc = bn + c;
      Bs[k][c] = (gk < K && gc < N) ? W[(long long)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = bm + ty * 4 + i, c = bn + tx * 4 + j;
      if (r < M && c < N) cs[j] += epilogue_f32<EPI>(acc[i][j], r, c, N, bias, static_cast<float*>(C), mask);
    }
  if (EPI == EPI_RELU_GRAD) {  // column sums of the block's 64 rows, in row-group order
    __shared__ float red[16][64];
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][tx * 4 + j] = cs[j];
    __syncthreads();
    if (tid < 64 && bn + tid < N) {
      float t = 0.f;
      for (int i = 0; i < 16; ++i) t += red[i][tid];
      colsum[(long long)(blockIdx.x / nN) * N + bn + tid] = t;
    }
  }
}

// ---------------------------------------------------------------- (c) attention
// Every kernel: block b handles sequence b / H, head b % H of qkv [G*L, 3*D]
// fp32 (q | k | v, head h at columns h*HD of each third) and writes
// out [G*L, D] in cd (or fp32). With ``stats`` (training's replay; serving
// passes null) each row's max m and 1/z go to stats[0][row][h] and
// stats[1][row][h] ([2, G*L, H] fp32) for the backward to recompute p.
constexpr int KT = 256;                 // keys per shared-memory tile (L > 256)
constexpr int STRIP_MAX_L = 256;        // the bf16 route: one pass up to here
constexpr int STRIP_WARPS = 4;          // warps a strip block (4 beat 8, PERF.md)
constexpr int ATT_WARPS = 4;            // warps a two-pass block

// fp32 (the parity path): CUDA-core FMAs, one warp per query row, lane j
// scores key c + j and owns output columns j, j + 32.
constexpr int QT32 = 128;               // query rows per tile
constexpr int ROWS32 = QT32 / 8;        // query rows per warp per tile
template <int HD>
constexpr size_t att_f32_smem() { return sizeof(float) * (KT * (HD + 1) + KT * HD + QT32 * HD); }

template <int HD>
__global__ void __launch_bounds__(256)
attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int L, int H,
                     float scale, float* __restrict__ stats) {
  constexpr int LK = HD + 1, NC = (HD + 31) / 32;  // 33-word K rows at HD 32: conflict-free
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [KT][LK]
  float* Vs = Ks + KT * LK;                    // [KT][HD]
  float* Qs = Vs + KT * HD;                    // [QT32][HD]

  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * HD, D3 = 3 * D;
  const float* base = qkv + (long long)g * L * D3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkt = (L + KT - 1) / KT;

  auto load_kv = [&](int k0) {
    for (int e = tid; e < KT * HD; e += blockDim.x) {
      const int r = e / HD, d = e % HD, key = k0 + r;
      const float* row = base + (long long)key * D3 + h * HD + d;
      Ks[r * LK + d] = key < L ? row[D] : 0.f;
      Vs[r * HD + d] = key < L ? row[2 * D] : 0.f;
    }
  };
  auto score = [&](const float* q, int key) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(q[d], Ks[key * LK + d], s);
    return s;
  };
  if (nkt == 1) load_kv(0);

  for (int q0 = 0; q0 < L; q0 += QT32) {
    __syncthreads();  // every warp is done with the previous query tile
    for (int e = tid; e < QT32 * HD; e += blockDim.x) {
      const int q = q0 + e / HD;
      Qs[e] = q < L ? base[(long long)q * D3 + h * HD + e % HD] * scale : 0.f;
    }
    __syncthreads();

    float m[ROWS32], z[ROWS32], acc[ROWS32][NC];
#pragma unroll
    for (int r = 0; r < ROWS32; ++r) {
      m[r] = __int_as_float(0xff800000);  // -inf
      z[r] = 0.f;
#pragma unroll
      for (int u = 0; u < NC; ++u) acc[r][u] = 0.f;
    }
    // pass 1: the row max over all keys
    for (int kt = 0; kt < nkt; ++kt) {
      if (nkt > 1) {
        __syncthreads();
        load_kv(kt * KT);
        __syncthreads();
      }
      const int nk = min(KT, L - kt * KT);
#pragma unroll
      for (int r = 0; r < ROWS32; ++r) {
        const int qr = warp + r * 8;
        if (q0 + qr >= L) continue;  // warp-uniform
        float q[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) q[d] = Qs[qr * HD + d];
        for (int c = 0; c < nk; c += 32) {
          const float s = score(q, c + lane);
          if (c + lane < nk) m[r] = fmaxf(m[r], s);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS32; ++r) m[r] = warp_max(m[r]);

    // pass 2: p = exp(s - m), z = sum p, acc = sum p * v
    for (int kt = 0; kt < nkt; ++kt) {
      if (nkt > 1) {
        __syncthreads();
        load_kv(kt * KT);
        __syncthreads();
      }
      const int nk = min(KT, L - kt * KT);
#pragma unroll
      for (int r = 0; r < ROWS32; ++r) {
        const int qr = warp + r * 8;
        if (q0 + qr >= L) continue;
        float q[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) q[d] = Qs[qr * HD + d];
        for (int c = 0; c < nk; c += 32) {
          const float s = score(q, c + lane);
          const float p = c + lane < nk ? expf(s - m[r]) : 0.f;
          z[r] += p;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
            for (int u = 0; u < NC; ++u)
              if (lane + 32 * u < HD) acc[r][u] = fmaf(pj, Vs[(c + j) * HD + lane + 32 * u], acc[r][u]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS32; ++r) {
      const int qr = warp + r * 8;
      const float zr = warp_sum(z[r]);
      if (q0 + qr >= L) continue;
      const long long row = (long long)g * L + q0 + qr;
#pragma unroll
      for (int u = 0; u < NC; ++u)
        if (lane + 32 * u < HD) out[row * D + h * HD + lane + 32 * u] = acc[r][u] / zr;
      if (stats && lane == 0) {
        const long long MH = (long long)(gridDim.x / H) * L * H;
        stats[row * H + h] = m[r];
        stats[MH + row * H + h] = 1.f / zr;
      }
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// rows ra, ra + 8 of a warp's output o[HD / 8][4] / z into out (row stride D),
// and with stats each row's max and 1/z
template <int HD, typename TO>
__device__ __forceinline__ void store_strip(TO* out, float* stats, const float (&o)[Head<HD>::NT][4],
                                            const float (&m)[2], const float (&z)[2], long long row_a, int ra,
                                            int L, int D, int H, int h, long long MH, int lane) {
#pragma unroll
  for (int j = 0; j < Head<HD>::NT; ++j) {
    if (!in_head<HD>(j * 8, lane)) continue;  // hd 4: the tile's columns 4 .. 7
    const int d = h * HD + j * 8 + (lane & 3) * 2;
    if (ra < L) store_pair(out + row_a * D + d, o[j][0] / z[0], o[j][1] / z[0]);
    if (ra + 8 < L) store_pair(out + (row_a + 8) * D + d, o[j][2] / z[1], o[j][3] / z[1]);
  }
  if (stats && (lane & 3) == 0) {
    if (ra < L) {
      stats[row_a * H + h] = m[0];
      stats[MH + row_a * H + h] = 1.f / z[0];
    }
    if (ra + 8 < L) {
      stats[(row_a + 8) * H + h] = m[1];
      stats[MH + (row_a + 8) * H + h] = 1.f / z[1];
    }
  }
}

// bf16, L > 256: score and PV products on the tensor cores (mma.sync
// m16n8k16, fp32 accumulate), with the scores kept in registers. 4 warps;
// each warp owns 16 query rows at a time, with q*scale rounded to bf16 in A
// fragments. K and V of up to KT keys sit in shared memory in bf16. Keys go
// 16 at a time: pass 1 takes the row max over all keys; pass 2 recomputes
// the scores, forms p = exp(s - m) (z summed from the unrounded p), and feeds
// bf16(p) straight from the score fragments into the PV product as its A
// operand; p is rounded relative to the row's global max. The output is
// bf16, or fp32 (TO = float: the w8a8 stack, whose attention output is
// quantized again from fp32).
template <int HD>
constexpr size_t att_passes_smem(int kt_rows) { return sizeof(bf16) * 2 * kt_rows * Head<HD>::LD; }

template <typename TO, int HD>
__global__ void __launch_bounds__(ATT_WARPS * 32, 4)
attention_bf16_kernel(const float* __restrict__ qkv, TO* __restrict__ out, int L, int H,
                      float scale, int kt_rows, float* __restrict__ stats) {
  constexpr int LD = Head<HD>::LD, NT = Head<HD>::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kt_rows][LD]
  bf16* Vs = Ks + kt_rows * LD;              // [kt_rows][LD]

  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * HD, D3 = 3 * D;
  const float* base = qkv + (long long)g * L * D3 + h * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkt = (L + KT - 1) / KT;
  const float NEG_INF = __int_as_float(0xff800000);
  const long long MH = (long long)(gridDim.x / H) * L * H;

  // keys k0 .. k0 + kt_rows - 1 of K (and V) into shared memory, bf16, zero past L
  auto load_kv = [&](int k0, bool with_v) {
    for (int e = tid; e < kt_rows * (HD / 4); e += ATT_WARPS * 32) {
      const int r = e / (HD / 4), c = (e % (HD / 4)) * 4, key = k0 + r;
      float4 k = make_float4(0.f, 0.f, 0.f, 0.f), v = k;
      if (key < L) {
        const float* row = base + (long long)key * D3 + c;
        k = *reinterpret_cast<const float4*>(row + D);
        if (with_v) v = *reinterpret_cast<const float4*>(row + 2 * D);
      }
      *reinterpret_cast<uint2*>(Ks + r * LD + c) = make_uint2(pack_bf16(k.x, k.y), pack_bf16(k.z, k.w));
      if (with_v)
        *reinterpret_cast<uint2*>(Vs + r * LD + c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  };

  if (nkt == 1) {
    load_kv(0, true);
    __syncthreads();
  }
  for (int q0 = 0; q0 < L; q0 += ATT_WARPS * 16) {
    // this warp's rows: ra (fragment elements 0, 1) and ra + 8 (elements 2, 3)
    const int ra = q0 + warp * 16 + (lane >> 2);
    const bool active = q0 + warp * 16 < L;  // warp-uniform
    unsigned qa[Head<HD>::KS][4];  // q * scale rounded to bf16, as the TPU kernel does before the score dot
    afrag_f32<HD>(qa, base, D3, ra, L, scale, lane);

    // pass 1: the row max over all keys
    float m[2] = {NEG_INF, NEG_INF};
    for (int kt = 0; kt < nkt; ++kt) {
      if (nkt > 1) {
        __syncthreads();
        load_kv(kt * KT, false);
        __syncthreads();
      }
      const int nk = min(KT, L - kt * KT);
      if (!active) continue;
      for (int kb = 0; kb < nk; kb += 16) {
        float s[2][4];
        prod16<HD>(s, qa, Ks, kb, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kb + j * 8 + (lane & 3) * 2 + e < nk) {
              m[0] = fmaxf(m[0], s[j][e]);
              m[1] = fmaxf(m[1], s[j][2 + e]);
            }
      }
    }
    // the four lanes of a quad share a row
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      m[0] = fmaxf(m[0], __shfl_xor_sync(FULL, m[0], x));
      m[1] = fmaxf(m[1], __shfl_xor_sync(FULL, m[1], x));
    }

    // pass 2: p, z and O = bf16(p) . V
    float z[2] = {0.f, 0.f}, o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      if (nkt > 1) {
        __syncthreads();
        load_kv(kt * KT, true);
        __syncthreads();
      }
      const int nk = min(KT, L - kt * KT);
      if (!active) continue;
      for (int kb = 0; kb < nk; kb += 16) {
        float s[2][4];
        prod16<HD>(s, qa, Ks, kb, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = kb + j * 8 + (lane & 3) * 2 + e < nk;
            s[j][e] = valid ? expf(s[j][e] - m[0]) : 0.f;
            s[j][2 + e] = valid ? expf(s[j][2 + e] - m[1]) : 0.f;
            z[0] += s[j][e];
            z[1] += s[j][2 + e];
          }
        // the score fragments of keys kb .. kb + 15 are the A fragment of this k-step
        const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        mma_rows<HD>(o, pa, Vs, kb, lane);
      }
    }
    if (!active) continue;
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      z[0] += __shfl_xor_sync(FULL, z[0], x);
      z[1] += __shfl_xor_sync(FULL, z[1], x);
    }
    store_strip<HD>(out, stats, o, m, z, (long long)g * L + ra, ra, L, D, H, h, MH, lane);
  }
}

// bf16, L <= 256: one pass. Block: one (sequence, head), its q * scale, k
// and v staged in shared memory as bf16 once; warp w takes the 16-query
// strips w, w + STRIP_WARPS, ... The scores of key block cb sit in s[cb];
// every phase runs over all NB blocks without a branch (K and V are zero
// past L, those scores -inf), so the compiler interleaves the blocks' work,
// and the row max and sum keep four partials per row.
template <int HD, int NB>
constexpr size_t att_strip_smem() { return sizeof(bf16) * 3 * NB * 16 * Head<HD>::LD; }

// Blocks an SM: at NB = 8 and HD <= 32 the strip fits 128 registers and
// four blocks run (inter 0.599 against 0.650 ms at three); at NB = 16 a
// third block would cap a thread at 168 registers and spill (PERF.md).
template <int HD, int NB>
__host__ __device__ constexpr int att_strip_min_blocks() { return NB == 8 && HD <= 32 ? 4 : 1; }

template <typename TO, int HD, int NB>
__global__ void __launch_bounds__(32 * STRIP_WARPS, att_strip_min_blocks<HD, NB>())
attention_strip_bf16_kernel(const float* __restrict__ qkv, TO* __restrict__ out, int L, int H, float scale,
                            float* __restrict__ stats) {
  constexpr int LD = Head<HD>::LD, NT = Head<HD>::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [NB * 16][LD]
  bf16* Vs = Ks + NB * 16 * LD;              // [NB * 16][LD]
  bf16* Qs = Vs + NB * 16 * LD;              // [NB * 16][LD]: bf16(q * scale)
  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long MH = (long long)(gridDim.x / H) * L * H;
  const float LOG2E = 1.4426950408889634f;

  stage_qkv_bf16<HD, NB * 16, 4>(qkv + (long long)g * L * 3 * D + h * HD, D, L, scale, Qs, Ks, Vs);
  __syncthreads();

  for (int q0 = warp * 16; q0 < L; q0 += STRIP_WARPS * 16) {
    unsigned qa[Head<HD>::KS][4];
    afrag_smem<HD>(qa, Qs, q0, lane);
    float s[NB][2][4];
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) prod16<HD>(s[cb], qa, Ks, cb * 16, lane);
    strip_mask<NB>(s, L, lane, __int_as_float(0xff800000));
    float m[2], z[2];
    strip_row_max<NB>(s, m);
    strip_exp<NB, true>(s, m, LOG2E, z);  // p in place of s, z from the unrounded p
    // O = bf16(p) . V, divided by z after the product
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      const float (&p)[2][4] = s[cb];
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      mma_rows<HD>(o, pa, Vs, cb * 16, lane);
    }
    const int ra = q0 + (lane >> 2);
    store_strip<HD>(out, stats, o, m, z, (long long)g * L + ra, ra, L, D, H, h, MH, lane);
  }
}

// One launch of the bf16 attention at L: the kernel (its shared-memory
// limit raised once), key blocks held in registers (0: two passes), threads,
// K and V rows in shared memory and dynamic shared bytes a block.
struct AttPlan {
  const void* fn;
  int nb, threads, kt_rows;
  size_t smem;
  cudaError_t err;
};

template <typename TO, int HD, int NB>
AttPlan att_strip_plan() {
  static const cudaError_t e = cudaFuncSetAttribute(attention_strip_bf16_kernel<TO, HD, NB>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    (int)att_strip_smem<HD, NB>());
  return {reinterpret_cast<const void*>(attention_strip_bf16_kernel<TO, HD, NB>), NB, 32 * STRIP_WARPS, NB * 16,
          att_strip_smem<HD, NB>(), e};
}

template <typename TO, int HD>
AttPlan plan_attention_bf16(int L) {
  if (L <= 128) return att_strip_plan<TO, HD, 8>();
  if (L <= STRIP_MAX_L) return att_strip_plan<TO, HD, 16>();
  static const cudaError_t e = cudaFuncSetAttribute(attention_bf16_kernel<TO, HD>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    (int)att_passes_smem<HD>(KT));
  const int kt_rows = (min(L, KT) + 15) / 16 * 16;  // K and V rows, whole 16-key steps
  return {reinterpret_cast<const void*>(attention_bf16_kernel<TO, HD>), 0, ATT_WARPS * 32, kt_rows,
          att_passes_smem<HD>(kt_rows), e};
}

template <typename TO, int HD>
cudaError_t launch_attention_bf16(const float* qkv, TO* out, int G, int L, int H, float scale, float* stats,
                                  cudaStream_t st) {
  const AttPlan p = plan_attention_bf16<TO, HD>(L);
  if (p.err != cudaSuccess) return p.err;
  const unsigned blocks = (unsigned)(G * H);
  if (p.nb == 8)
    attention_strip_bf16_kernel<TO, HD, 8><<<blocks, p.threads, p.smem, st>>>(qkv, out, L, H, scale, stats);
  else if (p.nb == 16)
    attention_strip_bf16_kernel<TO, HD, 16><<<blocks, p.threads, p.smem, st>>>(qkv, out, L, H, scale, stats);
  else
    attention_bf16_kernel<TO, HD><<<blocks, p.threads, p.smem, st>>>(qkv, out, L, H, scale, p.kt_rows, stats);
  return cudaGetLastError();
}

// mode 0: fp32 operands and output; 1: bf16 operands and output; 2: bf16
// operands, fp32 output
template <int HD>
cudaError_t launch_attention(int mode, const float* qkv, void* out, int G, int L, int H, float scale,
                             float* stats, cudaStream_t st) {
  if (L < 1) return cudaErrorInvalidValue;
  if (mode == 1) return launch_attention_bf16<bf16, HD>(qkv, static_cast<bf16*>(out), G, L, H, scale, stats, st);
  if (mode == 2) return launch_attention_bf16<float, HD>(qkv, static_cast<float*>(out), G, L, H, scale, stats, st);
  if (mode != 0) return cudaErrorInvalidValue;
  static bool ready = false;
  const cudaError_t e = allow_smem(attention_f32_kernel<HD>, att_f32_smem<HD>(), ready);
  if (e != cudaSuccess) return e;
  attention_f32_kernel<HD><<<G * H, 256, att_f32_smem<HD>(), st>>>(qkv, static_cast<float*>(out), L, H, scale, stats);
  return cudaGetLastError();
}

template <int HD>
cudaError_t attention_info(int mode, int L, int* info) {
  if (L < 1 || (mode != 1 && mode != 2)) return cudaErrorInvalidValue;
  const AttPlan p = mode == 1 ? plan_attention_bf16<bf16, HD>(L) : plan_attention_bf16<float, HD>(L);
  if (p.err != cudaSuccess) return p.err;
  info[0] = p.nb;
  info[1] = p.threads;
  info[2] = L;  // query rows a block: the whole sequence
  info[3] = (int)p.smem;
  return kernel_info(p.fn, p.threads, p.smem, info + 4);
}

// ---------------------------------------------------------------- host side of the GEMM
template <int EPI>
cudaError_t launch_linear(int bf, const void* a, const void* w, const float* bias, void* c,
                          int M, int N, int K, cudaStream_t st, const void* mask = nullptr,
                          float* colsum = nullptr) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (bf) {
    using namespace gemm;
    if (K % 8 || N % 8) return cudaErrorInvalidValue;  // TMA: 16-byte row strides
    static bool ready1 = false, ready2 = false;
    cudaError_t e = allow_smem(linear_bf16_kernel<EPI, 1>, SMEM, ready1);
    if (e == cudaSuccess) e = allow_smem(linear_bf16_kernel<EPI, 2>, SMEM, ready2);
    if (e != cudaSuccess) return e;
    constexpr bool F32_OUT = EPI == EPI_BIAS || EPI == EPI_RESIDUAL;
    const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    CUtensorMap ta, tw, tc, tx;
    bool ok = tensor_map(&ta, BF, a, 2, K, M, 64, BM) && tensor_map(&tw, BF, w, 2, N, K, 64, BK) &&
              (F32_OUT ? tensor_map(&tc, F32, c, 4, N, M, 32, BM) : tensor_map(&tc, BF, c, 2, N, M, 64, BM));
    if (EPI == EPI_RELU_GRAD) ok = ok && tensor_map(&tx, BF, mask, 2, N, M, 64, BM);
    else tx = tc;
    if (!ok) return cudaErrorInvalidValue;
    const int blocks = min((M + BM - 1) / BM, sm_count()), NT = (N + BN - 1) / BN;
    // A streamed (K > 256): two N tiles a pass over K, so each A chunk is read once for both
    if ((K + BK - 1) / BK > SLOTS && NT % 2 == 0)
      linear_bf16_kernel<EPI, 2><<<blocks, WS_THREADS, SMEM, st>>>(ta, tw, tc, tx, bias, colsum, M, N, K);
    else
      linear_bf16_kernel<EPI, 1><<<blocks, WS_THREADS, SMEM, st>>>(ta, tw, tc, tx, bias, colsum, M, N, K);
  } else {
    const long long blocks = (long long)((M + 63) / 64) * ((N + 63) / 64);
    linear_f32_kernel<EPI><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), bias, c, M, N, K,
        static_cast<const float*>(mask), colsum);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[M, D] = LN(x[M, D]) * g + b; out is bf16 when out_bf16, else fp32.
int cse_layer_norm(const void* x, const void* g, const void* b, void* out, int out_bf16,
                   long long M, int D, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((M + 7) / 8);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  if (out_bf16)
    layer_norm_kernel<bf16><<<blocks, 256, 0, st>>>(xf, gf, bf, static_cast<bf16*>(out), M, D, eps);
  else
    layer_norm_kernel<float><<<blocks, 256, 0, st>>>(xf, gf, bf, static_cast<float*>(out), M, D, eps);
  return (int)cudaGetLastError();
}

// c = epilogue(a[M, K] . w[K, N] + bias[N]); a and w bf16 when bf16 else
// fp32. epilogue 0: c fp32 = acc + bias; 1: c (a's dtype) = relu(acc + bias);
// 2: c fp32 += acc + bias. bf16 needs K % 8 == N % 8 == 0 and 16-byte
// aligned a, w and c.
int cse_linear(const void* a, const void* w, const void* bias, void* c, int bf16_operands,
               int epi, long long M, int N, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  switch (epi) {
    case EPI_BIAS: return (int)launch_linear<EPI_BIAS>(bf16_operands, a, w, bf, c, (int)M, N, K, st);
    case EPI_RELU: return (int)launch_linear<EPI_RELU>(bf16_operands, a, w, bf, c, (int)M, N, K, st);
    case EPI_RESIDUAL: return (int)launch_linear<EPI_RESIDUAL>(bf16_operands, a, w, bf, c, (int)M, N, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[G*L, H*hd] = masked MHSA of qkv[G*L, 3*H*hd], hd in {4, 8, 16, 32, 64};
// mode: see launch_attention (0: fp32, 1: bf16, 2: bf16 operands with an
// fp32 out); stats (null, or [2, G*L, H] fp32) receives each row's max and 1/z.
int cse_attention(const void* qkv, void* out, int mode, int G, int L, int H, int hd,
                  float scale, void* stats, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  float* sm = static_cast<float*>(stats);
  return by_head_width(HeadWidths{}, hd, [&](auto w) {
    return launch_attention<decltype(w)::value>(mode, q, out, G, L, H, scale, sm, st);
  });
}

// info[7] of the bf16 attention cse_attention launches for (mode 1 or 2, L,
// hd), in cse_flash_fwd_info's order: key blocks held in registers (0: two
// passes), threads, query rows a block, dynamic shared bytes, registers a
// thread, local-memory bytes a thread, resident blocks per SM.
int cse_attention_info(int mode, int L, int hd, int* info) {
  return by_head_width(HeadWidths{}, hd, [&](auto w) { return attention_info<decltype(w)::value>(mode, L, info); });
}

// Training's dX GEMM through the FFN's ReLU: out (a's dtype) =
// where(mask > 0, a[M, K] . w[K, N] + bias, 0); colsum[N] (fp32) = the column
// sums of that value, reduced in a fixed order from per-tile partials
// (partials: ceil(M / 128) rows for bf16, ceil(M / 64) for fp32, times N).
int cse_linear_relu_grad(const void* a, const void* w, const void* bias, const void* mask, void* out,
                         void* partials, void* colsum, int bf16_operands, long long M, int N, int K,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  cudaError_t e = launch_linear<EPI_RELU_GRAD>(bf16_operands, a, w, static_cast<const float*>(bias), out,
                                               (int)M, N, K, st, mask, part);
  if (e != cudaSuccess) return (int)e;
  const int rows = (int)((M + (bf16_operands ? gemm::BM : 64) - 1) / (bf16_operands ? gemm::BM : 64));
  return (int)launch_sum_rows(part, static_cast<float*>(colsum), rows, N, st);
}

}  // extern "C"
