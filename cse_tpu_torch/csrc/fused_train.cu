// Hopper (sm_90a) port of the backward of cse_tpu/ops/fused_train.py:
// _bwd_kernel (:168). The forward (_fwd_kernel, :157) and the backward's
// replay of it run on fused_stack.cu's LayerNorm, GEMM and attention kernels
// (the attention writing each row's max and 1/z for this file's kernels);
// the host wrapper is cse_tpu_torch/ops/fused_train.py.
//
// The TPU kernel replays a chunk of layers in VMEM and accumulates the
// weight gradients with += into constant-index output blocks zeroed at grid
// step 0: that relies on the TPU's sequential grid. Here blocks run in any
// order, so every sum across blocks goes through per-block fp32 partials and
// common.cuh's sum_rows_kernel, which adds them in a fixed order: the
// gradients are the same on every run, with no atomics.
//
//   (a) wgrad_*_kernel: P[s] = A[slab s]^T . dY[slab s], the weight gradient
//       A^T dY reduced over M ~ 5e5 rows, split into slabs of rows; sum_rows
//       adds the slabs. bf16 runs on wgmma with TMA loads, a persistent grid
//       over (tile, slab) units (its design below); fp32 on CUDA-core FMAs,
//       ~528 blocks of 64 x 64 tiles. Bound by bytes at the main path's
//       shapes (2 (K + N) bytes a row against 2 K N flops).
//   (b) layer_norm_bwd_kernel: a persistent grid of warps, each taking
//       rows in a fixed order with the next row's loads in flight; recomputes
//       xhat and 1/std from the fp32 LN input, forms dx = inv*(dxhat -
//       mean(dxhat) - xhat*mean(dxhat*xhat)), adds it to the residual
//       gradient (g_out = g_in + dx, fp32 and/or cd) and writes per-block
//       partials of dscale, dbias and the column sums of g_in and g_out (the
//       two residual-branch bias gradients). Bound by bytes (its design below).
//   (c) bf16 at L <= 256, attention_bwd_strip_bf16_kernel: one block per
//       (sequence, head), one pass, delta kept in the block (its design
//       below). Beyond, and for fp32, attention_bwd_dq_*_kernel and
//       attention_bwd_dkdv_*_kernel: one block
//       per (sequence, head, tile of 64 rows). The dq kernel walks the keys
//       twice: delta = rowsum(dp * p) * invz first (written out), then
//       ds = p*(dp - delta)*invz and dq = scale * cd(ds) . cd(k). The dk/dv
//       kernel walks the queries once per key tile with the transposed
//       products: dv = cd(p)^T . cd(do*invz), dk = cd(ds)^T . cd(scale*q).
//       p = exp(s - m) is recomputed from the forward's row max m; every
//       rounding is that of the TPU kernel. bf16 runs the five products on
//       the tensor cores with the [16 x 16] score, p, dp and ds tiles in
//       registers; fp32 on CUDA-core FMAs. Both write cd(dqkv) and per-tile
//       column partials of the fp32 dq | dk | dv (the qkv bias gradient).
//       Head width HD in {4, 8, 16, 32, 64} (a template argument; common.cuh's
//       fragments zero the columns of a k-step past the head). Bound by bytes at head width 32
//       (fp32 qkv and dattn in, cd dqkv out).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- (a) weight gradient
// bf16: P[s][K][N] (fp32) = A[slab s]^T . dY[slab s] on Hopper's tensor
// cores, the GEMM's machinery (common.cuh: TMA ring, MN-major descriptors,
// setmaxnreg; fused_stack.cu's linear_bf16_kernel runs on the same). At the
// main path's shapes (M ~ 5e5 rows, K, N in 256 .. 1024) the bytes bound it:
// 2 (K + N) bytes a row read against 2 K N flops. The design:
//   - persistent and warp-specialised: one block of WS_THREADS per SM walks
//     work units (output tile, slab of rows): unit u is tile u % tiles of
//     slab u / tiles, units blockIdx.x, + gridDim.x, ..., so the tiles of a
//     slab run side by side and its A and dY rows come from device memory
//     once, the other tiles reading them from L2;
//   - an output tile is 128 rows of dW (K) by 128 NG columns (N): NG = 2 for
//     N > 128 (each consumer warpgroup 64 x 256, 128 accumulators a thread),
//     which halves the dY re-reads of 128 x 128 tiles;
//   - warp 0 keeps TMA loads of 64-row chunks of A (two 64-column boxes) and
//     dY (2 NG boxes) in flight through a four-stage ring; out-of-range rows
//     and columns land as zeros, so ragged K, N and the last slab need no
//     code (a slab is a multiple of 64 rows);
//   - wgmma's M is the weight's K, its k the row index m: both operands are
//     MN-major in shared memory and ride the transpose bits; consumer
//     warpgroup c takes dW rows 64 c .. 64 c + 63 of the tile, and keeps one
//     chunk's products in flight while the previous chunk's stage goes back;
//   - each unit writes its fp32 partial to partials[slab] from registers;
//     sum_rows_kernel adds the slabs in a fixed order.
namespace wg {
constexpr int BT = 128;                // dW rows (K) a tile
constexpr int BR = 64;                 // rows m of A and dY a chunk: wgmma's k
constexpr int A_CHUNK = 2 * SW_BOX;    // 16 KB: 64 rows x 128 columns of A
constexpr int B_GROUP = 2 * SW_BOX;    // 16 KB: 64 rows x 128 columns of dY
template <int NG>
__host__ __device__ constexpr int stage_bytes() { return A_CHUNK + NG * B_GROUP; }
template <int NG>
__host__ __device__ constexpr int stages() { return 196608 / stage_bytes<NG>(); }  // a 192 KB ring
template <int NG>
constexpr size_t smem() { return 1024 + stages<NG>() * stage_bytes<NG>() + 16 * stages<NG>(); }
}  // namespace wg

template <int NG>
__global__ void __launch_bounds__(WS_THREADS, 1)
wgrad_bf16_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                  float* __restrict__ P, int M, int K, int N, int slab, int slabs) {
  using namespace wg;
  constexpr int STAGE = stage_bytes<NG>(), STAGES = stages<NG>(), BN = 128 * NG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const TmaRing<STAGES> ring{reinterpret_cast<uint64_t*>(smem + STAGES * STAGE)};
  const int tn = (N + BN - 1) / BN, tiles = ((K + BT - 1) / BT) * tn, units = tiles * slabs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    ring.init(8);  // one release per consumer warp
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup: warp 0 loads
    ws_producer_regs();
    if (warp == 0 && lane == 0) {
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int t = u % tiles, k0 = (t / tn) * BT, n0 = (t % tn) * BN, s = u / tiles;
        const int m_hi = min(M, (s + 1) * slab);
        for (int m0 = s * slab; m0 < m_hi; m0 += BR, ++i) {
          unsigned char* st = smem + (i % STAGES) * STAGE;
          uint64_t* full = ring.fill(i, STAGE);
          tma_load_2d(st, &tmA, k0, m0, full);
          tma_load_2d(st + SW_BOX, &tmA, k0 + 64, m0, full);
#pragma unroll
          for (int b = 0; b < 2 * NG; ++b) tma_load_2d(st + A_CHUNK + b * SW_BOX, &tmB, n0 + 64 * b, m0, full);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns dW rows 64 c .. 64 c + 63 of each tile
  ws_consumer_regs();
  const int c = (warp >> 2) - 1;
  const int row0 = c * 64 + (warp & 3) * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  int i = 0;
  float acc[NG][64];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int t = u % tiles, k0 = (t / tn) * BT, n0 = (t % tn) * BN, s = u / tiles;
    const int m_hi = min(M, (s + 1) * slab);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[gi][e] = 0.f;
    const int i0 = i;
    for (int m0 = s * slab; m0 < m_hi; m0 += BR, ++i) {
      ring.wait(i);
      const unsigned char* st = smem + (i % STAGES) * STAGE;
      wgmma_fence();
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) wgmma_chunk64<1>(acc[gi], st + c * SW_BOX, st + A_CHUNK + gi * B_GROUP);
      wgmma_commit();
      wgmma_wait1();  // the previous chunk's products retired: its stage goes back
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) fence_regs(acc[gi]);
      if (lane == 0 && i > i0) ring.release(i - 1);
    }
    wgmma_wait0();
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) fence_regs(acc[gi]);
    if (lane == 0 && i > i0) ring.release(i - 1);
    float* out = P + (long long)s * K * N;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + gi * 128 + 8 * j + col0;
        if (col >= N) continue;  // N is even: col + 1 < N too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = k0 + row0 + 8 * h;
          if (r < K)
            *reinterpret_cast<float2*>(out + (long long)r * N + col) =
                make_float2(acc[gi][4 * j + 2 * h], acc[gi][4 * j + 2 * h + 1]);
        }
      }
  }
}

// fp32 (the parity path): 64 x 64 output tile, 16 rows per step, 4 x 4
// outputs per thread on CUDA-core FMAs.
__global__ void __launch_bounds__(256)
wgrad_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ P,
                 int M, int K, int N, int slab) {
  __shared__ float As[16][64];
  __shared__ float Bs[16][64];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nN = (N + 63) / 64, nK = (K + 63) / 64;
  const int tile = blockIdx.x % (nK * nN), s = blockIdx.x / (nK * nN);
  const int bk = (tile / nN) * 64, bn = (tile % nN) * 64;
  const int m_lo = s * slab, m_hi = min(M, m_lo + slab);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int m0 = m_lo; m0 < m_hi; m0 += 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, r = e >> 6, c = e & 63, gm = m0 + r;
      As[r][c] = (gm < m_hi && bk + c < K) ? A[(long long)gm * K + bk + c] : 0.f;
      Bs[r][c] = (gm < m_hi && bn + c < N) ? B[(long long)gm * N + bn + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[r][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = P + (long long)s * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = bk + ty * 4 + i, c = bn + tx * 4 + j;
      if (r < K && c < N) out[(long long)r * N + c] = acc[i][j];
    }
}

// ---------------------------------------------------------------- (b) LayerNorm backward
// A stream of bytes: the main path's calls read dh and x (fp32) and g_in
// (bf16 or fp32) and write g_out (fp32 and/or cd), 14-18 bytes an element
// against ~20 flops, so the design is about bytes in flight:
//   - persistent: LNB_THREADS-thread blocks, as many as fit the card at once
//     (SMs x the occupancy query's blocks per SM, ops/fused_train.py::
//     ln_bwd_plan); rows go to warps in a fixed order;
//   - D % 128 == 0 (and 16-byte aligned tensors), layer_norm_bwd_kernel:
//     tiles of LNB_WARPS consecutive rows (tile t: blockIdx.x, + gridDim.x,
//     ...) come through a ring of LNB_STAGES stages in shared memory, one
//     bulk copy of each input a tile (rows are contiguous), started by
//     thread 0 under an L2 evict-first policy, LNB_STAGES - 1 tiles ahead;
//     warp w takes row w of a tile, its lane l columns 4 l + 128 j (16-byte
//     reads of the staged row; the outputs leave 16 bytes a lane fp32, 8
//     bf16, 512 contiguous bytes a warp, with the streaming hint), and
//     arrives on the stage's empty barrier, which thread 0 waits on before
//     it refills the stage. Every input of a row is in shared memory before
//     any reduction of it. (Loading the next row into registers before this
//     row's reductions instead ran 1.3% slower at 16 bytes an element and
//     0.8% faster at 14, in turns on an NVIDIA H100 80GB HBM3 at 700 W:
//     PERF.md.)
//   - other D % 8 == 0 up to LNB_MAXD, layer_norm_bwd_narrow_kernel: warp w
//     of the grid's W takes rows w, w + W, ..., lane l columns l + 32 j,
//     masked past D (a D below 32 leaves lanes idle), the next row's loads
//     sent before this row's reductions;
//   - the four column sums (dscale, dbias, colsum(g_in), colsum(g_out)) of a
//     lane's columns stay in registers over the warp's rows, the warps meet
//     in shared memory in warp order, one partial row per block, and
//     sum_rows_kernel adds the blocks' rows in order: the same bits every run.
// The arithmetic is _ln_bwd's (cse_tpu/ops/fused_train.py:77): mean, the
// centred variance, dx = inv * (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
// g_out = g_in + dx.
constexpr int LNB_MAXD = 256;  // columns per row (D % 8 == 0, D <= 256)
constexpr int LNB_THREADS = 256, LNB_WARPS = LNB_THREADS / 32;
constexpr int LNB_STAGES = 4;  // tiles of LNB_WARPS rows in flight a block (the wide path)

enum LnbPath { LNB_NARROW = 0, LNB_WIDE = 1 };

// the columns of a row a lane owns: VEC consecutive ones in each of NJ chunks
template <int VEC, int NJ>
struct LnbCols {
  __device__ static int col(int lane, int j) { return VEC * lane + 32 * VEC * j; }
};

// one row's inputs, as fp32 in registers
template <int N>
struct LnbRow {
  float x[N], dy[N], g[N];
};

// the narrow path: one row's inputs, a column l + 32 j a lane (zeros past D or M)
template <int NJ, typename TG>
__device__ __forceinline__ void lnb_load(LnbRow<NJ>& r, const float* __restrict__ dh, const float* __restrict__ x,
                                         const TG* g_in, long long row, long long M, int D, int lane) {
  const long long o = row * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    const bool in = row < M && c < D;
    r.x[j] = in ? ld_stream(x + o + c) : 0.f;
    r.dy[j] = in ? ld_stream(dh + o + c) : 0.f;
    r.g[j] = in ? ld_stream(g_in + o + c) : 0.f;
  }
}

// The backward of one row from its inputs in registers: writes g_out and adds
// the row into the lane's column sums ps (dy * xhat), pb (dy), pgi, pgo.
template <int VEC, int NJ, typename TO>
__device__ __forceinline__ void lnb_row(LnbRow<VEC * NJ>& r, const float (&sc)[VEC * NJ], long long row, int D,
                                        float eps, int lane, float* g_out32, TO* __restrict__ g_out_cd,
                                        float (&ps)[VEC * NJ], float (&pb)[VEC * NJ], float (&pgi)[VEC * NJ],
                                        float (&pgo)[VEC * NJ]) {
  constexpr int N = VEC * NJ;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += r.x[i];
  const float mean = warp_sum(s) / D;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float d = LnbCols<VEC, NJ>::col(lane, i / VEC) + i % VEC < D ? r.x[i] - mean : 0.f;
    v += d * d;
  }
  const float inv = 1.0f / sqrtf(warp_sum(v) / D + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r.x[i] = (r.x[i] - mean) * inv;  // xhat
    const float dxh = r.dy[i] * sc[i];
    s1 += dxh;
    s2 += dxh * r.x[i];
  }
  float m[2] = {s1, s2};
  warp_sums(m);
  const float m1 = m[0] / D, m2 = m[1] / D;
  const long long o = row * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = LnbCols<VEC, NJ>::col(lane, j);
    if (c >= D) continue;
    float go[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const int i = VEC * j + u;
      const float dx = inv * (r.dy[i] * sc[i] - m1 - r.x[i] * m2);
      go[u] = r.g[i] + dx;
      ps[i] += r.dy[i] * r.x[i];
      pb[i] += r.dy[i];
      pgi[i] += r.g[i];
      pgo[i] += go[u];
    }
    if (g_out32) st_stream<VEC>(g_out32 + o + c, go);
    if (g_out_cd) st_stream<VEC>(g_out_cd + o + c, go);
  }
}

// The block's column sums: the warps' in shared memory (red: [LNB_WARPS][4][D]
// floats), added in warp order into part[blockIdx.x][4][D].
template <int VEC, int NJ>
__device__ __forceinline__ void lnb_block_sums(float* red, const float (&ps)[VEC * NJ], const float (&pb)[VEC * NJ],
                                               const float (&pgi)[VEC * NJ], const float (&pgo)[VEC * NJ],
                                               float* __restrict__ part, int D, int warp, int lane) {
  float* mine = red + (long long)warp * 4 * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const int c = LnbCols<VEC, NJ>::col(lane, j) + u, i = VEC * j + u;
      if (c >= D) continue;
      mine[c] = ps[i];
      mine[D + c] = pb[i];
      mine[2 * D + c] = pgi[i];
      mine[3 * D + c] = pgo[i];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < 4 * D; e += LNB_THREADS) {
    float t = red[e];
#pragma unroll
    for (int w = 1; w < LNB_WARPS; ++w) t += red[(long long)w * 4 * D + e];
    part[(long long)blockIdx.x * 4 * D + e] = t;
  }
}

// dh: grad of the LN output (fp32); x: the LN input (fp32); scale: LN scale
// (fp32). g_out32 may alias g_in (fp32): a row is read whole before it is
// written. Dynamic shared memory: lnb_red_bytes() (the narrow path) or the
// ring (the wide path), which the block sums reuse.
template <typename TG, typename TO>
__global__ void __launch_bounds__(LNB_THREADS)
layer_norm_bwd_narrow_kernel(const float* __restrict__ dh, const float* __restrict__ x,
                             const float* __restrict__ scale, const TG* g_in, float* g_out32,
                             TO* __restrict__ g_out_cd, float* __restrict__ part, long long M, int D,
                             float eps) {
  constexpr int NJ = LNB_MAXD / 32;
  extern __shared__ __align__(16) float lnb_red[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ps[NJ], pb[NJ], pgi[NJ], pgo[NJ], sc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    ps[j] = pb[j] = pgi[j] = pgo[j] = 0.f;
    sc[j] = lane + 32 * j < D ? scale[lane + 32 * j] : 0.f;
  }
  const long long W = (long long)gridDim.x * LNB_WARPS;
  long long row = (long long)blockIdx.x * LNB_WARPS + warp;
  LnbRow<NJ> cur;
  lnb_load<NJ>(cur, dh, x, g_in, row, M, D, lane);
  for (; row < M; row += W) {
    LnbRow<NJ> next;  // the next row's loads go out before this row's reductions
    lnb_load<NJ>(next, dh, x, g_in, row + W, M, D, lane);
    lnb_row<1, NJ>(cur, sc, row, D, eps, lane, g_out32, g_out_cd, ps, pb, pgi, pgo);
    cur = next;
  }
  lnb_block_sums<1, NJ>(lnb_red, ps, pb, pgi, pgo, part, D, warp, lane);
}

// the wide path: the bytes of a stage (x, dh fp32 and g_in of LNB_WARPS rows)
template <typename TG>
__host__ __device__ constexpr size_t lnb_stage_bytes(int D) { return (size_t)LNB_WARPS * D * (8 + sizeof(TG)); }

// the wide path (D = 128 NJ): see the design note above
template <int NJ, typename TG, typename TO>
__global__ void __launch_bounds__(LNB_THREADS)
layer_norm_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ x,
                      const float* __restrict__ scale, const TG* g_in, float* g_out32,
                      TO* __restrict__ g_out_cd, float* __restrict__ part, long long M, int D,
                      float eps) {
  constexpr int VEC = 4, N = VEC * NJ;
  extern __shared__ __align__(128) unsigned char lnb_ring[];
  __shared__ __align__(8) uint64_t full[LNB_STAGES], empty[LNB_STAGES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stage = lnb_stage_bytes<TG>(D);
  const long long tiles = (M + LNB_WARPS - 1) / LNB_WARPS;
  float ps[N], pb[N], pgi[N], pgo[N], sc[N];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const int i = VEC * j + u;
      ps[i] = pb[i] = pgi[i] = pgo[i] = 0.f;
      sc[i] = scale[LnbCols<VEC, NJ>::col(lane, j) + u];
    }
  const uint64_t policy = l2_evict_first();
  unsigned char* const ring = lnb_ring;
  uint64_t* const fullb = full;
  auto load_tile = [&](long long t, int s) {  // thread 0: tile t into stage s
    const long long r0 = t * LNB_WARPS;
    const unsigned rows = (unsigned)min((long long)LNB_WARPS, M - r0);
    unsigned char* base = ring + s * stage;
    mbar_expect_tx(fullb + s, (unsigned)(rows * D * (8 + sizeof(TG))));
    bulk_load(base, x + r0 * D, rows * D * 4, fullb + s, policy);
    bulk_load(base + (size_t)LNB_WARPS * D * 4, dh + r0 * D, rows * D * 4, fullb + s, policy);
    bulk_load(base + (size_t)LNB_WARPS * D * 8, g_in + r0 * D, rows * D * (unsigned)sizeof(TG), fullb + s, policy);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < LNB_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], LNB_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < LNB_STAGES; ++s)
      if (blockIdx.x + (long long)s * gridDim.x < tiles) load_tile(blockIdx.x + (long long)s * gridDim.x, s);
  int k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int s = k % LNB_STAGES;
    const unsigned parity = (k / LNB_STAGES) & 1;
    mbar_wait(&full[s], parity);
    const long long row = t * LNB_WARPS + warp;
    if (row < M) {
      const unsigned char* base = lnb_ring + s * stage;
      const float* xs = reinterpret_cast<const float*>(base) + warp * D;
      const float* ds = reinterpret_cast<const float*>(base + (size_t)LNB_WARPS * D * 4) + warp * D;
      const TG* gs = reinterpret_cast<const TG*>(base + (size_t)LNB_WARPS * D * 8) + warp * D;
      LnbRow<N> cur;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = LnbCols<VEC, NJ>::col(lane, j);
        const float4 a = *reinterpret_cast<const float4*>(xs + c), b = *reinterpret_cast<const float4*>(ds + c);
        cur.x[4 * j] = a.x, cur.x[4 * j + 1] = a.y, cur.x[4 * j + 2] = a.z, cur.x[4 * j + 3] = a.w;
        cur.dy[4 * j] = b.x, cur.dy[4 * j + 1] = b.y, cur.dy[4 * j + 2] = b.z, cur.dy[4 * j + 3] = b.w;
#pragma unroll
        for (int u = 0; u < VEC; ++u) cur.g[VEC * j + u] = to_f(gs[c + u]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      lnb_row<VEC, NJ>(cur, sc, row, D, eps, lane, g_out32, g_out_cd, ps, pb, pgi, pgo);
    } else if (lane == 0) {
      mbar_arrive(&empty[s]);
    }
    if (threadIdx.x == 0 && t + (long long)LNB_STAGES * gridDim.x < tiles) {
      mbar_wait(&empty[s], parity);
      load_tile(t + (long long)LNB_STAGES * gridDim.x, s);
    }
  }
  __syncthreads();  // every staged tile was waited on: the ring is free for the sums
  lnb_block_sums<VEC, NJ>(reinterpret_cast<float*>(lnb_ring), ps, pb, pgi, pgo, part, D, warp, lane);
}

inline size_t lnb_red_bytes(int D) { return (size_t)LNB_WARPS * 4 * D * sizeof(float); }

// The launch of a path and dtype pairing: the kernel, its dynamic shared
// bytes, and whether it may take them. A wide instantiation serves one D
// (NJ = 1: 128, NJ = 2: 256), so its opt-in is made once; the narrow path's
// bytes stay under the default limit.
struct LnbLaunch {
  const void* fn;
  size_t smem;
  cudaError_t err;
};

static_assert(LNB_WARPS * 4 * LNB_MAXD * sizeof(float) <= 48 * 1024, "the narrow path needs no opt-in");

template <typename TG, typename TO>
LnbLaunch lnb_launch(int path, int D) {
  if (path == LNB_NARROW)
    return {(const void*)layer_norm_bwd_narrow_kernel<TG, TO>, lnb_red_bytes(D), cudaSuccess};
  const size_t ring = LNB_STAGES * lnb_stage_bytes<TG>(D);
  const size_t smem = ring > lnb_red_bytes(D) ? ring : lnb_red_bytes(D);
  static bool ready1 = false, ready2 = false;
  if (D == 128)
    return {(const void*)layer_norm_bwd_kernel<1, TG, TO>, smem,
            allow_smem(layer_norm_bwd_kernel<1, TG, TO>, smem, ready1)};
  return {(const void*)layer_norm_bwd_kernel<2, TG, TO>, smem,
          allow_smem(layer_norm_bwd_kernel<2, TG, TO>, smem, ready2)};
}

// the path a launch takes: the wide one for D % 128 == 0 with 16-byte aligned tensors
inline int lnb_path(int D, bool aligned) { return D % 128 == 0 && aligned ? LNB_WIDE : LNB_NARROW; }

inline bool aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

template <typename TG, typename TO>
cudaError_t launch_lnb(int path, const float* dh, const float* x, const float* sc, const void* g_in, float* g_out32,
                       void* g_out_cd, float* part, long long M, int D, float eps, int blocks, cudaStream_t st) {
  const LnbLaunch l = lnb_launch<TG, TO>(path, D);
  if (l.err != cudaSuccess) return l.err;
  const TG* g = static_cast<const TG*>(g_in);
  TO* o = static_cast<TO*>(g_out_cd);
  void* args[] = {&dh, &x, &sc, &g, &g_out32, &o, &part, &M, &D, &eps};
  return cudaLaunchKernel(l.fn, dim3(blocks), dim3(LNB_THREADS), args, l.smem, st);
}

// dispatch on the dtype pairing: g_in bf16 or fp32, g_out_cd bf16 or fp32
template <class F>
cudaError_t by_lnb_dtypes(int g_in_bf16, int out_bf16, F&& f) {
  if (g_in_bf16 && out_bf16) return f(bf16{}, bf16{});
  if (g_in_bf16) return f(bf16{}, float{});
  if (out_bf16) return f(float{}, bf16{});
  return f(float{}, float{});
}

// ---------------------------------------------------------------- (c) attention backward
// Head width HD (4, 8, 16, 32, 64) is a template argument throughout.
constexpr int STRIP_MAX_L = 256;  // the bf16 route: one block a (sequence, head) up to here
constexpr int KT = 256;    // keys per shared-memory tile (dq kernels)
constexpr int QT = 128;    // queries per shared-memory tile (dk/dv kernels)
constexpr int RT = 64;     // rows (queries or keys) per block

// Shared layout of the inputs. qkv [G*L, 3D] fp32; dattn (the out-proj's
// input gradient) [G*L, D] fp32; stats [2, G*L, H] fp32 (max, 1/z);
// delta [G*L, H] fp32 (written by the dq kernel, read by the dk/dv kernel);
// dqkv [G*L, 3D] cd; part [G * ceil(L / RT), 3D] fp32 column partials.

// bf16 dq: 4 warps x 16 query rows. K, V of KT keys in shared memory (bf16).
template <int HD>
__global__ void __launch_bounds__(128, 4)
attention_bwd_dq_bf16_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                             const float* __restrict__ stats, float* __restrict__ delta_out,
                             bf16* __restrict__ dqkv, float* __restrict__ part, int L, int H,
                             float scale, int kt_rows) {
  constexpr int LD = Head<HD>::LD, NT = Head<HD>::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kt_rows][LD]
  bf16* Vs = Ks + kt_rows * LD;
  __shared__ float red[4][HD];
  const int ntile = (L + RT - 1) / RT;
  const int gh = blockIdx.x / ntile, qt = blockIdx.x % ntile, g = gh / H, h = gh % H;
  const int D = H * HD, D3 = 3 * D;
  const long long MH = (long long)(gridDim.x / ntile / H) * L * H;
  const float* base = qkv + (long long)g * L * D3 + h * HD;
  const float* dbase = dattn + (long long)g * L * D + h * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkt = (L + KT - 1) / KT;

  auto load_kv = [&](int k0) {
    for (int e = tid; e < kt_rows * (HD / 4); e += 128) {
      const int r = e / (HD / 4), c = (e % (HD / 4)) * 4, key = k0 + r;
      float4 k = make_float4(0.f, 0.f, 0.f, 0.f), v = k;
      if (key < L) {
        const float* row = base + (long long)key * D3 + c;
        k = *reinterpret_cast<const float4*>(row + D);
        v = *reinterpret_cast<const float4*>(row + 2 * D);
      }
      *reinterpret_cast<uint2*>(Ks + r * LD + c) = make_uint2(pack_bf16(k.x, k.y), pack_bf16(k.z, k.w));
      *reinterpret_cast<uint2*>(Vs + r * LD + c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  };

  const int q0 = qt * RT + warp * 16;
  const int ra = q0 + (lane >> 2), rb = ra + 8;
  const bool active = q0 < L;  // warp-uniform
  unsigned qa[Head<HD>::KS][4], da[Head<HD>::KS][4];  // cd(q * scale), cd(do) A fragments of rows ra, rb
  afrag_f32<HD>(qa, base, D3, ra, L, scale, lane);
  afrag_f32<HD>(da, dbase, D, ra, L, 1.f, lane);
  const long long ia = ((long long)g * L + ra) * H + h, ib = ((long long)g * L + rb) * H + h;
  const float ma = ra < L ? stats[ia] : 0.f, mb = rb < L ? stats[ib] : 0.f;
  const float za = ra < L ? stats[MH + ia] : 0.f, zb = rb < L ? stats[MH + ib] : 0.f;  // 1/z

  // p and dp of keys kb .. kb + 15 (p = 0 past the tile's nk keys)
  auto p_dp = [&](float (&p)[2][4], float (&dp)[2][4], int kb, int nk) {
    prod16<HD>(p, qa, Ks, kb, lane);
    prod16<HD>(dp, da, Vs, kb, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = kb + j * 8 + (lane & 3) * 2 + e < nk;
        p[j][e] = valid ? expf(p[j][e] - ma) : 0.f;
        p[j][2 + e] = valid ? expf(p[j][2 + e] - mb) : 0.f;
      }
  };

  if (nkt == 1) {
    load_kv(0);
    __syncthreads();
  }
  // pass 1: delta = rowsum(dp * p) * invz
  float dla = 0.f, dlb = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    if (nkt > 1) {
      __syncthreads();
      load_kv(kt * KT);
      __syncthreads();
    }
    const int nk = min(KT, L - kt * KT);
    if (!active) continue;
    for (int kb = 0; kb < nk; kb += 16) {
      float p[2][4], dp[2][4];
      p_dp(p, dp, kb, nk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dla += dp[j][e] * p[j][e];
          dlb += dp[j][2 + e] * p[j][2 + e];
        }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    dla += __shfl_xor_sync(FULL, dla, o);
    dlb += __shfl_xor_sync(FULL, dlb, o);
  }
  dla *= za;
  dlb *= zb;
  if ((lane & 3) == 0) {
    if (ra < L) delta_out[ia] = dla;
    if (rb < L) delta_out[ib] = dlb;
  }
  // pass 2: ds = p * (dp - delta) * invz; dq = cd(ds) . cd(k)
  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    if (nkt > 1) {
      __syncthreads();
      load_kv(kt * KT);
      __syncthreads();
    }
    const int nk = min(KT, L - kt * KT);
    if (!active) continue;
    for (int kb = 0; kb < nk; kb += 16) {
      float p[2][4], dp[2][4];
      p_dp(p, dp, kb, nk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[j][e] = p[j][e] * (dp[j][e] - dla) * za;
          p[j][2 + e] = p[j][2 + e] * (dp[j][2 + e] - dlb) * zb;
        }
      const unsigned sa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      mma_rows<HD>(dq, sa, Ks, kb, lane);
    }
  }
  // write cd(dq) and the column partials of the fp32 dq over the block's rows
  float cs[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int d = j * 8 + (lane & 3) * 2;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = scale * dq[j][e];
    const bool in = in_head<HD>(j * 8, lane);  // hd 4: not the tile's columns 4 .. 7
    if (in && ra < L)
      *reinterpret_cast<__nv_bfloat162*>(dqkv + ((long long)g * L + ra) * D3 + h * HD + d) =
          __floats2bfloat162_rn(v[0], v[1]);
    if (in && rb < L)
      *reinterpret_cast<__nv_bfloat162*>(dqkv + ((long long)g * L + rb) * D3 + h * HD + d) =
          __floats2bfloat162_rn(v[2], v[3]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float t = (ra < L ? v[e] : 0.f) + (rb < L ? v[2 + e] : 0.f);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) t += __shfl_xor_sync(FULL, t, o);
      cs[j][e] = t;
    }
  }
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (!in_head<HD>(j * 8, lane)) continue;
      red[warp][j * 8 + lane * 2] = cs[j][0];
      red[warp][j * 8 + lane * 2 + 1] = cs[j][1];
    }
  __syncthreads();
  if (tid < HD)
    part[((long long)g * ntile + qt) * D3 + h * HD + tid] = red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid];
}

// bf16 dk, dv: 4 warps x 16 keys. Queries in tiles of QT in shared memory:
// cd(q*scale), cd(do), cd(do*invz) and the rows' m, invz, delta.
template <int HD>
constexpr size_t dkdv_bf16_smem() { return sizeof(bf16) * 3 * QT * Head<HD>::LD + sizeof(float) * 3 * QT; }

template <int HD>
__global__ void __launch_bounds__(128, 4)
attention_bwd_dkdv_bf16_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                               const float* __restrict__ stats, const float* __restrict__ delta,
                               bf16* __restrict__ dqkv, float* __restrict__ part, int L, int H,
                               float scale) {
  constexpr int LD = Head<HD>::LD, NT = Head<HD>::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [QT][LD]
  bf16* Os = Qs + QT * LD;                   // cd(do)
  bf16* Zs = Os + QT * LD;                   // cd(do * invz)
  float* qm = reinterpret_cast<float*>(Zs + QT * LD);
  float* qz = qm + QT;
  float* qd = qz + QT;
  __shared__ float red[4][2 * HD];
  const int ntile = (L + RT - 1) / RT;
  const int gh = blockIdx.x / ntile, kt = blockIdx.x % ntile, g = gh / H, h = gh % H;
  const int D = H * HD, D3 = 3 * D;
  const long long MH = (long long)(gridDim.x / ntile / H) * L * H;
  const float* base = qkv + (long long)g * L * D3 + h * HD;
  const float* dbase = dattn + (long long)g * L * D + h * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int k0 = kt * RT + warp * 16;
  const int ka_ = k0 + (lane >> 2), kb_ = ka_ + 8;  // this thread's two key rows
  unsigned kf[Head<HD>::KS][4], vf[Head<HD>::KS][4];  // cd(k), cd(v) A fragments
  afrag_f32<HD>(kf, base + D, D3, ka_, L, 1.f, lane);
  afrag_f32<HD>(vf, base + 2 * D, D3, ka_, L, 1.f, lane);
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int q0 = 0; q0 < L; q0 += QT) {
    __syncthreads();  // every warp is done with the previous query tile
    for (int e = tid; e < QT * (HD / 4); e += 128) {
      const int r = e / (HD / 4), c = (e % (HD / 4)) * 4, q = q0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      float iz = 0.f;
      if (q < L) {
        x = *reinterpret_cast<const float4*>(base + (long long)q * D3 + c);
        y = *reinterpret_cast<const float4*>(dbase + (long long)q * D + c);
        iz = stats[MH + ((long long)g * L + q) * H + h];
      }
      *reinterpret_cast<uint2*>(Qs + r * LD + c) =
          make_uint2(pack_bf16(x.x * scale, x.y * scale), pack_bf16(x.z * scale, x.w * scale));
      *reinterpret_cast<uint2*>(Os + r * LD + c) = make_uint2(pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
      *reinterpret_cast<uint2*>(Zs + r * LD + c) =
          make_uint2(pack_bf16(y.x * iz, y.y * iz), pack_bf16(y.z * iz, y.w * iz));
    }
    for (int r = tid; r < QT; r += 128) {
      const int q = q0 + r;
      const long long i = ((long long)g * L + q) * H + h;
      qm[r] = q < L ? stats[i] : 0.f;
      qz[r] = q < L ? stats[MH + i] : 0.f;
      qd[r] = q < L ? delta[i] : 0.f;
    }
    __syncthreads();
    if (k0 >= L) continue;  // warp-uniform; the barriers above are reached by all
    const int nq = min(QT, L - q0);
    for (int qb = 0; qb < nq; qb += 16) {
      // sT[key][query] = cd(k) . cd(q*scale); dpT = cd(v) . cd(do)
      float s[2][4], dp[2][4];
      prod16<HD>(s, kf, Qs, qb, lane);
      prod16<HD>(dp, vf, Os, qb, lane);
      // column (query) index of fragment element e of n8 tile j: qb + j*8 + 2*(lane&3) + (e&1)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = qb + j * 8 + (lane & 3) * 2 + (e & 1);
          const float p = qr < nq ? expf(s[j][e] - qm[qr]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - qd[qr]) * qz[qr];  // dsT
        }
      const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const unsigned sa[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
      mma_rows<HD>(dv, pa, Zs, qb, lane);
      mma_rows<HD>(dk, sa, Qs, qb, lane);
    }
  }
  // write cd(dk), cd(dv) and their column partials over the block's keys
  float cs[2][NT][2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* v = t == 0 ? dk[j] : dv[j];
      const int col = (t + 1) * D + h * HD + j * 8 + (lane & 3) * 2;
      const bool in = in_head<HD>(j * 8, lane);
      if (in && ka_ < L)
        *reinterpret_cast<__nv_bfloat162*>(dqkv + ((long long)g * L + ka_) * D3 + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      if (in && kb_ < L)
        *reinterpret_cast<__nv_bfloat162*>(dqkv + ((long long)g * L + kb_) * D3 + col) =
            __floats2bfloat162_rn(v[2], v[3]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = (ka_ < L ? v[e] : 0.f) + (kb_ < L ? v[2 + e] : 0.f);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(FULL, s, o);
        cs[t][j][e] = s;
      }
    }
  if (lane < 4)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (!in_head<HD>(j * 8, lane)) continue;
        red[warp][t * HD + j * 8 + lane * 2] = cs[t][j][0];
        red[warp][t * HD + j * 8 + lane * 2 + 1] = cs[t][j][1];
      }
  __syncthreads();
  if (tid < 2 * HD) {
    const int t = tid / HD, c = tid % HD;
    part[((long long)g * ntile + kt) * D3 + (t + 1) * D + h * HD + c] =
        red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid];
  }
}

// bf16, L <= 256: one block per (sequence, head), one pass. The block
// stages K and V of the whole sequence as bf16 once (common.cuh's
// stage_rows) with every row's m and 1/z, and warp w owns the key strip
// w * 16 .. w * 16 + 15 (NB warps for L <= 16 NB). It walks the queries in
// chunks of QC rows: each chunk's fp32 q and do arrive by cp.async RS chunks
// ahead (a ring in shared memory) while the block computes, and are rounded
// into cd(q * scale),
// cd(do) and cd(do * invz) tiles. For each 16-query block of the chunk a
// warp computes, in registers, the transposed scores sT = cd(k) . cd(q
// scale)^T and dpT = cd(v) . cd(do)^T of its keys, p = exp(s - m) once per
// score (ex2 with log2(e) folded into one FMA), and its keys' share of each
// query's delta = rowsum(dp * p) * invz. The shares meet in shared memory and
// are added in warp order; then ds = p (dp - delta) invz, dv += cd(p)^T .
// cd(do * invz) and dk += cd(ds)^T . cd(q * scale) (from the registers: an
// m16n8 accumulator tile is an A fragment), and cd(ds) goes to a
// [keys][queries] tile of the whole sequence. dk and dv stay in registers
// across the chunks. Last, warp w takes query strip w: dq = scale * cd(ds) .
// cd(k) (the A fragment from the tile by ldmatrix.trans). Five products
// (six at HD 64, where dp is recomputed rather than held, for registers);
// delta never leaves the block; each fp32 input is read once; one fp32
// column-partial row per block.
template <int HD>
__host__ __device__ constexpr int bwd_strip_qc() { return HD <= 32 ? 32 : 16; }  // query rows a chunk

template <int HD, int NB>
struct BwdStrip {
  static constexpr int NR = NB * 16, LD = Head<HD>::LD, QC = bwd_strip_qc<HD>(), LDT = NR + 8;
  // HD <= 32: a chunk's k and v A fragments and dp stay in registers; HD 64 reloads the fragments
  // a k-step at a time and computes dp again for ds (six products), for registers
  static constexpr bool REGS = HD <= 32;
  static constexpr int RS = HD <= 32 ? 4 : 1;             // chunks of fp32 q and do in flight (shared memory)
  // shared memory: Ks, Vs [NR][LD]; Qs, Os, Zs [QC][LD]; DsT [NR][LDT] (bf16); R [RS][2][QC][HD]
  // (the coming chunks' fp32 q and do); then fp32 mL, iz [NR], delta [QC], red [NB][QC] (delta
  // shares). The column sums cred [NB][3 HD] take Vs's place once the chunks are done.
  static constexpr size_t OFF_Q = 2 * 2 * NR * LD, OFF_T = OFF_Q + 2 * 3 * QC * LD, OFF_R = OFF_T + 2 * NR * LDT;
  static constexpr size_t OFF_F = OFF_R + 4 * RS * 2 * QC * HD;
  static constexpr size_t SMEM = OFF_F + 4 * (2 * NR + QC + NB * QC);
  static_assert(4 * NB * 3 * HD <= 2 * NR * LD, "the column sums fit in Vs");
};

template <int HD, int NB>
__global__ void __launch_bounds__(32 * NB, NB == 8 ? 2 : 1)
attention_bwd_strip_bf16_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                                const float* __restrict__ stats, bf16* __restrict__ dqkv, float* __restrict__ part,
                                int L, int H, float scale) {
  using S = BwdStrip<HD, NB>;
  constexpr int LD = S::LD, QC = S::QC, LDT = S::LDT, NT = Head<HD>::NT, KS = Head<HD>::KS, QB = QC / 16;
  constexpr int C4 = HD / 4;  // float4 a row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + S::NR * LD;
  bf16* Qs = reinterpret_cast<bf16*>(smem + S::OFF_Q);
  bf16* Os = Qs + QC * LD;
  bf16* Zs = Os + QC * LD;
  bf16* DsT = reinterpret_cast<bf16*>(smem + S::OFF_T);
  float* R = reinterpret_cast<float*>(smem + S::OFF_R);
  float* mL = reinterpret_cast<float*>(smem + S::OFF_F);  // m * log2(e), +inf past L (p = 0 there)
  float* iz = mL + S::NR;                                 // 1/z, 0 past L
  float* dl = iz + S::NR;
  float* red = dl + QC;
  float* cred = reinterpret_cast<float*>(Vs);
  const int g = blockIdx.x / H, h = blockIdx.x % H, D = H * HD;
  const long long D3 = 3LL * D, MH = (long long)(gridDim.x / H) * L * H;
  const float* base = qkv + (long long)g * L * D3 + h * HD;
  const float* dbase = dattn + (long long)g * L * D + h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int k0 = warp * 16, nkw = (L + 15) / 16;  // this warp's keys; warps (and query strips) with rows
  const bool keys = warp < nkw, edge = k0 + 16 > L;  // warp-uniform
  const float LOG2E = 1.4426950408889634f;

  // the fp32 q and do of chunk ci (query rows ci QC .. + QC - 1, zero past L) into R's stage
  // ci % RS, as one cp.async group (empty past the last chunk, so that every chunk waits alike)
  auto fetch = [&](int ci) {
    float* Rs = R + (ci % S::RS) * 2 * QC * HD;
    for (int e = threadIdx.x; ci * QC < L && e < 2 * QC * C4; e += blockDim.x) {
      const int u = e / (QC * C4), r = (e / C4) % QC, c = (e % C4) * 4, q = ci * QC + r;
      const float* src = u == 0 ? base + q * D3 + c : dbase + (long long)q * D + c;
      cp_async16(Rs + e * 4, q < L ? src : base, q < L);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ci = 0; ci < S::RS; ++ci) fetch(ci);
  const int r0 = threadIdx.x;  // its row's m and 1/z (NR <= blockDim.x), loaded beside K and V
  const float* st = stats + ((long long)g * L + r0) * H + h;
  const float m0 = r0 < L ? st[0] : 0.f, z0 = r0 < L ? st[MH] : 0.f;
  stage_rows<HD, S::NR, 4, 2>({base + D, base + 2 * D}, {D3, D3}, L, [&](int u, int r, int c, float4 v) {
    put_bf16x4((u == 0 ? Ks : Vs) + r * LD + c, v, 1.f);
  });
  if (r0 < S::NR) {
    mL[r0] = r0 < L ? m0 * LOG2E : __int_as_float(0x7f800000);
    iz[r0] = z0;
  }
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int q0 = 0, ci = 0; q0 < L; q0 += QC, ++ci) {
    cp_async_wait<S::RS - 1>();
    __syncthreads();  // R holds the chunk; K, V, m, 1/z are staged; the previous chunk's tiles are read
    const float* Rs = R + (ci % S::RS) * 2 * QC * HD;
    for (int e = threadIdx.x; e < QC * C4; e += blockDim.x) {
      const int r = e / C4, c = (e % C4) * 4;
      put_bf16x4(Qs + r * LD + c, *reinterpret_cast<const float4*>(Rs + e * 4), scale);
      const float4 d = *reinterpret_cast<const float4*>(Rs + (QC * C4 + e) * 4);
      put_bf16x4(Os + r * LD + c, d, 1.f);
      put_bf16x4(Zs + r * LD + c, d, iz[q0 + r]);
    }
    __syncthreads();
    fetch(ci + S::RS);  // into the stage just read; lands while the next RS - 1 chunks compute
    const float* mLc = mL + q0;
    const float* izc = iz + q0;
    // pT, dpT [key][query] of this warp's keys against the chunk's query blocks; element (j, e) of a
    // block: key k0 + lane / 4 + 8 (e / 2), query qb 16 + 8 j + 2 (lane % 4) + e % 2 of the chunk
    float p[QB][2][4], dp[S::REGS ? QB : 1][2][4];
    unsigned vf[S::REGS ? KS : 1][4];
    auto dp_of = [&](float (&d)[2][4], int qb) {  // dpT = cd(v) . cd(do)^T
      if constexpr (S::REGS) prod16<HD>(d, vf, Os, qb * 16, lane);
      else prod16_smem<HD>(d, Vs, k0, Os, qb * 16, lane);
    };
    if (keys) {
      if constexpr (S::REGS) {
        unsigned kf[KS][4];
        afrag_smem<HD>(kf, Ks, k0, lane);
#pragma unroll
        for (int qb = 0; qb < QB; ++qb) prod16<HD>(p[qb], kf, Qs, qb * 16, lane);
        afrag_smem<HD>(vf, Vs, k0, lane);
      } else {
#pragma unroll
        for (int qb = 0; qb < QB; ++qb) prod16_smem<HD>(p[qb], Ks, k0, Qs, qb * 16, lane);
      }
#pragma unroll
      for (int qb = 0; qb < QB; ++qb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 m2 = *reinterpret_cast<const float2*>(mLc + qb * 16 + j * 8 + 2 * q4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = ex2_approx(fmaf(p[qb][j][e], LOG2E, -(e & 1 ? m2.y : m2.x)));
            if (edge && k0 + (lane >> 2) + 8 * (e >> 1) >= L) v = 0.f;
            p[qb][j][e] = v;
          }
        }
      // this strip's share of each query's rowsum(dp * p): its 16 keys, over the rows of the tile
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) {
        float (&d)[2][4] = dp[S::REGS ? qb : 0];
        dp_of(d, qb);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = d[j][e] * p[qb][j][e] + d[j][2 + e] * p[qb][j][2 + e];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
            if (lane < 4) red[warp * QC + qb * 16 + j * 8 + 2 * lane + e] = v;
          }
      }
    }
    __syncthreads();
    // delta of each query: the strips' shares added in a fixed order, four threads a query
    for (int t = threadIdx.x; t < 4 * QC; t += blockDim.x) {
      const int col = t >> 2;
      float d = 0.f;
      for (int w = t & 3; w < nkw; w += 4) d += red[w * QC + col];
      d += __shfl_xor_sync(FULL, d, 1);
      d += __shfl_xor_sync(FULL, d, 2);
      if ((t & 3) == 0) dl[col] = d * izc[col];
    }
    __syncthreads();
    if (keys) {
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) {
        float (&ds)[2][4] = dp[S::REGS ? qb : 0];
        if constexpr (!S::REGS) dp_of(ds, qb);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(dl + qb * 16 + j * 8 + 2 * q4);
          const float2 z2 = *reinterpret_cast<const float2*>(izc + qb * 16 + j * 8 + 2 * q4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[j][e] = p[qb][j][e] * (ds[j][e] - (e & 1 ? d2.y : d2.x)) * (e & 1 ? z2.y : z2.x);
        }
        const float (&pp)[2][4] = p[qb];
        const unsigned pa[4] = {pack_bf16(pp[0][0], pp[0][1]), pack_bf16(pp[0][2], pp[0][3]),
                                pack_bf16(pp[1][0], pp[1][1]), pack_bf16(pp[1][2], pp[1][3])};
        const unsigned sa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
        mma_rows<HD>(dv, pa, Zs, qb * 16, lane);
        mma_rows<HD>(dk, sa, Qs, qb * 16, lane);
        bf16* t = DsT + (k0 + (lane >> 2)) * LDT + q0 + qb * 16 + 2 * q4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          *reinterpret_cast<unsigned*>(t + j * 8) = sa[2 * j];
          *reinterpret_cast<unsigned*>(t + 8 * LDT + j * 8) = sa[2 * j + 1];
        }
      }
    }
  }
  __syncthreads();  // DsT is whole; Vs is free for the column sums

  // cd(dk), cd(dv) of key strip `warp`, then cd(dq) of query strip `warp` (dk and dv are
  // written before dq accumulates: fewer registers), and the fp32 column sums of all three
  // over the warp's rows (cred, added in warp order below)
  if (keys) {
    const int ra = k0 + (lane >> 2), rb = ra + 8;
    auto out = [&](int t, const float (&x)[NT][4], float mul) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = mul * x[j][e];
        bf16* o = dqkv + ((long long)g * L + ra) * D3 + t * D + h * HD + j * 8 + 2 * q4;
        const bool in = in_head<HD>(j * 8, lane);  // hd 4: not the tile's columns 4 .. 7
        if (in && ra < L) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
        if (in && rb < L) *reinterpret_cast<__nv_bfloat162*>(o + 8 * D3) = __floats2bfloat162_rn(v[2], v[3]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = (ra < L ? v[e] : 0.f) + (rb < L ? v[2 + e] : 0.f);
#pragma unroll
          for (int o2 = 4; o2 < 32; o2 <<= 1) c += __shfl_xor_sync(FULL, c, o2);
          if (lane < 4 && in) cred[warp * 3 * HD + t * HD + j * 8 + 2 * lane + e] = c;
        }
      }
    };
    out(1, dk, 1.f);
    out(2, dv, 1.f);
    float dq[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
    const int ar = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) * 8;
    for (int cb = 0; cb < nkw; ++cb) {
      unsigned a[4];  // cd(ds) [queries k0 .. + 15][keys cb 16 .. + 15]: DsT transposed
      ldmatrix_x4_trans(a, DsT + (cb * 16 + ar) * LDT + k0 + ac);
      mma_rows<HD>(dq, a, Ks, cb * 16, lane);
    }
    out(0, dq, scale);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * HD; c += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < nkw; ++w) v += cred[w * 3 * HD + c];
    part[(long long)g * D3 + (c / HD) * D + h * HD + c % HD] = v;
  }
}

// fp32 (the parity path), CUDA-core FMAs. dq: 8 warps x 8 query rows, lane j
// takes key c + j and owns output columns j, j + 32. K (HD + 1-word rows)
// and V of KT keys in shared memory.
template <int HD>
constexpr size_t dq_f32_smem() { return sizeof(float) * 2 * KT * (HD + 1); }

template <int HD>
__global__ void __launch_bounds__(256)
attention_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                            const float* __restrict__ stats, float* __restrict__ delta_out,
                            float* __restrict__ dqkv, float* __restrict__ part, int L, int H,
                            float scale) {
  constexpr int LK = HD + 1, NC = (HD + 31) / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [KT][LK]
  float* Vs = Ks + KT * LK;
  __shared__ float red[8][HD];
  constexpr int ROWS = RT / 8;
  const int ntile = (L + RT - 1) / RT;
  const int gh = blockIdx.x / ntile, qt = blockIdx.x % ntile, g = gh / H, h = gh % H;
  const int D = H * HD, D3 = 3 * D;
  const long long MH = (long long)(gridDim.x / ntile / H) * L * H;
  const float* base = qkv + (long long)g * L * D3 + h * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkt = (L + KT - 1) / KT;

  auto load_kv = [&](int k0) {
    for (int e = tid; e < KT * HD; e += 256) {
      const int r = e / HD, d = e % HD, key = k0 + r;
      const float* row = base + (long long)key * D3 + d;
      Ks[r * LK + d] = key < L ? row[D] : 0.f;
      Vs[r * LK + d] = key < L ? row[2 * D] : 0.f;
    }
  };
  float dl[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    dl[r] = 0.f;
#pragma unroll
    for (int u = 0; u < NC; ++u) acc[r][u] = 0.f;
  }
  auto row_of = [&](int r) { return qt * RT + warp + r * 8; };

  for (int pass = 0; pass < 2; ++pass) {
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      load_kv(kt * KT);
      __syncthreads();
      const int nk = min(KT, L - kt * KT);
#pragma unroll 1
      for (int r = 0; r < ROWS; ++r) {
        const int q = row_of(r);
        if (q >= L) continue;  // warp-uniform
        const long long qi = (long long)g * L + q;
        float qv[HD], dv[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          qv[d] = base[(long long)q * D3 + d] * scale;
          dv[d] = dattn[qi * D + h * HD + d];
        }
        const float m = stats[qi * H + h], iz = stats[MH + qi * H + h];
        for (int c = 0; c < nk; c += 32) {
          const int key = c + lane;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            s = fmaf(qv[d], Ks[key * LK + d], s);
            dp = fmaf(dv[d], Vs[key * LK + d], dp);
          }
          const float p = key < nk ? expf(s - m) : 0.f;
          if (pass == 0) {
            dl[r] += dp * p;
          } else {
            const float ds = p * (dp - dl[r]) * iz;
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              const float dj = __shfl_sync(FULL, ds, j);
#pragma unroll
              for (int u = 0; u < NC; ++u)
                if (lane + 32 * u < HD) acc[r][u] = fmaf(dj, Ks[(c + j) * LK + lane + 32 * u], acc[r][u]);
            }
          }
        }
      }
    }
    if (pass == 0)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        dl[r] = warp_sum(dl[r]);
        const int q = row_of(r);
        if (q < L) {
          const long long qi = (long long)g * L + q;
          dl[r] *= stats[MH + qi * H + h];
          if (lane == 0) delta_out[qi * H + h] = dl[r];
        }
      }
  }
  float cs[NC] = {};
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int q = row_of(r);
    if (q >= L) continue;
#pragma unroll
    for (int u = 0; u < NC; ++u)
      if (lane + 32 * u < HD) {
        const float v = scale * acc[r][u];
        dqkv[((long long)g * L + q) * D3 + h * HD + lane + 32 * u] = v;
        cs[u] += v;
      }
  }
#pragma unroll
  for (int u = 0; u < NC; ++u)
    if (lane + 32 * u < HD) red[warp][lane + 32 * u] = cs[u];
  __syncthreads();
  if (tid < HD) {
    float t = red[0][tid];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += red[w][tid];
    part[((long long)g * ntile + qt) * D3 + h * HD + tid] = t;
  }
}

// fp32 dk, dv: 8 warps x 8 keys, lane j takes query c + j and owns output
// columns j, j + 32. Queries in tiles of QT: q*scale and do (HD + 1-word
// rows), m, invz, delta.
template <int HD>
constexpr size_t dkdv_f32_smem() { return sizeof(float) * (2 * QT * (HD + 1) + 3 * QT); }

template <int HD>
__global__ void __launch_bounds__(256)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dattn,
                              const float* __restrict__ stats, const float* __restrict__ delta,
                              float* __restrict__ dqkv, float* __restrict__ part, int L, int H,
                              float scale) {
  constexpr int LK = HD + 1, NC = (HD + 31) / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [QT][LK]
  float* Os = Qs + QT * LK;
  float* qm = Os + QT * LK;
  float* qz = qm + QT;
  float* qd = qz + QT;
  __shared__ float red[8][2 * HD];
  constexpr int ROWS = RT / 8;
  const int ntile = (L + RT - 1) / RT;
  const int gh = blockIdx.x / ntile, kt = blockIdx.x % ntile, g = gh / H, h = gh % H;
  const int D = H * HD, D3 = 3 * D;
  const long long MH = (long long)(gridDim.x / ntile / H) * L * H;
  const float* base = qkv + (long long)g * L * D3 + h * HD;
  const float* dbase = dattn + (long long)g * L * D + h * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float dk[ROWS][NC], dv[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int u = 0; u < NC; ++u) dk[r][u] = dv[r][u] = 0.f;
  auto key_of = [&](int r) { return kt * RT + warp + r * 8; };

  for (int q0 = 0; q0 < L; q0 += QT) {
    __syncthreads();
    for (int e = tid; e < QT * HD; e += 256) {
      const int r = e / HD, d = e % HD, q = q0 + r;
      Qs[r * LK + d] = q < L ? base[(long long)q * D3 + d] * scale : 0.f;
      Os[r * LK + d] = q < L ? dbase[(long long)q * D + d] : 0.f;
    }
    for (int r = tid; r < QT; r += 256) {
      const int q = q0 + r;
      const long long i = ((long long)g * L + q) * H + h;
      qm[r] = q < L ? stats[i] : 0.f;
      qz[r] = q < L ? stats[MH + i] : 0.f;
      qd[r] = q < L ? delta[i] : 0.f;
    }
    __syncthreads();
    const int nq = min(QT, L - q0);
#pragma unroll 1
    for (int r = 0; r < ROWS; ++r) {
      const int key = key_of(r);
      if (key >= L) continue;  // warp-uniform
      float kv[HD], vv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        kv[d] = base[(long long)key * D3 + D + d];
        vv[d] = base[(long long)key * D3 + 2 * D + d];
      }
      for (int c = 0; c < nq; c += 32) {
        const int q = c + lane;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          s = fmaf(kv[d], Qs[q * LK + d], s);
          dp = fmaf(vv[d], Os[q * LK + d], dp);
        }
        const float p = q < nq ? expf(s - qm[q]) : 0.f;
        const float ds = p * (dp - qd[q]) * qz[q];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int qj = c + j;
          const float pj = __shfl_sync(FULL, p, j), dj = __shfl_sync(FULL, ds, j);
#pragma unroll
          for (int u = 0; u < NC; ++u)
            if (lane + 32 * u < HD) {
              dv[r][u] = fmaf(pj, Os[qj * LK + lane + 32 * u] * qz[qj], dv[r][u]);
              dk[r][u] = fmaf(dj, Qs[qj * LK + lane + 32 * u], dk[r][u]);
            }
        }
      }
    }
  }
  float ck[NC] = {}, cv[NC] = {};
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int key = key_of(r);
    if (key >= L) continue;
    const long long o = ((long long)g * L + key) * D3 + h * HD;
#pragma unroll
    for (int u = 0; u < NC; ++u)
      if (lane + 32 * u < HD) {
        dqkv[o + D + lane + 32 * u] = dk[r][u];
        dqkv[o + 2 * D + lane + 32 * u] = dv[r][u];
        ck[u] += dk[r][u];
        cv[u] += dv[r][u];
      }
  }
#pragma unroll
  for (int u = 0; u < NC; ++u)
    if (lane + 32 * u < HD) {
      red[warp][lane + 32 * u] = ck[u];
      red[warp][HD + lane + 32 * u] = cv[u];
    }
  __syncthreads();
  if (tid < 2 * HD) {
    float t = red[0][tid];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += red[w][tid];
    const int which = tid / HD, c = tid % HD;
    part[((long long)g * ntile + kt) * D3 + (which + 1) * D + h * HD + c] = t;
  }
}

// One launch of the bf16 attention backward at L: the strip kernel (its
// shared-memory limit raised once; NB key blocks of 16) for L <= 256, else
// the two kernels of 64-row tiles (reported by the dq kernel's attributes).
struct BwdPlan {
  const void* fn;
  int nb, threads, rows;
  size_t smem;
  cudaError_t err;
};

template <int HD, int NB>
BwdPlan bwd_strip_plan() {
  using S = BwdStrip<HD, NB>;
  static const cudaError_t e = cudaFuncSetAttribute(attention_bwd_strip_bf16_kernel<HD, NB>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  return {reinterpret_cast<const void*>(attention_bwd_strip_bf16_kernel<HD, NB>), NB, 32 * NB, 0, S::SMEM, e};
}

template <int HD>
BwdPlan plan_attention_bwd_bf16(int L) {
  BwdPlan p;
  if (L <= 128) p = bwd_strip_plan<HD, 8>();
  else if (L <= STRIP_MAX_L) p = bwd_strip_plan<HD, 16>();
  else {
    static const cudaError_t e = cudaFuncSetAttribute(attention_bwd_dq_bf16_kernel<HD>,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                      (int)(sizeof(bf16) * 2 * KT * Head<HD>::LD));
    return {reinterpret_cast<const void*>(attention_bwd_dq_bf16_kernel<HD>), 0, 128, RT,
            sizeof(bf16) * 2 * KT * Head<HD>::LD, e};
  }
  p.rows = L;
  return p;
}

// rows of column partials a launch writes: one per (sequence, 64-row tile), or per sequence on the strip route
inline int bwd_partial_rows(int bf, int G, int L) { return bf && L <= STRIP_MAX_L ? G : G * ((L + RT - 1) / RT); }

template <int HD>
cudaError_t launch_attention_bwd(int bf, const float* q, const float* da, const float* sm, float* dl, void* dqkv,
                                 float* part, int G, int L, int H, float scale, cudaStream_t st) {
  if (L < 1) return cudaErrorInvalidValue;
  const int ntile = (L + RT - 1) / RT;
  const unsigned blocks = (unsigned)(G * H * ntile);
  cudaError_t e;
  if (bf && L <= STRIP_MAX_L) {
    const BwdPlan p = plan_attention_bwd_bf16<HD>(L);
    if (p.err != cudaSuccess) return p.err;
    bf16* out = static_cast<bf16*>(dqkv);
    if (p.nb == 8)
      attention_bwd_strip_bf16_kernel<HD, 8><<<G * H, p.threads, p.smem, st>>>(q, da, sm, out, part, L, H, scale);
    else
      attention_bwd_strip_bf16_kernel<HD, 16><<<G * H, p.threads, p.smem, st>>>(q, da, sm, out, part, L, H, scale);
  } else if (bf) {
    if (!dl) return cudaErrorInvalidValue;
    static bool ready_k = false;
    const BwdPlan p = plan_attention_bwd_bf16<HD>(L);
    if (p.err != cudaSuccess) return p.err;
    const int kt_rows = (min(L, KT) + 15) / 16 * 16;
    attention_bwd_dq_bf16_kernel<HD><<<blocks, 128, sizeof(bf16) * 2 * kt_rows * Head<HD>::LD, st>>>(
        q, da, sm, dl, static_cast<bf16*>(dqkv), part, L, H, scale, kt_rows);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = allow_smem(attention_bwd_dkdv_bf16_kernel<HD>, dkdv_bf16_smem<HD>(), ready_k)) != cudaSuccess) return e;
    attention_bwd_dkdv_bf16_kernel<HD><<<blocks, 128, dkdv_bf16_smem<HD>(), st>>>(
        q, da, sm, dl, static_cast<bf16*>(dqkv), part, L, H, scale);
  } else {
    if (!dl) return cudaErrorInvalidValue;
    static bool ready_q = false, ready_k = false;
    if ((e = allow_smem(attention_bwd_dq_f32_kernel<HD>, dq_f32_smem<HD>(), ready_q)) != cudaSuccess) return e;
    attention_bwd_dq_f32_kernel<HD><<<blocks, 256, dq_f32_smem<HD>(), st>>>(q, da, sm, dl, static_cast<float*>(dqkv),
                                                                             part, L, H, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = allow_smem(attention_bwd_dkdv_f32_kernel<HD>, dkdv_f32_smem<HD>(), ready_k)) != cudaSuccess) return e;
    attention_bwd_dkdv_f32_kernel<HD><<<blocks, 256, dkdv_f32_smem<HD>(), st>>>(
        q, da, sm, dl, static_cast<float*>(dqkv), part, L, H, scale);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t attention_bwd_info(int L, int* info) {
  if (L < 1) return cudaErrorInvalidValue;
  const BwdPlan p = plan_attention_bwd_bf16<HD>(L);
  if (p.err != cudaSuccess) return p.err;
  info[0] = p.nb;
  info[1] = p.threads;
  info[2] = p.rows;
  info[3] = (int)p.smem;
  return kernel_info(p.fn, p.threads, p.smem, info + 4);
}

}  // namespace

extern "C" {

// dW[K, N] (fp32) = a[M, K]^T . dy[M, N] (bf16 when bf16 else fp32), summed
// from `slabs` partials of `slab` rows each (partials: [slabs, K, N] fp32).
// bf16 needs K % 8 == N % 8 == 0, 16-byte aligned a and dy and slab % 64 ==
// 0, and takes 128 x 256 output tiles for N > 128, else 128 x 128
// (ops/fused_train.py::wgrad_plan sizes the slabs for them).
int cse_weight_grad(const void* a, const void* dy, void* partials, void* dw, int bf16_operands,
                    long long M, int K, int N, int slab, int slabs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (M < 1 || K < 1 || N < 1 || slab < 1 || slabs < 1) return (int)cudaErrorInvalidValue;
  if (bf16_operands) {
    if (K % 8 || N % 8 || slab % wg::BR) return (int)cudaErrorInvalidValue;
    const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap ta, tb;
    if (!tensor_map(&ta, BF, a, 2, K, M, 64, wg::BR) || !tensor_map(&tb, BF, dy, 2, N, M, 64, wg::BR))
      return (int)cudaErrorInvalidValue;
    const int NG = N > 128 ? 2 : 1;
    const int units = ((K + wg::BT - 1) / wg::BT) * ((N + 128 * NG - 1) / (128 * NG)) * slabs;
    const unsigned blocks = (unsigned)min(units, sm_count());
    static bool ready1 = false, ready2 = false;
    cudaError_t e;
    if (NG == 2) {
      if ((e = allow_smem(wgrad_bf16_kernel<2>, wg::smem<2>(), ready2)) != cudaSuccess) return (int)e;
      wgrad_bf16_kernel<2><<<blocks, WS_THREADS, wg::smem<2>(), st>>>(ta, tb, part, (int)M, K, N, slab, slabs);
    } else {
      if ((e = allow_smem(wgrad_bf16_kernel<1>, wg::smem<1>(), ready1)) != cudaSuccess) return (int)e;
      wgrad_bf16_kernel<1><<<blocks, WS_THREADS, wg::smem<1>(), st>>>(ta, tb, part, (int)M, K, N, slab, slabs);
    }
  } else {
    const int tiles = ((K + 63) / 64) * ((N + 63) / 64);
    wgrad_f32_kernel<<<tiles * slabs, 256, 0, st>>>(static_cast<const float*>(a), static_cast<const float*>(dy),
                                                    part, (int)M, K, N, slab);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_sum_rows(part, static_cast<float*>(dw), slabs, (long long)K * N, st);
}

// LayerNorm backward, see (b). g_in is bf16 when g_in_bf16 else fp32; g_out32
// (fp32, may alias an fp32 g_in) and g_out_cd (bf16 when out_bf16 else fp32)
// may each be null. partials: [blocks, 4, D] (ops/fused_train.py::ln_bwd_plan
// sizes the grid); sums: [4, D] = dscale, dbias, colsum(g_in), colsum(g_out).
int cse_layer_norm_bwd(const void* dh, const void* x, const void* scale, const void* g_in, void* g_out32,
                       void* g_out_cd, void* partials, void* sums, int g_in_bf16, int out_bf16,
                       long long M, int D, float eps, int blocks, void* stream) {
  if (D % 8 || D < 8 || D > LNB_MAXD || M < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {dh, x, g_in, g_out32, g_out_cd};
  const int path = lnb_path(D, aligned16(ptrs, 5));
  float* part = static_cast<float*>(partials);
  const cudaError_t e = by_lnb_dtypes(g_in_bf16, out_bf16, [&](auto tg, auto to) {
    return launch_lnb<decltype(tg), decltype(to)>(path, static_cast<const float*>(dh), static_cast<const float*>(x),
                                                  static_cast<const float*>(scale), g_in, static_cast<float*>(g_out32),
                                                  g_out_cd, part, M, D, eps, blocks, st);
  });
  if (e != cudaSuccess) return (int)e;
  return (int)launch_sum_rows(part, static_cast<float*>(sums), blocks, 4LL * D, st);
}

// info[7] of the LayerNorm backward cse_layer_norm_bwd launches for D and a
// dtype pairing, with every tensor 16-byte aligned when aligned else not: its
// path (LnbPath), threads, rows a block takes at a time, dynamic shared
// bytes, registers a thread, local-memory bytes a thread, resident blocks per
// SM.
int cse_layer_norm_bwd_info(int D, int g_in_bf16, int out_bf16, int aligned, int* info) {
  if (D % 8 || D > LNB_MAXD || D < 8) return (int)cudaErrorInvalidValue;
  const int path = lnb_path(D, aligned != 0);
  return (int)by_lnb_dtypes(g_in_bf16, out_bf16, [&](auto tg, auto to) {
    const LnbLaunch l = lnb_launch<decltype(tg), decltype(to)>(path, D);
    if (l.err != cudaSuccess) return l.err;
    info[0] = path;
    info[1] = LNB_THREADS;
    info[2] = LNB_WARPS;
    info[3] = (int)l.smem;
    return kernel_info(l.fn, LNB_THREADS, l.smem, info + 4);
  });
}

// Attention backward, see (c). dqkv: [G*L, 3*H*hd] (bf16 when bf16 else
// fp32), hd in {4, 8, 16, 32, 64}; delta: [G*L, H] fp32 scratch of the
// two-kernel routes (null on the bf16 strip route, L <= 256); partials:
// [G, 3*H*hd] on the strip route, else [G * ceil(L / 64), 3*H*hd]; dbias:
// [3*H*hd] fp32, the column sums of the fp32 dq | dk | dv.
int cse_attention_bwd(const void* qkv, const void* dattn, const void* stats, void* delta, void* dqkv,
                      void* partials, void* dbias, int bf16_out, int G, int L, int H, int hd, float scale,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  const float* da = static_cast<const float*>(dattn);
  const float* sm = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  float* part = static_cast<float*>(partials);
  const int e = by_head_width(HeadWidths{}, hd, [&](auto w) {
    return launch_attention_bwd<decltype(w)::value>(bf16_out, q, da, sm, dl, dqkv, part, G, L, H, scale, st);
  });
  if (e != (int)cudaSuccess) return e;
  return (int)launch_sum_rows(part, static_cast<float*>(dbias), bwd_partial_rows(bf16_out, G, L), 3LL * H * hd, st);
}

// info[7] of the bf16 attention backward cse_attention_bwd launches for (L,
// hd), in cse_attention_info's order: key blocks of the strip (0: the two
// kernels of 64-row tiles), threads, query rows a block, dynamic shared
// bytes, registers a thread, local-memory bytes a thread, resident blocks per
// SM (of the strip kernel, or of the dq kernel).
int cse_attention_bwd_info(int L, int hd, int* info) {
  return by_head_width(HeadWidths{}, hd, [&](auto w) { return attention_bwd_info<decltype(w)::value>(L, info); });
}

}  // extern "C"
