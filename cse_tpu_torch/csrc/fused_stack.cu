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
//       below). bf16 runs on the tensor
//       cores through mma.sync (128x128x32 tiles, a 4-stage cp.async ring,
//       ldmatrix) with the epilogue applied from registers; fp32 runs on
//       CUDA-core FMAs (64x64 tiles), never TF32. At M ~ 5e5 rows and
//       K, N <= 1024 the bytes bound it: the fp32 qkv write and the fp32
//       residual read-modify-write outweigh the operations.
//   (c) attention_*_kernel: one block per (sequence, head), head width 32.
//       K and V of the head go to shared memory in cd, in tiles of 256 keys.
//       Two passes over the keys: the first finds the row max, the second
//       computes p = exp(s-m), z = sum p and cd(p).cd(v) in fp32, divided by
//       z after PV -- the TPU kernel's arithmetic, with p rounded relative to
//       the row's global max (no online softmax), for any sequence length.
//       bf16 runs the score and PV products on the tensor cores (mma.sync)
//       with the scores in registers, recomputed in the second pass rather
//       than stored; fp32 runs them on CUDA-core FMAs. At the serving shapes
//       the fp32 qkv read (bytes) bounds it.
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
// (cd), and the fp32 column sums of that value over the block's rows written
// to colsum[blockIdx.x / nN][N] -- the bias gradient's per-block partials.
enum Epilogue { EPI_BIAS = 0, EPI_RELU = 1, EPI_RESIDUAL = 2, EPI_RELU_GRAD = 3 };

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int LDA_S = BK + 8;   // bf16 elements: 80-byte rows, ldmatrix conflict-free
constexpr int LDB_S = BN + 8;   // 272-byte rows, likewise
constexpr int A_STAGE = BM * LDA_S, B_STAGE = BK * LDB_S;
constexpr size_t LINEAR_BF16_SMEM = sizeof(bf16) * STAGES * (A_STAGE + B_STAGE);

// Store two neighbouring columns (c, c + 1) of one output row (bias and
// residual already added).
template <int EPI>
__device__ __forceinline__ void store2(float v0, float v1, long long idx, void* __restrict__ C) {
  if (EPI == EPI_RELU)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + idx) =
        __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  else if (EPI == EPI_RELU_GRAD)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + idx) = __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(C) + idx) = make_float2(v0, v1);
}

// bf16 x bf16 -> fp32 on the tensor cores (mma.sync m16n8k16, operands by
// ldmatrix from a 4-stage cp.async ring). 8 warps as 2 (M) x 4 (N), each
// 64 x 32 of the 128 x 128 tile. The epilogue works on the accumulators in
// registers: each thread owns column pairs, so a warp's store covers eight
// full 32-byte sectors. Requires K % 8 == 0, N % 8 == 0 and 16-byte aligned
// A and W (checked by the host wrapper).
template <int EPI>
__global__ void __launch_bounds__(256, 2)
linear_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                   const float* __restrict__ bias, void* __restrict__ C, int M, int N, int K,
                   const bf16* __restrict__ mask, float* __restrict__ colsum) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [STAGES][BM][LDA_S]
  bf16* Bs = As + STAGES * A_STAGE;          // [STAGES][BK][LDB_S]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nN = (N + BN - 1) / BN;
  const int bm = (blockIdx.x / nN) * BM, bn = (blockIdx.x % nN) * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load_tile = [&](int stage, int k0) {
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 chunks of 8
      const int c = tid + i * 256, r = c >> 2, kc = (c & 3) * 8;
      const int gr = bm + r, gk = k0 + kc;
      const bool p = gr < M && gk < K;
      cp_async16(as + r * LDA_S + kc, p ? A + (long long)gr * K + gk : A, p);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // W: 32 rows x 16 chunks of 8
      const int c = tid + i * 256, r = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + r, gn = bn + nc;
      const bool p = gk < K && gn < N;
      cp_async16(bs + r * LDB_S + nc, p ? W + (long long)gk * N + gn : W, p);
    }
  };

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {  // one commit group per stage, even if empty
    if (s < nk) load_tile(s, s * BK);
    cp_async_commit();
  }
  // lane's row (A) / k row (W) and 8-column offset for ldmatrix x4
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; stage (kt - 1) is free
    if (kt + STAGES - 1 < nk) load_tile((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], as + (wm + i * 16 + lr) * LDA_S + kk + lc);
      // bfr[j]: {b0, b1} of n8 tile 2j, then {b0, b1} of n8 tile 2j + 1
#pragma unroll
      for (int j = 0; j < 2; ++j) ldmatrix_x4_trans(bfr[j], bs + (kk + lr) * LDB_S + wn + j * 16 + lc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2], bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: {0, 1} at (lane / 4, 2 * (lane % 4) + {0, 1}), {2, 3}
  // eight rows down. Bias and residual go into the accumulators first, so
  // that every residual load is in flight before the first store.
  const int r0 = bm + wm + (lane >> 2), c0 = bn + wn + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + i * 16, c = c0 + j * 8;
      if (c >= N) continue;  // N % 8 == 0: c < N implies c + 1 < N
      const float b0 = bias[c], b1 = bias[c + 1];
      float2 x0 = make_float2(0.f, 0.f), x1 = x0;
      if (EPI == EPI_RESIDUAL) {
        const float* res = static_cast<const float*>(C);
        if (r < M) x0 = *reinterpret_cast<const float2*>(res + (long long)r * N + c);
        if (r + 8 < M) x1 = *reinterpret_cast<const float2*>(res + (long long)(r + 8) * N + c);
      }
      acc[i][j][0] = (acc[i][j][0] + b0) + x0.x;
      acc[i][j][1] = (acc[i][j][1] + b1) + x0.y;
      acc[i][j][2] = (acc[i][j][2] + b0) + x1.x;
      acc[i][j][3] = (acc[i][j][3] + b1) + x1.y;
      if (EPI == EPI_RELU_GRAD) {  // rows past M get mask 0, so they add nothing below
        float2 m0 = make_float2(0.f, 0.f), m1 = m0;
        if (r < M) m0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mask + (long long)r * N + c));
        if (r + 8 < M) m1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mask + (long long)(r + 8) * N + c));
        acc[i][j][0] = m0.x > 0.f ? acc[i][j][0] : 0.f;
        acc[i][j][1] = m0.y > 0.f ? acc[i][j][1] : 0.f;
        acc[i][j][2] = m1.x > 0.f ? acc[i][j][2] : 0.f;
        acc[i][j][3] = m1.y > 0.f ? acc[i][j][3] : 0.f;
      }
    }
  if (EPI == EPI_RELU_GRAD) {
    // column sums of this block's 128 rows: over the thread's 8 rows, over
    // the 8 lanes that share a column (lane / 4), then over the 2 warps in M
    float cs[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) t += acc[i][j][e] + acc[i][j][2 + e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) t += __shfl_xor_sync(FULL, t, o);
        cs[j][e] = t;
      }
    __syncthreads();  // every warp is done reading the operand ring
    float* red = reinterpret_cast<float*>(smem);  // [2][BN]
    if (lane < 4)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[(warp >> 2) * BN + wn + j * 8 + lane * 2] = cs[j][0];
        red[(warp >> 2) * BN + wn + j * 8 + lane * 2 + 1] = cs[j][1];
      }
    __syncthreads();
    if (tid < BN && bn + tid < N) colsum[(long long)(blockIdx.x / nN) * N + bn + tid] = red[tid] + red[BN + tid];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + i * 16, c = c0 + j * 8;
      if (c >= N) continue;
      if (r < M) store2<EPI>(acc[i][j][0], acc[i][j][1], (long long)r * N + c, C);
      if (r + 8 < M) store2<EPI>(acc[i][j][2], acc[i][j][3], (long long)(r + 8) * N + c, C);
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
// Both kernels: block b handles sequence b / H, head b % H of qkv [G*L, 3*D]
// fp32 (q | k | v, head h at columns h*HD of each third) and writes
// out [G*L, D] in cd. Two passes over the keys in tiles of KT; keys past L
// are zero in shared memory and masked (p = 0). With ``stats`` (training's
// replay; serving passes null) each row's max m and 1/z go to stats[0][row][h]
// and stats[1][row][h] ([2, G*L, H] fp32) for the backward to recompute p.
constexpr int HD = 32;                  // head width
constexpr int KT = 256;                 // keys per shared-memory tile

// fp32 (the parity path): CUDA-core FMAs, one warp per query row, lane j
// scores key c + j and owns output column j.
constexpr int QT32 = 128;               // query rows per tile
constexpr int ROWS32 = QT32 / 8;        // query rows per warp per tile
constexpr int LDK32 = HD + 1;           // 33-word K rows: conflict-free
constexpr size_t ATT_F32_SMEM = sizeof(float) * (KT * LDK32 + KT * HD + QT32 * HD);

__global__ void __launch_bounds__(256)
attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int L, int H,
                     float scale, float* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [KT][LDK32]
  float* Vs = Ks + KT * LDK32;                 // [KT][HD]
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
      Ks[r * LDK32 + d] = key < L ? row[D] : 0.f;
      Vs[r * HD + d] = key < L ? row[2 * D] : 0.f;
    }
  };
  auto score = [&](const float* q, int key) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(q[d], Ks[key * LDK32 + d], s);
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

    float m[ROWS32], z[ROWS32], acc[ROWS32];
#pragma unroll
    for (int r = 0; r < ROWS32; ++r) {
      m[r] = __int_as_float(0xff800000);  // -inf
      z[r] = 0.f;
      acc[r] = 0.f;
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
          for (int j = 0; j < 32; ++j)
            acc[r] = fmaf(__shfl_sync(FULL, p, j), Vs[(c + j) * HD + lane], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS32; ++r) {
      const int qr = warp + r * 8;
      const float zr = warp_sum(z[r]);
      if (q0 + qr >= L) continue;
      const long long row = (long long)g * L + q0 + qr;
      out[row * D + h * HD + lane] = acc[r] / zr;
      if (stats && lane == 0) {
        const long long MH = (long long)(gridDim.x / H) * L * H;
        stats[row * H + h] = m[r];
        stats[MH + row * H + h] = 1.f / zr;
      }
    }
  }
}

// bf16: score and PV products on the tensor cores (mma.sync m16n8k16, fp32
// accumulate), with the scores kept in registers. 4 warps; each warp owns 16
// query rows at a time, with q*scale rounded to bf16 in A fragments. K and V
// of up to KT keys sit in shared memory in bf16. Keys go 16 at a time: pass 1
// takes the row max over all keys; pass 2 recomputes the scores, forms
// p = exp(s - m) (z summed from the unrounded p), and feeds bf16(p) straight
// from the score fragments into the PV product as its A operand. For L > KT
// both passes walk the key tiles, so p is rounded relative to the row's
// global max.
// The output is bf16, or fp32 (TO = float: the w8a8 stack, whose attention
// output is quantized again from fp32).
constexpr int ATT_WARPS = 4;
constexpr int LDH = HD + 8;             // bf16 row stride of the K, V tiles: ldmatrix conflict-free

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename TO>
__global__ void __launch_bounds__(ATT_WARPS * 32, 4)
attention_bf16_kernel(const float* __restrict__ qkv, TO* __restrict__ out, int L, int H,
                      float scale, int kt_rows, float* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kt_rows][LDH]
  bf16* Vs = Ks + kt_rows * LDH;             // [kt_rows][LDH]

  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * HD, D3 = 3 * D;
  const float* base = qkv + (long long)g * L * D3 + h * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkt = (L + KT - 1) / KT;
  const float NEG_INF = __int_as_float(0xff800000);

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
      *reinterpret_cast<uint2*>(Ks + r * LDH + c) = make_uint2(pack_bf16(k.x, k.y), pack_bf16(k.z, k.w));
      if (with_v)
        *reinterpret_cast<uint2*>(Vs + r * LDH + c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  };
  // s[j] = q . k for the 16 keys kb .. kb + 15 of the tile (n8 tiles j = 0, 1)
  auto scores16 = [&](float (&s)[2][4], const unsigned (&qa)[2][4], int kb) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // head width 32 = 2 k-steps
      unsigned kf[4];  // {b0, b1} of keys kb .. kb + 7, then of kb + 8 .. kb + 15
      ldmatrix_x4(kf, Ks + (kb + (lane & 7) + ((lane >> 4) << 3)) * LDH + ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[0], qa[ks], kf[0], kf[1]);
      mma_bf16_16816(s[1], qa[ks], kf[2], kf[3]);
    }
  };

  if (nkt == 1) {
    load_kv(0, true);
    __syncthreads();
  }
  for (int q0 = 0; q0 < L; q0 += ATT_WARPS * 16) {
    // this warp's rows: ra (fragment elements 0, 1) and ra + 8 (elements 2, 3)
    const int ra = q0 + warp * 16 + (lane >> 2), rb = ra + 8;
    const bool active = q0 + warp * 16 < L;  // warp-uniform
    unsigned qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {  // A fragment: {rows ra, rb} x {d, d + 8}
        const int d = ks * 16 + hi * 8 + (lane & 3) * 2;
        float2 xa = make_float2(0.f, 0.f), xb = xa;
        if (ra < L) xa = *reinterpret_cast<const float2*>(base + (long long)ra * D3 + d);
        if (rb < L) xb = *reinterpret_cast<const float2*>(base + (long long)rb * D3 + d);
        // q * scale rounded to bf16, as the TPU kernel does before the score dot
        qa[ks][hi * 2] = pack_bf16(xa.x * scale, xa.y * scale);
        qa[ks][hi * 2 + 1] = pack_bf16(xb.x * scale, xb.y * scale);
      }

    // pass 1: the row max over all keys
    float ma = NEG_INF, mb = NEG_INF;
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
        scores16(s, qa, kb);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kb + j * 8 + (lane & 3) * 2 + e < nk) {
              ma = fmaxf(ma, s[j][e]);
              mb = fmaxf(mb, s[j][2 + e]);
            }
      }
    }
    // the four lanes of a quad share a row
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, o));
      mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, o));
    }

    // pass 2: p, z and O = bf16(p) . V
    float za = 0.f, zb = 0.f, o[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
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
        scores16(s, qa, kb);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = kb + j * 8 + (lane & 3) * 2 + e < nk;
            s[j][e] = valid ? expf(s[j][e] - ma) : 0.f;
            s[j][2 + e] = valid ? expf(s[j][2 + e] - mb) : 0.f;
            za += s[j][e];
            zb += s[j][2 + e];
          }
        // the score fragments of keys kb .. kb + 15 are the A fragment of this k-step
        const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {  // output columns dp * 16 .. dp * 16 + 15
          unsigned vf[4];
          ldmatrix_x4_trans(vf, Vs + (kb + (lane & 15)) * LDH + dp * 16 + (lane >> 4) * 8);
          mma_bf16_16816(o[dp * 2], pa, vf[0], vf[1]);
          mma_bf16_16816(o[dp * 2 + 1], pa, vf[2], vf[3]);
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      za += __shfl_xor_sync(FULL, za, off);
      zb += __shfl_xor_sync(FULL, zb, off);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = h * HD + j * 8 + (lane & 3) * 2;
      if (ra < L) store_pair(out + ((long long)g * L + ra) * D + d, o[j][0] / za, o[j][1] / za);
      if (rb < L) store_pair(out + ((long long)g * L + rb) * D + d, o[j][2] / zb, o[j][3] / zb);
    }
    if (stats && (lane & 3) == 0) {
      const long long MH = (long long)(gridDim.x / H) * L * H;
      if (ra < L) {
        stats[((long long)g * L + ra) * H + h] = ma;
        stats[MH + ((long long)g * L + ra) * H + h] = 1.f / za;
      }
      if (rb < L) {
        stats[((long long)g * L + rb) * H + h] = mb;
        stats[MH + ((long long)g * L + rb) * H + h] = 1.f / zb;
      }
    }
  }
}

// mode 0: fp32 operands and output; 1: bf16 operands and output; 2: bf16
// operands, fp32 output
cudaError_t launch_attention(int mode, const float* qkv, void* out, int G, int L, int H, float scale,
                             float* stats, cudaStream_t st) {
  static bool f32_ready = false;
  cudaError_t e;
  if (mode == 1 || mode == 2) {
    // K and V rows for min(L, KT) keys, rounded up to whole 16-key steps: <= 40 KB
    const int kt_rows = (min(L, KT) + 15) / 16 * 16;
    const size_t bytes = sizeof(bf16) * 2 * kt_rows * LDH;
    if (mode == 1)
      attention_bf16_kernel<bf16><<<G * H, ATT_WARPS * 32, bytes, st>>>(qkv, static_cast<bf16*>(out), L, H,
                                                                        scale, kt_rows, stats);
    else
      attention_bf16_kernel<float><<<G * H, ATT_WARPS * 32, bytes, st>>>(qkv, static_cast<float*>(out), L, H,
                                                                         scale, kt_rows, stats);
  } else if (mode == 0) {
    if ((e = allow_smem(attention_f32_kernel, ATT_F32_SMEM, f32_ready)) != cudaSuccess) return e;
    attention_f32_kernel<<<G * H, 256, ATT_F32_SMEM, st>>>(qkv, static_cast<float*>(out), L, H, scale, stats);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_linear(int bf, const void* a, const void* w, const float* bias, void* c,
                          int M, int N, int K, cudaStream_t st, const void* mask = nullptr,
                          float* colsum = nullptr) {
  if (bf) {
    static bool ready = false;
    const cudaError_t e = allow_smem(linear_bf16_kernel<EPI>, LINEAR_BF16_SMEM, ready);
    if (e != cudaSuccess) return e;
    const long long blocks = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    linear_bf16_kernel<EPI><<<(unsigned)blocks, 256, LINEAR_BF16_SMEM, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w), bias, c, M, N, K,
        static_cast<const bf16*>(mask), colsum);
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
// 2: c fp32 += acc + bias.
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

// out[G*L, H*hd] = masked MHSA of qkv[G*L, 3*H*hd]; mode: see launch_attention
// (0: fp32, 1: bf16, 2: bf16 operands with an fp32 out); stats (null, or
// [2, G*L, H] fp32) receives each row's max and 1/z.
int cse_attention(const void* qkv, void* out, int mode, int G, int L, int H, int hd,
                  float scale, void* stats, void* stream) {
  if (hd != HD) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  return (int)launch_attention(mode, q, out, G, L, H, scale, static_cast<float*>(stats), st);
}

// Training's dX GEMM through the FFN's ReLU: out (a's dtype) =
// where(mask > 0, a[M, K] . w[K, N] + bias, 0); colsum[N] (fp32) = the column
// sums of that value, reduced in a fixed order from per-block partials
// (partials: ceil(M / 128) rows for bf16, ceil(M / 64) for fp32, times N).
int cse_linear_relu_grad(const void* a, const void* w, const void* bias, const void* mask, void* out,
                         void* partials, void* colsum, int bf16_operands, long long M, int N, int K,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  cudaError_t e = launch_linear<EPI_RELU_GRAD>(bf16_operands, a, w, static_cast<const float*>(bias), out,
                                               (int)M, N, K, st, mask, part);
  if (e != cudaSuccess) return (int)e;
  const int rows = (int)((M + (bf16_operands ? BM : 64) - 1) / (bf16_operands ? BM : 64));
  return (int)launch_sum_rows(part, static_cast<float*>(colsum), rows, N, st);
}

}  // extern "C"
