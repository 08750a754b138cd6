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
//       A^T dY reduced over M ~ 5e5 rows, split into slabs of rows so that
//       ~528 blocks fill the card; sum_rows adds the slabs. bf16 runs on the
//       tensor cores (mma.sync m16n8k16, A^T fragments by ldmatrix.trans,
//       128 x 128 output tiles, a 4-stage cp.async ring); fp32 on CUDA-core
//       FMAs. Bound by operations at K, N >= 256 (2*M*K*N flops over
//       (K + N)*M*2 bytes read).
//   (b) layer_norm_bwd_kernel: one warp per row; recomputes xhat and 1/std
//       from the fp32 LN input, forms dx = inv*(dxhat - mean(dxhat) -
//       xhat*mean(dxhat*xhat)), adds it to the residual gradient
//       (g_out = g_in + dx, fp32 and/or cd) and writes per-block partials of
//       dscale, dbias and the column sums of g_in and g_out (the two
//       residual-branch bias gradients). Bound by bytes.
//   (c) attention_bwd_dq_*_kernel and attention_bwd_dkdv_*_kernel: one block
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
//       Head width HD in {8, 16, 32, 64} (a template argument; common.cuh's
//       fragments zero-pad a half k-step). Bound by bytes at head width 32
//       (fp32 qkv and dattn in, cd dqkv out).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- (a) weight gradient
constexpr int WM = 128, WN = 128, WK = 32, WSTAGES = 4;  // out tile (K x N) and rows per step
constexpr int LDW = WM + 8;                              // bf16 row stride: ldmatrix conflict-free
constexpr int W_STAGE = WK * LDW;
constexpr size_t WGRAD_BF16_SMEM = sizeof(bf16) * WSTAGES * 2 * W_STAGE;

// P[s][K][N] (fp32) = sum over rows m in [s*slab, (s+1)*slab) of A[m][k] * B[m][n]
// for bf16 A [M, K], B [M, N]. 8 warps as 2 (K) x 4 (N), each 64 x 32 of the
// 128 x 128 tile. The block's slab rows go through shared memory 32 at a time
// as A[m][k] and B[m][n]; ldmatrix.trans of A gives the A^T fragment.
__global__ void __launch_bounds__(256, 2)
wgrad_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ P,
                  int M, int K, int N, int slab) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [WSTAGES][WK][LDW]
  bf16* Bs = As + WSTAGES * W_STAGE;         // [WSTAGES][WK][LDW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nN = (N + WN - 1) / WN, nK = (K + WM - 1) / WM;
  const int tile = blockIdx.x % (nK * nN), s = blockIdx.x / (nK * nN);
  const int bk = (tile / nN) * WM, bn = (tile % nN) * WN;
  const int m_lo = s * slab, m_hi = min(M, m_lo + slab);
  const int wk = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int stage, int m0) {
    bf16* as = As + stage * W_STAGE;
    bf16* bs = Bs + stage * W_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 32 rows x 16 chunks of 8, for A and for B
      const int c = tid + i * 256, r = c >> 4, cc = (c & 15) * 8;
      const int gm = m0 + r;
      const bool pa = gm < m_hi && bk + cc < K, pb = gm < m_hi && bn + cc < N;
      cp_async16(as + r * LDW + cc, pa ? A + (long long)gm * K + bk + cc : A, pa);
      cp_async16(bs + r * LDW + cc, pb ? B + (long long)gm * N + bn + cc : B, pb);
    }
  };

  const int nsteps = (m_hi - m_lo + WK - 1) / WK;
#pragma unroll
  for (int st = 0; st < WSTAGES - 1; ++st) {
    if (st < nsteps) load(st, m_lo + st * WK);
    cp_async_commit();
  }
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  // A^T fragment by ldmatrix.trans: matrix i = lane / 8 covers rows m
  // (i / 2) * 8 .. +7 and columns k (i % 2) * 8 .. +7 of the stored A[m][k]
  const int ar = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) * 8;
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();
    if (t + WSTAGES - 1 < nsteps) load((t + WSTAGES - 1) % WSTAGES, m_lo + (t + WSTAGES - 1) * WK);
    cp_async_commit();
    const bf16* as = As + (t % WSTAGES) * W_STAGE;
    const bf16* bs = Bs + (t % WSTAGES) * W_STAGE;
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4_trans(af[i], as + (kk + ar) * LDW + wk + i * 16 + ac);
#pragma unroll
      for (int j = 0; j < 2; ++j) ldmatrix_x4_trans(bfr[j], bs + (kk + lr) * LDW + wn + j * 16 + lc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2], bfr[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  float* out = P + (long long)s * K * N;
  const int r0 = bk + wk + (lane >> 2), c0 = bn + wn + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + i * 16, c = c0 + j * 8;
      if (c >= N) continue;
      if (r < K) *reinterpret_cast<float2*>(out + (long long)r * N + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < K)
        *reinterpret_cast<float2*>(out + (long long)(r + 8) * N + c) = make_float2(acc[i][j][2], acc[i][j][3]);
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
constexpr int LNB_MAXD = 256;  // columns per row (D % 32 == 0, D <= 256)

// One warp per row (grid-strided, 8 warps per block). dh: grad of the LN
// output (fp32); x: the LN input (fp32); scale: LN scale (fp32). g_out32 may
// alias g_in (fp32). part[blockIdx.x][4][D]: sums over the block's rows of
// dh * xhat, dh, g_in, g_out.
template <typename TG, typename TO>
__global__ void __launch_bounds__(256)
layer_norm_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ x,
                      const float* __restrict__ scale, const TG* g_in, float* g_out32,
                      TO* __restrict__ g_out_cd, float* __restrict__ part, long long M, int D,
                      float eps) {
  constexpr int NPL = LNB_MAXD / 32;
  __shared__ float red[8][4][LNB_MAXD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ps[NPL], pb[NPL], pgi[NPL], pgo[NPL], sc[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    ps[j] = pb[j] = pgi[j] = pgo[j] = 0.f;
    sc[j] = lane + 32 * j < D ? scale[lane + 32 * j] : 0.f;
  }
  for (long long row = (long long)blockIdx.x * 8 + warp; row < M; row += (long long)gridDim.x * 8) {
    const long long o = row * D;
    float xv[NPL], dy[NPL];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int c = lane + 32 * j;
      xv[j] = c < D ? x[o + c] : 0.f;
      dy[j] = c < D ? dh[o + c] : 0.f;
      s += xv[j];
    }
    const float mean = warp_sum(s) / D;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const float d = lane + 32 * j < D ? xv[j] - mean : 0.f;
      v += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(v) / D + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      xv[j] = (xv[j] - mean) * inv;  // xhat
      const float dxh = dy[j] * sc[j];
      s1 += dxh;
      s2 += dxh * xv[j];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int c = lane + 32 * j;
      if (c >= D) continue;
      const float dx = inv * (dy[j] * sc[j] - m1 - xv[j] * m2);
      const float gi = to_f(g_in[o + c]);
      const float go = gi + dx;
      if (g_out32) g_out32[o + c] = go;
      if (g_out_cd) g_out_cd[o + c] = from_f<TO>(go);
      ps[j] += dy[j] * xv[j];
      pb[j] += dy[j];
      pgi[j] += gi;
      pgo[j] += go;
    }
  }
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c >= D) continue;
    red[warp][0][c] = ps[j];
    red[warp][1][c] = pb[j];
    red[warp][2][c] = pgi[j];
    red[warp][3][c] = pgo[j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 4 * D; e += 256) {
    const int q = e / D, c = e % D;
    float t = red[0][q][c];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += red[w][q][c];
    part[((long long)blockIdx.x * 4 + q) * D + c] = t;
  }
}

// ---------------------------------------------------------------- (c) attention backward
// Head width HD (8, 16, 32, 64) is a template argument throughout.
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
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(dqkv + ((long long)g * L + ra) * D3 + h * HD + d) =
          __floats2bfloat162_rn(v[0], v[1]);
    if (rb < L)
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
      if (ka_ < L)
        *reinterpret_cast<__nv_bfloat162*>(dqkv + ((long long)g * L + ka_) * D3 + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      if (kb_ < L)
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

template <int HD>
cudaError_t launch_attention_bwd(int bf, const float* q, const float* da, const float* sm, float* dl, void* dqkv,
                                 float* part, int G, int L, int H, float scale, cudaStream_t st) {
  const int ntile = (L + RT - 1) / RT;
  const unsigned blocks = (unsigned)(G * H * ntile);
  cudaError_t e;
  if (bf) {
    static bool ready_q = false, ready_k = false;
    const int kt_rows = (min(L, KT) + 15) / 16 * 16;
    if ((e = allow_smem(attention_bwd_dq_bf16_kernel<HD>, sizeof(bf16) * 2 * KT * Head<HD>::LD, ready_q)) !=
        cudaSuccess)
      return e;
    attention_bwd_dq_bf16_kernel<HD><<<blocks, 128, sizeof(bf16) * 2 * kt_rows * Head<HD>::LD, st>>>(
        q, da, sm, dl, static_cast<bf16*>(dqkv), part, L, H, scale, kt_rows);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = allow_smem(attention_bwd_dkdv_bf16_kernel<HD>, dkdv_bf16_smem<HD>(), ready_k)) != cudaSuccess) return e;
    attention_bwd_dkdv_bf16_kernel<HD><<<blocks, 128, dkdv_bf16_smem<HD>(), st>>>(
        q, da, sm, dl, static_cast<bf16*>(dqkv), part, L, H, scale);
  } else {
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

}  // namespace

extern "C" {

// dW[K, N] (fp32) = a[M, K]^T . dy[M, N] (bf16 when bf16 else fp32), summed
// from `slabs` partials of `slab` rows each (partials: [slabs, K, N] fp32).
int cse_weight_grad(const void* a, const void* dy, void* partials, void* dw, int bf16_operands,
                    long long M, int K, int N, int slab, int slabs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (bf16_operands) {
    static bool ready = false;
    const cudaError_t e = allow_smem(wgrad_bf16_kernel, WGRAD_BF16_SMEM, ready);
    if (e != cudaSuccess) return (int)e;
    const int tiles = ((K + WM - 1) / WM) * ((N + WN - 1) / WN);
    wgrad_bf16_kernel<<<tiles * slabs, 256, WGRAD_BF16_SMEM, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(dy), part, (int)M, K, N, slab);
  } else {
    const int tiles = ((K + 63) / 64) * ((N + 63) / 64);
    wgrad_f32_kernel<<<tiles * slabs, 256, 0, st>>>(static_cast<const float*>(a), static_cast<const float*>(dy),
                                                    part, (int)M, K, N, slab);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_sum_rows(part, static_cast<float*>(dw), slabs, (long long)K * N, st);
}

// LayerNorm backward, see layer_norm_bwd_kernel. g_in is bf16 when g_in_bf16
// else fp32; g_out32 (fp32, may alias an fp32 g_in) and g_out_cd (bf16 when
// out_bf16 else fp32) may each be null. partials: [blocks, 4, D];
// sums: [4, D] = dscale, dbias, colsum(g_in), colsum(g_out).
int cse_layer_norm_bwd(const void* dh, const void* x, const void* scale, const void* g_in, void* g_out32,
                       void* g_out_cd, void* partials, void* sums, int g_in_bf16, int out_bf16,
                       long long M, int D, float eps, int blocks, void* stream) {
  if (D % 32 || D > LNB_MAXD) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dhf = static_cast<const float*>(dh);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  float* go = static_cast<float*>(g_out32);
  float* part = static_cast<float*>(partials);
#define CSE_LNB(TG, TO)                                                                              \
  layer_norm_bwd_kernel<TG, TO><<<blocks, 256, 0, st>>>(dhf, xf, sf, static_cast<const TG*>(g_in), go, \
                                                        static_cast<TO*>(g_out_cd), part, M, D, eps)
  if (g_in_bf16 && out_bf16) CSE_LNB(bf16, bf16);
  else if (g_in_bf16) CSE_LNB(bf16, float);
  else if (out_bf16) CSE_LNB(float, bf16);
  else CSE_LNB(float, float);
#undef CSE_LNB
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_sum_rows(part, static_cast<float*>(sums), blocks, 4LL * D, st);
}

// Attention backward, see (c). dqkv: [G*L, 3*H*hd] (bf16 when bf16 else
// fp32), hd in {8, 16, 32, 64}; delta: [G*L, H] fp32 scratch; partials:
// [G * ceil(L / 64), 3*H*hd]; dbias: [3*H*hd] fp32, the column sums of the
// fp32 dq | dk | dv.
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
  return (int)launch_sum_rows(part, static_cast<float*>(dbias), G * ((L + RT - 1) / RT), 3LL * H * hd, st);
}

}  // extern "C"
