// Hopper (sm_90a) port of scripts/bench_kernel_parts.py::make_kernel, the
// dev tool that asks where a fused layer's time goes: a stripped pre-LN
// transformer forward (LayerNorm without scale and bias, bias-free qkv / FFN
// products, softmax without a key mask, no out-projection, no final LN) in
// eight modes that move the row mean, mean-square and softmax sum from
// cross-lane reductions onto matrix products with a ones matrix J [D, 128].
//
// The TPU body keeps one [Lp, D] sequence and all weights in VMEM for both
// layers. On Hopper the layer runs as the HBM-resident decomposition of
// fused_stack.cu (LN -> GEMM -> attention -> LN -> GEMM -> GEMM on the fp32
// residual in device memory). The three products per layer are
// fused_stack.cu's GEMM; this file holds the two parts that kernel set does
// not compute:
//
//   (a) kp_ln_*: LayerNorm without scale and bias, out = (x - mu) * rsqrt(var
//       + eps), written in the compute dtype cd, with the moments by mode:
//         LN_NONE     no LN: the cast to cd only (matmul_only);
//         LN_CENTRED  mu = mean(x), var = mean((x - mu)^2), warp reductions;
//         LN_CD       mu = (cd(x) . J)[:, 0], m2 = (cd(x*x) . J)[:, 0],
//                     var = m2 - mu^2: for bf16 on the tensor cores
//                     (mma.sync m16n8k16, a warp per 16 rows, the x tile as
//                     the A operand and J's first eight columns as B);
//         LN_EXACT    the same sums with fp32 operands, fp32-exact;
//         LN_X2       the same with a cd hi + lo pair: v = hi + lo, hi =
//                     cd(v), lo = cd(v - hi), two products summed.
//       For cd = fp32 the rounding to cd is the identity (lo = 0), so the
//       three J modes share the fp32 path. bf16 LN_CD, LN_X2 and LN_EXACT
//       run kp_ln_staged_kernel (persistent, x staged once through a ring of
//       bulk copies; its design below), the rest a warp a row.
//   (b) kp_attention_*: one block per (sequence, head), head width 8, 16,
//       32 or 64 (a template argument), over qkv [G*L, 3D] fp32. q is scaled BEFORE the score product (the
//       serving kernel of fused_stack.cu scales and rounds alike; the fp32
//       twin multiplies in fp32). No mask. The softmax by mode:
//         SM_SKIP  p = s * 1e-4, no max / exp / sum;
//         SM_SUM   m = max s, p = exp(s - m), z = sum p in fp32 (also the
//                  tool's 'true ones matrix at HIGHEST precision'), p / z;
//         SM_CD    z = (cd(p) . J)[:, 0], which is sum(p) / D for the tool's
//                  J = 1/D (its output is D x the softmax: the tool's own
//                  arithmetic, reproduced as it is), p / z; needs L == rows
//                  of J, as the tool's product does;
//         SM_X2    z = (hi(p) . J + lo(p) . J)[:, 0], p * (1 / z).
//       The normalised p is rounded to cd BEFORE the PV product (the serving
//       kernel divides after it), so z must be known first. bf16 runs the
//       score, sum and PV products on the tensor cores with bf16(q * scale)
//       and bf16(k) operands; fp32 runs CUDA-core FMAs, never TF32. The head
//       outputs are added into the fp32 residual x in place (the tool's
//       concatenate and x + attn). The bf16 kernel is routed by L:
//         L <= 256, kp_attention_strip_bf16_kernel: q, k and v (and J's
//           first eight columns, transposed) of all rows converted to bf16
//           in shared memory once per block, each row's fp32 head slice
//           read once, coalesced, many reads in flight (common.cuh's
//           stage_qkv_bf16, shared with fused_stack.cu's attention); a warp owns 16
//           queries and keeps their scores against every key in registers
//           (s[NB][2][4], NB = 8 or 16 blocks of 16 keys, 64 or 128 fp32
//           registers a thread; the kernel 186-242 at NB 16, no local
//           memory): one product, one exponential per score, z by the mode
//           from the resident p (shuffles, or mma.sync with p as the A
//           operand), one normalisation, PV into a shared-memory tile that
//           the block adds into x at the end. p = 2^(s log2(e) - m log2(e))
//           in one FMA and one ex2, and p * (1 / z): against the tool's expf
//           and divisions it holds the same tolerances and is faster
//           (PERF.md).
//         L > 256, kp_attention_bf16_kernel: keys in tiles of 256 and three
//           passes over them (max; sum; PV), the scores recomputed in each.
//       Bound on the H100 at the tool's shape (G = 1008, Lp = 256, 8 heads):
//       the fp32 qkv read and the residual's read and write, 1.32 GB =
//       0.394 ms at 3.35 TB/s, against 0.13 TFLOP on the tensor cores. A
//       block stages its rows before any strip can start, and at 186-242
//       registers a thread two blocks share an SM, so loading and computing
//       overlap only across those two blocks.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

enum LnMode { LN_NONE = 0, LN_CENTRED = 1, LN_CD = 2, LN_EXACT = 3, LN_X2 = 4 };
enum SmMode { SM_SKIP = 0, SM_SUM = 1, SM_CD = 2, SM_X2 = 4 };

// ---------------------------------------------------------------- (a) LN
// One warp per row. MODE LN_NONE, LN_CENTRED, or, for cd = fp32, LN_EXACT
// (moments as sum_k v_k * J[k, 0] in fp32, which is also LN_CD and LN_X2
// there; the bf16 J modes take the staged kernel below).
template <int MODE, typename TO, typename TJ>
__global__ void __launch_bounds__(256)
kp_ln_rows_kernel(const float* __restrict__ x, const TJ* __restrict__ J, int ldj,
                  TO* __restrict__ out, long long M, int D, float eps) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + row * D;
  TO* orow = out + row * D;
  if (MODE == LN_NONE) {
    for (int i = lane; i < D; i += 32) orow[i] = from_f<TO>(xr[i]);
    return;
  }
  float mean, var;
  if (MODE == LN_CENTRED) {
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s += xr[i];
    mean = warp_sum(s) / D;
    float v = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float d = xr[i] - mean;
      v += d * d;
    }
    var = warp_sum(v) / D;
  } else {
    float s = 0.f, s2 = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float v = xr[i], j = to_f(J[(long long)i * ldj]);
      s = fmaf(v, j, s);
      s2 = fmaf(__fmul_rn(v, v), j, s2);
    }
    mean = warp_sum(s);
    var = warp_sum(s2) - mean * mean;
  }
  const float rstd = 1.0f / sqrtf(var + eps);
  for (int i = lane; i < D; i += 32) orow[i] = from_f<TO>((xr[i] - mean) * rstd);
}

// bf16, LN_CD, LN_X2 and LN_EXACT on staged rows. The work is bound by bytes
// (x fp32 in, out bf16 out: 6 bytes an element), so x crosses device memory
// once and the block keeps tiles of it in flight:
//   - persistent: blocks of KPLN_THREADS threads, as many as fit the card at
//     once, take tiles of ROWS consecutive rows (tile t: blockIdx.x, +
//     gridDim.x, ...) through a ring of KPLN_STAGES stages in shared memory;
//     warp 0 stages a tile with one bulk copy a row (its lanes start them,
//     lane 0 announces the bytes on the stage's mbarrier) under an L2
//     evict-first policy, KPLN_STAGES - 1 tiles ahead of the block;
//   - the staged rows are padded by KPLN_PAD bytes: the mma fragments' float2
//     reads of 8 rows then fall on distinct banks in each half warp (rows of
//     D fp32 alone are a multiple of 128 bytes apart and would collide);
//   - J is read once a block: for LN_CD and LN_X2 its first eight columns
//     become the B fragments in registers (2 a k-step: 32 at D 256); for
//     LN_EXACT its column 0 is staged in shared memory as fp32;
//   - the moments: LN_CD and LN_X2 on the tensor cores as before, warp w <
//     ROWS / 16 for rows 16 w .. 16 w + 15 (mma.sync m16n8k16, the x tile,
//     and for X2 its bf16 remainder, as the A operand; column 0 of the
//     product is the sum); LN_EXACT by every warp, ROWS / 8 rows each, two
//     at a time, with fp32 FMAs against J's column, lane l over columns l, l
//     + 32, ... and a warp sum: the products, their order and so the bits of
//     the earlier kernels; the rows' mean and 1 / std meet in shared memory;
//   - every warp forms ROWS / 8 rows of the output from the staged tile and
//     stores them 16 bytes (8 columns) a lane, with the streaming hint.
// D % 16 == 0 and D <= 1024; a tile is 32 rows (16 for D > 512): at D 256
// two blocks of 8 warps share an SM, so one block's moments overlap the
// other's output. (Tiles of 64 rows, one block an SM, and of 16 rows ran
// slower in turns on an NVIDIA H100 80GB HBM3 at 700 W: PERF.md.)
constexpr int KPLN_STAGES = 3;
constexpr int KPLN_PAD = 32;  // bytes after each staged row
constexpr int KPLN_MAXD = 1024;
constexpr int KPLN_THREADS = 256, KPLN_WARPS = KPLN_THREADS / 32;

template <int KMAX>  // k-steps of 16 columns: D <= 16 KMAX
struct KpLnTile {
  static constexpr int ROWS = KMAX == 64 ? 16 : 32;
  static constexpr int MMA_WARPS = ROWS / 16;  // the warps that take the moments on the tensor cores
  static constexpr int RPW = ROWS / KPLN_WARPS;  // rows of a warp's exact moments and output
};

inline size_t kpln_smem(int rows, int D) {
  return (size_t)KPLN_STAGES * rows * (D * 4 + KPLN_PAD) + (size_t)D * 4;
}

template <int MODE, int KMAX>
__global__ void __launch_bounds__(KPLN_THREADS)
kp_ln_staged_kernel(const float* __restrict__ x, const bf16* __restrict__ J, int ldj, bf16* __restrict__ out,
                    long long M, int D, float eps) {
  using T = KpLnTile<KMAX>;
  extern __shared__ __align__(128) float kpln_ring[];
  __shared__ __align__(8) uint64_t full[KPLN_STAGES];
  __shared__ float stat[T::ROWS][2];  // the tile's rows: mean, 1 / std
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = D + KPLN_PAD / 4;  // floats from one staged row to the next
  float* const ring = kpln_ring;
  uint64_t* const fullb = full;
  float* jcol = ring + (size_t)KPLN_STAGES * T::ROWS * stride;
  const long long tiles = (M + T::ROWS - 1) / T::ROWS;
  const uint64_t policy = l2_evict_first();
  auto load_tile = [&](long long t, int s) {  // warp 0: tile t into stage s
    const long long r0 = t * T::ROWS;
    const int rows = (int)min((long long)T::ROWS, M - r0);
    if (lane == 0) mbar_expect_tx(fullb + s, (unsigned)(rows * D * 4));
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_load(ring + ((size_t)s * T::ROWS + r) * stride, x + (r0 + r) * D, D * 4, fullb + s, policy);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < KPLN_STAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  unsigned bj[KMAX][2];  // LN_CD, LN_X2: J[k0 .. k0 + 15][0 .. 7] as B fragments
  if constexpr (MODE == LN_EXACT) {
    for (int i = threadIdx.x; i < D; i += KPLN_THREADS) jcol[i] = to_f(J[(long long)i * ldj]);
  } else {
    const int cq = (lane & 3) * 2, n = lane >> 2;
#pragma unroll
    for (int ks = 0; ks < KMAX; ++ks) {
      bj[ks][0] = bj[ks][1] = 0u;
      if (ks * 16 < D) {
        const bf16* jp = J + (long long)(ks * 16 + cq) * ldj + n;
        bj[ks][0] = pack_bf16(to_f(jp[0]), to_f(jp[ldj]));
        bj[ks][1] = pack_bf16(to_f(jp[8LL * ldj]), to_f(jp[9LL * ldj]));
      }
    }
  }
  __syncthreads();
  if (warp == 0)
    for (int s = 0; s < KPLN_STAGES; ++s)
      if (blockIdx.x + (long long)s * gridDim.x < tiles) load_tile(blockIdx.x + (long long)s * gridDim.x, s);
  int k = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    const int s = k % KPLN_STAGES;
    mbar_wait(&full[s], (k / KPLN_STAGES) & 1);
    const float* tile = ring + (size_t)s * T::ROWS * stride;
    const long long t0 = t * T::ROWS;  // the tile's first row
    if constexpr (MODE == LN_EXACT) {
#pragma unroll
      for (int q = 0; q < T::RPW; q += 2) {  // two rows' chains side by side
        const int r = warp * T::RPW + q;
        const float *xa = tile + r * stride, *xb = xa + stride;
        float m[4] = {0.f, 0.f, 0.f, 0.f};  // row a: sum, sum of squares; row b: the same
        for (int i = lane; i < D; i += 32) {
          const float va = xa[i], vb = xb[i], j = jcol[i];
          m[0] = fmaf(va, j, m[0]);
          m[1] = fmaf(__fmul_rn(va, va), j, m[1]);
          m[2] = fmaf(vb, j, m[2]);
          m[3] = fmaf(__fmul_rn(vb, vb), j, m[3]);
        }
        warp_sums(m);
        if (lane == 0) {
          stat[r][0] = m[0];
          stat[r][1] = 1.0f / sqrtf((m[1] - m[0] * m[0]) + eps);
          stat[r + 1][0] = m[2];
          stat[r + 1][1] = 1.0f / sqrtf((m[3] - m[2] * m[2]) + eps);
        }
      }
    } else if (warp < T::MMA_WARPS) {
      const float* xs = tile + warp * 16 * stride;
      const int g = lane >> 2, cq = (lane & 3) * 2;
      float mu[4] = {0.f, 0.f, 0.f, 0.f}, m2[4] = {0.f, 0.f, 0.f, 0.f};
      float mul[4] = {0.f, 0.f, 0.f, 0.f}, m2l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KMAX; ++ks) {
        if (ks * 16 >= D) continue;
        float2 v[4];  // fragment order: (g, c), (g + 8, c), (g, c + 8), (g + 8, c + 8)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          v[f] = *reinterpret_cast<const float2*>(xs + (g + (f & 1) * 8) * stride + ks * 16 + cq + (f >> 1) * 8);
        unsigned a[4], a2[4];
        float2 sq[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          sq[f] = make_float2(__fmul_rn(v[f].x, v[f].x), __fmul_rn(v[f].y, v[f].y));
          a[f] = pack_bf16(v[f].x, v[f].y);
          a2[f] = pack_bf16(sq[f].x, sq[f].y);
        }
        mma_bf16_16816(mu, a, bj[ks][0], bj[ks][1]);
        mma_bf16_16816(m2, a2, bj[ks][0], bj[ks][1]);
        if constexpr (MODE == LN_X2) {
          // lo = v - hi, hi read back from the packed fragment (bf16 -> fp32 is a 16-bit
          // shift): the same values as converting v again, without the conversion unit
          unsigned l[4], l2[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            l[f] = pack_bf16(v[f].x - __uint_as_float(a[f] << 16), v[f].y - __uint_as_float(a[f] & 0xffff0000u));
            l2[f] = pack_bf16(sq[f].x - __uint_as_float(a2[f] << 16), sq[f].y - __uint_as_float(a2[f] & 0xffff0000u));
          }
          mma_bf16_16816(mul, l, bj[ks][0], bj[ks][1]);
          mma_bf16_16816(m2l, l2, bj[ks][0], bj[ks][1]);
        }
      }
      // column 0 of the product sits in the quad's first lane: elements 0 (row g), 2 (row g + 8)
      const int src = lane & ~3;
      const float mua = __shfl_sync(FULL, mu[0] + mul[0], src), mub = __shfl_sync(FULL, mu[2] + mul[2], src);
      const float m2a = __shfl_sync(FULL, m2[0] + m2l[0], src), m2b = __shfl_sync(FULL, m2[2] + m2l[2], src);
      const float rsa = 1.0f / sqrtf((m2a - mua * mua) + eps), rsb = 1.0f / sqrtf((m2b - mub * mub) + eps);
      if ((lane & 3) == 0) {
        stat[warp * 16 + g][0] = mua;
        stat[warp * 16 + g][1] = rsa;
        stat[warp * 16 + g + 8][0] = mub;
        stat[warp * 16 + g + 8][1] = rsb;
      }
    }
    __syncthreads();  // the tile's mean and 1 / std are in stat
#pragma unroll
    for (int q = 0; q < T::RPW; ++q) {
      const int r = warp * T::RPW + q;
      if (t0 + r >= M) break;
      const float mean = stat[r][0], rs = stat[r][1];
      for (int c = lane * 8; c < D; c += 256) {  // 16 bytes of output a lane
        const float4 p = *reinterpret_cast<const float4*>(tile + r * stride + c);
        const float4 q = *reinterpret_cast<const float4*>(tile + r * stride + c + 4);
        const __nv_bfloat162 o0 = __floats2bfloat162_rn((p.x - mean) * rs, (p.y - mean) * rs);
        const __nv_bfloat162 o1 = __floats2bfloat162_rn((p.z - mean) * rs, (p.w - mean) * rs);
        const __nv_bfloat162 o2 = __floats2bfloat162_rn((q.x - mean) * rs, (q.y - mean) * rs);
        const __nv_bfloat162 o3 = __floats2bfloat162_rn((q.z - mean) * rs, (q.w - mean) * rs);
        __stcs(reinterpret_cast<uint4*>(out + (t0 + r) * D + c),
               make_uint4(*reinterpret_cast<const unsigned*>(&o0), *reinterpret_cast<const unsigned*>(&o1),
                          *reinterpret_cast<const unsigned*>(&o2), *reinterpret_cast<const unsigned*>(&o3)));
      }
    }
    __syncthreads();  // stage s and stat are read: refill the stage
    if (warp == 0 && t + (long long)KPLN_STAGES * gridDim.x < tiles) load_tile(t + (long long)KPLN_STAGES * gridDim.x, s);
  }
}

// ---------------------------------------------------------------- (b) attention
// Head width HD in {8, 16, 32, 64}: a template argument of every kernel.
constexpr int KT = 256;  // keys per shared-memory tile

// fp32 twin: one warp per query row, lane j scores key c + j and owns output
// columns j, j + 32. Passes over the keys: max (not SM_SKIP), z (not
// SM_SKIP), PV. The mode and the pass are run-time values here (one
// instantiation per head width: this is the parity path, and its branches
// are uniform over the block).
constexpr int QT32 = 64, ROWS32 = QT32 / 8;
template <int HD>
constexpr size_t kp_att_f32_smem() { return sizeof(float) * (KT * (HD + 1) + KT * HD + QT32 * HD + KT); }

template <int HD>
__global__ void __launch_bounds__(256)
kp_attention_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ J, int ldj,
                        float* __restrict__ x, int L, int H, float scale, int sm) {
  constexpr int LDK32 = HD + 1, NC = (HD + 31) / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [KT][LDK32]
  float* Vs = Ks + KT * LDK32;                 // [KT][HD]
  float* Qs = Vs + KT * HD;                    // [QT32][HD]
  float* Jc = Qs + QT32 * HD;                  // [KT]: J[key, 0]

  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * HD, D3 = 3 * D;
  const float* base = qkv + (long long)g * L * D3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkt = (L + KT - 1) / KT;
  const bool use_j = sm == SM_CD || sm == SM_X2;

  auto load_kv = [&](int k0) {
    for (int e = tid; e < KT * HD; e += blockDim.x) {
      const int r = e / HD, d = e % HD, key = k0 + r;
      const float* row = base + (long long)key * D3 + h * HD + d;
      Ks[r * LDK32 + d] = key < L ? row[D] : 0.f;
      Vs[r * HD + d] = key < L ? row[2 * D] : 0.f;
    }
    if (use_j)
      for (int r = tid; r < KT; r += blockDim.x) Jc[r] = k0 + r < L ? J[(long long)(k0 + r) * ldj] : 0.f;
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
    // pass 0: row max; pass 1: z; pass 2: PV with the normalised p
#pragma unroll 1
    for (int pass = (sm == SM_SKIP ? 2 : 0); pass < 3; ++pass) {
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
          const float* q = Qs + qr * HD;
          for (int c = 0; c < nk; c += 32) {
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < HD; ++d) s = fmaf(q[d], Ks[(c + lane) * LDK32 + d], s);
            const bool valid = c + lane < nk;
            if (pass == 0) {
              if (valid) m[r] = fmaxf(m[r], s);
            } else if (pass == 1) {
              const float p = valid ? expf(s - m[r]) : 0.f;
              z[r] = use_j ? fmaf(p, Jc[c + lane], z[r]) : z[r] + p;
            } else {
              float p;
              if (sm == SM_SKIP) p = s * 1e-4f;
              else if (sm == SM_X2) p = expf(s - m[r]) * z[r];  // z holds 1 / z
              else p = expf(s - m[r]) / z[r];
              p = valid ? p : 0.f;
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
      }
      if (pass == 0) {
#pragma unroll
        for (int r = 0; r < ROWS32; ++r) m[r] = warp_max(m[r]);
      } else if (pass == 1) {
#pragma unroll
        for (int r = 0; r < ROWS32; ++r) {
          z[r] = warp_sum(z[r]);
          if (sm == SM_X2) z[r] = 1.0f / z[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS32; ++r) {
      const int qr = warp + r * 8;
      if (q0 + qr >= L) continue;
#pragma unroll
      for (int u = 0; u < NC; ++u)
        if (lane + 32 * u < HD) x[((long long)g * L + q0 + qr) * D + h * HD + lane + 32 * u] += acc[r][u];
    }
  }
}

// bf16, L > 256: score, sum and PV products on the tensor cores (mma.sync
// m16n8k16, fp32 accumulate), the scores in registers and recomputed in each
// pass. 4 warps, 16 query rows per warp at a time, bf16(q * scale) in A
// fragments; K, V and J[:, 0:8] (transposed) of up to KT keys in shared
// memory in bf16.
constexpr int ATT_WARPS = 4;
constexpr int LDJT = KT + 8;   // bf16 row stride of the transposed J tile

template <int SM, int HD>
__global__ void __launch_bounds__(ATT_WARPS * 32, 4)
kp_attention_bf16_kernel(const float* __restrict__ qkv, const bf16* __restrict__ J, int ldj,
                         float* __restrict__ x, int L, int H, float scale) {
  constexpr int LDH = Head<HD>::LD, NT = Head<HD>::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kt_rows = (min(L, KT) + 15) / 16 * 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kt_rows][LDH]
  bf16* Vs = Ks + kt_rows * LDH;             // [kt_rows][LDH]
  bf16* Jt = Vs + kt_rows * LDH;             // [8][LDJT]: Jt[n][key] = J[key, n]

  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * HD, D3 = 3 * D;
  const float* base = qkv + (long long)g * L * D3 + h * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkt = (L + KT - 1) / KT;
  const float NEG_INF = __int_as_float(0xff800000);
  constexpr bool USE_J = SM == SM_CD || SM == SM_X2;

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
    if (USE_J)
      for (int e = tid; e < kt_rows * 8; e += ATT_WARPS * 32) {
        const int r = e >> 3, nn = e & 7;
        Jt[nn * LDJT + r] = k0 + r < L ? J[(long long)(k0 + r) * ldj + nn] : __float2bfloat16_rn(0.f);
      }
  };

  if (nkt == 1) {
    load_kv(0, true);
    __syncthreads();
  }
  for (int q0 = 0; q0 < L; q0 += ATT_WARPS * 16) {
    const int ra = q0 + warp * 16 + (lane >> 2), rb = ra + 8;
    const bool active = q0 + warp * 16 < L;  // warp-uniform
    unsigned qa[Head<HD>::KS][4];
    afrag_f32<HD>(qa, base, D3, ra, L, scale, lane);

    float ma = NEG_INF, mb = NEG_INF, za = 0.f, zb = 0.f;
    float zh[4] = {0.f, 0.f, 0.f, 0.f}, zl[4] = {0.f, 0.f, 0.f, 0.f};
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    // pass 0: row max; pass 1: z; pass 2: O = bf16(normalised p) . V
#pragma unroll
    for (int pass = (SM == SM_SKIP ? 2 : 0); pass < 3; ++pass) {
      for (int kt = 0; kt < nkt; ++kt) {
        if (nkt > 1) {
          __syncthreads();
          load_kv(kt * KT, pass == 2);
          __syncthreads();
        }
        const int nk = min(KT, L - kt * KT);
        if (!active) continue;
        for (int kb = 0; kb < nk; kb += 16) {
          float s[2][4];
          prod16<HD>(s, qa, Ks, kb, lane);
          if (pass == 0) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (kb + j * 8 + (lane & 3) * 2 + e < nk) {
                  ma = fmaxf(ma, s[j][e]);
                  mb = fmaxf(mb, s[j][2 + e]);
                }
            continue;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool valid = kb + j * 8 + (lane & 3) * 2 + e < nk;
              if (SM == SM_SKIP) {
                s[j][e] = valid ? s[j][e] * 1e-4f : 0.f;
                s[j][2 + e] = valid ? s[j][2 + e] * 1e-4f : 0.f;
              } else {
                s[j][e] = valid ? expf(s[j][e] - ma) : 0.f;
                s[j][2 + e] = valid ? expf(s[j][2 + e] - mb) : 0.f;
              }
            }
          if (pass == 1) {
            if (SM == SM_SUM) {
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  za += s[j][e];
                  zb += s[j][2 + e];
                }
            } else if (USE_J) {
              // B fragment of J: {k = 2 * (lane % 4) + {0, 1}, n = lane / 4}, then k + 8
              const bf16* jp = Jt + (lane >> 2) * LDJT + kb + (lane & 3) * 2;
              const unsigned b0 = *reinterpret_cast<const unsigned*>(jp);
              const unsigned b1 = *reinterpret_cast<const unsigned*>(jp + 8);
              const unsigned ph[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                      pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
              mma_bf16_16816(zh, ph, b0, b1);
              if (SM == SM_X2) {
                auto lo = [](float v) { return v - to_f(__float2bfloat16_rn(v)); };
                const unsigned pl[4] = {pack_bf16(lo(s[0][0]), lo(s[0][1])), pack_bf16(lo(s[0][2]), lo(s[0][3])),
                                        pack_bf16(lo(s[1][0]), lo(s[1][1])), pack_bf16(lo(s[1][2]), lo(s[1][3]))};
                mma_bf16_16816(zl, pl, b0, b1);
              }
            }
            continue;
          }
          if (SM != SM_SKIP) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                // for SM_X2 za, zb hold 1 / z
                s[j][e] = SM == SM_X2 ? s[j][e] * za : s[j][e] / za;
                s[j][2 + e] = SM == SM_X2 ? s[j][2 + e] * zb : s[j][2 + e] / zb;
              }
          }
          const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                  pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
          mma_rows<HD>(o, pa, Vs, kb, lane);
        }
      }
      if (!active) continue;
      if (pass == 0) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, off));
          mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, off));
        }
      } else if (pass == 1) {
        if (SM == SM_SUM) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            za += __shfl_xor_sync(FULL, za, off);
            zb += __shfl_xor_sync(FULL, zb, off);
          }
        } else {  // column 0 of the product: the quad's first lane, elements 0 and 2
          za = __shfl_sync(FULL, zh[0] + zl[0], lane & ~3);
          zb = __shfl_sync(FULL, zh[2] + zl[2], lane & ~3);
          if (SM == SM_X2) {
            za = 1.0f / za;
            zb = 1.0f / zb;
          }
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = h * HD + j * 8 + (lane & 3) * 2;
      if (ra < L) {
        float2* p = reinterpret_cast<float2*>(x + ((long long)g * L + ra) * D + d);
        const float2 t = *p;
        *p = make_float2(t.x + o[j][0], t.y + o[j][1]);
      }
      if (rb < L) {
        float2* p = reinterpret_cast<float2*>(x + ((long long)g * L + rb) * D + d);
        const float2 t = *p;
        *p = make_float2(t.x + o[j][2], t.y + o[j][3]);
      }
    }
  }
}

// bf16, L <= 256: one pass. Block: one (sequence, head), its q, k and v
// staged in shared memory as bf16 once; warp w takes the 16-query strips w,
// w + W, ... The scores of key block cb sit in s[cb]. The head's output
// collects in shared memory and is added into x by the whole block at the
// end, with many reads in flight (a strip's own read-modify-write would wait
// on each read).
// Every phase runs over all NB blocks without a branch (K and V are zero
// past L), so the compiler interleaves the blocks' work; the row max and sum
// keep four partials per row.
constexpr int KP_BATCH = 4;  // rows' loads a thread keeps in flight while the block stages q, k, v

// fp32 row stride of the head-output tile (HD + 8: conflict-free float2 writes)
template <int HD, int NB>
constexpr size_t kp_strip_smem() {
  return sizeof(bf16) * (3 * NB * 16 * Head<HD>::LD + 8 * LDJT) + sizeof(float) * NB * 16 * (HD + 8);
}

template <int SM, int HD, int NB>
__global__ void __launch_bounds__(256, 1)
kp_attention_strip_bf16_kernel(const float* __restrict__ qkv, const bf16* __restrict__ J, int ldj,
                               float* __restrict__ x, int L, int H, float scale) {
  constexpr int LDH = Head<HD>::LD, LDO = HD + 8, NT = Head<HD>::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [NB * 16][LDH]
  bf16* Vs = Ks + NB * 16 * LDH;             // [NB * 16][LDH]
  bf16* Qs = Vs + NB * 16 * LDH;             // [NB * 16][LDH]: bf16(q * scale)
  bf16* Jt = Qs + NB * 16 * LDH;             // [8][LDJT]: Jt[n][key] = J[key, n]
  float* Os = reinterpret_cast<float*>(Jt + 8 * LDJT);  // [NB * 16][LDO]: the head's output, added into x at the end
  constexpr bool USE_J = SM == SM_CD || SM == SM_X2;
  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * HD;
  const float* base = qkv + (long long)g * L * 3 * D + h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const float NEG_INF = __int_as_float(0xff800000);
  const float LOG2E = 1.4426950408889634f;

  stage_qkv_bf16<HD, NB * 16, KP_BATCH>(base, D, L, scale, Qs, Ks, Vs);
  if (USE_J)
    for (int r = threadIdx.x; r < NB * 16; r += blockDim.x)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
        Jt[nn * LDJT + r] = r < L ? J[(long long)r * ldj + nn] : __float2bfloat16_rn(0.f);
  __syncthreads();

  for (int q0 = warp * 16; q0 < L; q0 += nw * 16) {
    const int ra = q0 + (lane >> 2), rb = ra + 8;
    unsigned qa[Head<HD>::KS][4];
    afrag_smem<HD>(qa, Qs, q0, lane);
    float s[NB][2][4];
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) prod16<HD>(s[cb], qa, Ks, cb * 16, lane);
    // keys past L -> 0 (SM_SKIP) or -inf (for NB = 16, L > 128: blocks 0-7 hold none)
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      const bool edge = cb >= (NB == 16 ? 8 : 0) && cb * 16 + 16 > L;  // warp-uniform
      const int lim = L - cb * 16 - (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool masked = edge && j * 8 + (e & 1) >= lim;
          if (SM == SM_SKIP) s[cb][j][e] = masked ? 0.f : s[cb][j][e] * 1e-4f;
          else s[cb][j][e] = masked ? NEG_INF : s[cb][j][e];
        }
    }
    if (SM != SM_SKIP) {
      float m[2], z[2];
      strip_row_max<NB>(s, m);
      strip_exp<NB, SM == SM_SUM>(s, m, LOG2E, z);  // p in place of s
      if (USE_J) {  // z = (bf16(p) . J)[:, 0], for SM_X2 plus (bf16 remainder of p . J)[:, 0]
        float zh[4] = {0.f, 0.f, 0.f, 0.f}, zl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int cb = 0; cb < NB; ++cb) {
          // B fragment of J: {k = 2 * (lane % 4) + {0, 1}, n = lane / 4}, then k + 8
          const bf16* jp = Jt + (lane >> 2) * LDJT + cb * 16 + (lane & 3) * 2;
          const unsigned b0 = *reinterpret_cast<const unsigned*>(jp);
          const unsigned b1 = *reinterpret_cast<const unsigned*>(jp + 8);
          const float (&p)[2][4] = s[cb];
          const unsigned ph[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                  pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
          mma_bf16_16816(zh, ph, b0, b1);
          if (SM == SM_X2) {
            auto lo = [](float v) { return v - to_f(__float2bfloat16_rn(v)); };
            const unsigned pl[4] = {pack_bf16(lo(p[0][0]), lo(p[0][1])), pack_bf16(lo(p[0][2]), lo(p[0][3])),
                                    pack_bf16(lo(p[1][0]), lo(p[1][1])), pack_bf16(lo(p[1][2]), lo(p[1][3]))};
            mma_bf16_16816(zl, pl, b0, b1);
          }
        }
        // column 0 of the product: the quad's first lane, elements 0 and 2
        z[0] = __shfl_sync(FULL, zh[0] + zl[0], lane & ~3);
        z[1] = __shfl_sync(FULL, zh[2] + zl[2], lane & ~3);
      }
      // p * (1 / z): SM_X2's own arithmetic, the others' division within the tolerances
      const float iz[2] = {1.0f / z[0], 1.0f / z[1]};
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[cb][j][e] *= iz[e >> 1];
    }
    // O = bf16(normalised p) . V into the block's output tile
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
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(Os + ra * LDO + d) = make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(Os + rb * LDO + d) = make_float2(o[j][2], o[j][3]);
    }
  }
  // x += the head's output, eight lanes to a row's 128 bytes, KP_BATCH rows' reads in flight
  __syncthreads();
  constexpr int NO = NB * 16 * (HD / 4);
  for (int e0 = threadIdx.x; e0 < NO; e0 += KP_BATCH * blockDim.x) {
    float4 t[KP_BATCH];
#pragma unroll
    for (int b = 0; b < KP_BATCH; ++b) {
      const int e = e0 + b * blockDim.x, r = e / (HD / 4), c = (e % (HD / 4)) * 4;
      if (e < NO && r < L) t[b] = *reinterpret_cast<const float4*>(x + ((long long)g * L + r) * D + h * HD + c);
    }
#pragma unroll
    for (int b = 0; b < KP_BATCH; ++b) {
      const int e = e0 + b * blockDim.x, r = e / (HD / 4), c = (e % (HD / 4)) * 4;
      if (e >= NO || r >= L) continue;
      const float4 a = *reinterpret_cast<const float4*>(Os + r * LDO + c);
      *reinterpret_cast<float4*>(x + ((long long)g * L + r) * D + h * HD + c) =
          make_float4(t[b].x + a.x, t[b].y + a.y, t[b].z + a.z, t[b].w + a.w);
    }
  }
}

// The bf16 attention's route: one pass for L <= STRIP_MAX_L, the multi-pass
// kernel beyond. STRIP_WARPS beat 2 and 8 warps a block at the tool's shape
// on the H100 (PERF.md).
constexpr int STRIP_MAX_L = 256;
constexpr int STRIP_WARPS = 4;

// One launch of the bf16 attention at L: the kernel (its shared-memory limit
// raised once), key blocks held in registers (0: multi-pass), threads and
// dynamic shared bytes a block.
using KpKernel = void (*)(const float*, const bf16*, int, float*, int, int, float);
struct KpPlan {
  KpKernel kern;
  int nb, threads;
  size_t smem;
  cudaError_t err;
};

template <int SM, int HD, int NB>
KpPlan kp_strip_plan() {
  static const cudaError_t e = cudaFuncSetAttribute(kp_attention_strip_bf16_kernel<SM, HD, NB>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    (int)kp_strip_smem<HD, NB>());
  return {kp_attention_strip_bf16_kernel<SM, HD, NB>, NB, 32 * STRIP_WARPS, kp_strip_smem<HD, NB>(), e};
}

template <int HD>
constexpr size_t kp_passes_smem(int kt_rows) { return sizeof(bf16) * (2 * kt_rows * Head<HD>::LD + 8 * LDJT); }

template <int SM, int HD>
KpPlan plan_kp_bf16(int L) {
  if (L <= 128) return kp_strip_plan<SM, HD, 8>();
  if (L <= STRIP_MAX_L) return kp_strip_plan<SM, HD, 16>();
  static const cudaError_t e = cudaFuncSetAttribute(kp_attention_bf16_kernel<SM, HD>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    (int)kp_passes_smem<HD>(KT));
  return {kp_attention_bf16_kernel<SM, HD>, 0, ATT_WARPS * 32, kp_passes_smem<HD>((min(L, KT) + 15) / 16 * 16), e};
}

template <int SM, int HD>
cudaError_t launch_kp_attention(int bf, const float* qkv, const void* J, int ldj, float* x, int G, int L,
                                int H, float scale, cudaStream_t st) {
  if (L < 1) return cudaErrorInvalidValue;
  if (bf) {
    const KpPlan p = plan_kp_bf16<SM, HD>(L);
    if (p.err != cudaSuccess) return p.err;
    p.kern<<<G * H, p.threads, p.smem, st>>>(qkv, static_cast<const bf16*>(J), ldj, x, L, H, scale);
  } else {
    static bool ready = false;
    const cudaError_t e = allow_smem(kp_attention_f32_kernel<HD>, kp_att_f32_smem<HD>(), ready);
    if (e != cudaSuccess) return e;
    kp_attention_f32_kernel<HD><<<G * H, 256, kp_att_f32_smem<HD>(), st>>>(
        qkv, static_cast<const float*>(J), ldj, x, L, H, scale, SM);
  }
  return cudaGetLastError();
}

template <int SM, int HD>
cudaError_t kp_attention_info(int L, int* info) {
  if (L < 1) return cudaErrorInvalidValue;
  const KpPlan p = plan_kp_bf16<SM, HD>(L);
  if (p.err != cudaSuccess) return p.err;
  info[0] = p.nb;
  info[1] = p.threads;
  info[2] = L;  // query rows a block: the whole sequence
  info[3] = (int)p.smem;
  return kernel_info(reinterpret_cast<const void*>(p.kern), p.threads, p.smem, info + 4);
}

template <int MODE, typename TO, typename TJ>
cudaError_t launch_kp_ln_rows(const float* x, const void* J, int ldj, void* out, long long M, int D, float eps,
                              cudaStream_t st) {
  kp_ln_rows_kernel<MODE, TO, TJ><<<(unsigned)((M + 7) / 8), 256, 0, st>>>(
      x, static_cast<const TJ*>(J), ldj, static_cast<TO*>(out), M, D, eps);
  return cudaGetLastError();
}

// The staged kernel of a bf16 J mode at D: its function, threads, rows a
// tile and dynamic shared bytes (the instantiation's largest D allowed once).
struct KpLnPlan {
  const void* fn;
  int threads, rows;
  size_t smem;
  cudaError_t err;
};

template <int MODE, int KMAX>
KpLnPlan kp_ln_staged_of(int D) {
  using T = KpLnTile<KMAX>;
  static bool ready = false;
  const cudaError_t e = allow_smem(kp_ln_staged_kernel<MODE, KMAX>, kpln_smem(T::ROWS, 16 * KMAX), ready);
  return {reinterpret_cast<const void*>(kp_ln_staged_kernel<MODE, KMAX>), KPLN_THREADS, T::ROWS,
          kpln_smem(T::ROWS, D), e};
}

template <int MODE>
KpLnPlan kp_ln_staged_plan(int D) {
  if (D <= 256) return kp_ln_staged_of<MODE, 16>(D);
  if (D <= 512) return kp_ln_staged_of<MODE, 32>(D);
  return kp_ln_staged_of<MODE, 64>(D);
}

// the staged route takes bf16 LN_CD, LN_X2 and LN_EXACT at D % 16 == 0, D <=
// KPLN_MAXD, with a 16-byte aligned x
inline bool kp_ln_staged(int mode, int D, const void* x) {
  return (mode == LN_CD || mode == LN_X2 || mode == LN_EXACT) && D >= 16 && D % 16 == 0 && D <= KPLN_MAXD &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

inline KpLnPlan kp_ln_plan(int mode, int D) {
  if (mode == LN_CD) return kp_ln_staged_plan<LN_CD>(D);
  if (mode == LN_X2) return kp_ln_staged_plan<LN_X2>(D);
  return kp_ln_staged_plan<LN_EXACT>(D);
}

// persistent: as many blocks as fit the card at once, at most one a tile
cudaError_t launch_kp_ln_staged(int mode, const float* x, const void* J, int ldj, void* out, long long M, int D,
                                float eps, cudaStream_t st) {
  const KpLnPlan p = kp_ln_plan(mode, D);
  if (p.err != cudaSuccess) return p.err;
  if (M == 0) return cudaSuccess;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.fn, p.threads, p.smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (M + p.rows - 1) / p.rows;
  const long long fit = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(tiles < fit ? tiles : fit);
  const bf16* jb = static_cast<const bf16*>(J);
  bf16* ob = static_cast<bf16*>(out);
  void* args[] = {&x, &jb, &ldj, &ob, &M, &D, &eps};
  return cudaLaunchKernel(p.fn, dim3(blocks), dim3(p.threads), args, p.smem, st);
}

}  // namespace

extern "C" {

// out[M, D] (bf16 when bf16_out, else fp32) = the mode's LayerNorm of fp32
// x[M, D] without scale and bias; J [>= D, ldj] is bf16 when bf16_out, else
// fp32 (LnMode above; J is not read for LN_NONE and LN_CENTRED). bf16 LN_CD,
// LN_EXACT and LN_X2 need D % 16 == 0, D <= KPLN_MAXD and a 16-byte aligned x
// (the staged kernel).
int cse_kp_layer_norm(const void* x, const void* j, int ldj, void* out, int bf16_out, int mode,
                      long long M, int D, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  if (bf16_out) {
    switch (mode) {
      case LN_NONE: return (int)launch_kp_ln_rows<LN_NONE, bf16, bf16>(xf, j, ldj, out, M, D, eps, st);
      case LN_CENTRED: return (int)launch_kp_ln_rows<LN_CENTRED, bf16, bf16>(xf, j, ldj, out, M, D, eps, st);
      case LN_CD:
      case LN_EXACT:
      case LN_X2:
        if (!kp_ln_staged(mode, D, x)) return (int)cudaErrorInvalidValue;
        return (int)launch_kp_ln_staged(mode, xf, j, ldj, out, M, D, eps, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (mode) {
    case LN_NONE: return (int)launch_kp_ln_rows<LN_NONE, float, float>(xf, j, ldj, out, M, D, eps, st);
    case LN_CENTRED: return (int)launch_kp_ln_rows<LN_CENTRED, float, float>(xf, j, ldj, out, M, D, eps, st);
    case LN_CD:
    case LN_EXACT:
    case LN_X2: return (int)launch_kp_ln_rows<LN_EXACT, float, float>(xf, j, ldj, out, M, D, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// info[7] of the LayerNorm cse_kp_layer_norm launches for (mode, D, dtype)
// with a 16-byte aligned x: its route (1: the staged kernel, 0: a warp a row),
// threads, rows a block takes at a time, dynamic shared bytes, registers a
// thread, local-memory bytes a thread, resident blocks per SM.
int cse_kp_layer_norm_info(int mode, int D, int bf16_out, int* info) {
  if (D < 1 || mode < LN_NONE || mode > LN_X2) return (int)cudaErrorInvalidValue;
  const void* aligned = nullptr;
  if (bf16_out && kp_ln_staged(mode, D, aligned)) {
    const KpLnPlan p = kp_ln_plan(mode, D);
    if (p.err != cudaSuccess) return (int)p.err;
    info[0] = 1;
    info[1] = p.threads;
    info[2] = p.rows;
    info[3] = (int)p.smem;
    return (int)kernel_info(p.fn, p.threads, p.smem, info + 4);
  }
  const bool j_mode = mode == LN_CD || mode == LN_EXACT || mode == LN_X2;
  if (bf16_out && j_mode) return (int)cudaErrorInvalidValue;  // outside the staged kernel's D
  const void* fn =
      bf16_out ? (mode == LN_NONE ? reinterpret_cast<const void*>(kp_ln_rows_kernel<LN_NONE, bf16, bf16>)
                                  : reinterpret_cast<const void*>(kp_ln_rows_kernel<LN_CENTRED, bf16, bf16>))
               : (mode == LN_NONE     ? reinterpret_cast<const void*>(kp_ln_rows_kernel<LN_NONE, float, float>)
                  : mode == LN_CENTRED ? reinterpret_cast<const void*>(kp_ln_rows_kernel<LN_CENTRED, float, float>)
                                       : reinterpret_cast<const void*>(kp_ln_rows_kernel<LN_EXACT, float, float>));
  info[0] = 0;
  info[1] = 256;
  info[2] = 8;
  info[3] = 0;
  return (int)kernel_info(fn, 256, 0, info + 4);
}

// x[G*L, H*hd] (fp32, in place) += the mode's attention of qkv[G*L, 3*H*hd]
// fp32 (SmMode above), hd in {8, 16, 32, 64}. bf16_operands: products on the
// tensor cores with J bf16; else fp32 FMAs with J fp32. J [>= L, ldj] is read
// for SM_CD, SM_X2.
int cse_kp_attention(const void* qkv, const void* j, int ldj, void* x, int bf16_operands, int mode,
                     int G, int L, int H, int hd, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  float* xf = static_cast<float*>(x);
  return by_head_width(KpHeadWidths{}, hd, [&](auto w) {
    constexpr int HD = decltype(w)::value;
    switch (mode) {
      case SM_SKIP: return launch_kp_attention<SM_SKIP, HD>(bf16_operands, q, j, ldj, xf, G, L, H, scale, st);
      case SM_SUM: return launch_kp_attention<SM_SUM, HD>(bf16_operands, q, j, ldj, xf, G, L, H, scale, st);
      case SM_CD: return launch_kp_attention<SM_CD, HD>(bf16_operands, q, j, ldj, xf, G, L, H, scale, st);
      case SM_X2: return launch_kp_attention<SM_X2, HD>(bf16_operands, q, j, ldj, xf, G, L, H, scale, st);
      default: return cudaErrorInvalidValue;
    }
  });
}

// info[7] of the bf16 attention cse_kp_attention launches for (mode, L, hd),
// in cse_flash_fwd_info's order: key blocks held in registers (0:
// multi-pass), threads, query rows a block, dynamic shared bytes, registers
// a thread, local-memory bytes a thread, resident blocks per SM.
int cse_kp_attention_info(int mode, int L, int hd, int* info) {
  return by_head_width(KpHeadWidths{}, hd, [&](auto w) {
    constexpr int HD = decltype(w)::value;
    switch (mode) {
      case SM_SKIP: return kp_attention_info<SM_SKIP, HD>(L, info);
      case SM_SUM: return kp_attention_info<SM_SUM, HD>(L, info);
      case SM_CD: return kp_attention_info<SM_CD, HD>(L, info);
      case SM_X2: return kp_attention_info<SM_X2, HD>(L, info);
      default: return cudaErrorInvalidValue;
    }
  });
}

}  // extern "C"
