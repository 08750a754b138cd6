// Hopper (sm_90a) port of cse_tpu/ops/attention.py: the flash-attention pair
// _fwd_kernel (:38, launched at :110) and _bwd_kernel (:59, launched at
// :134). The host wrapper is cse_tpu_torch/ops/attention.py.
//
// Layout. q, k, v, o, do are [BH, L, DH] row-major (the public [B, H, L, dh]
// of the JAX function, made contiguous by the wrapper); lse and delta are
// [BH, L] fp32. Reading the packed [B, L, 3D] projection instead would save
// the model's three transposed copies, but ties the kernels to one caller's
// layout; this first port keeps the public one.
//
// The TPU kernel holds one sequence's whole [Lp, Lp] score tile in VMEM with
// L padded to a multiple of 128 (one product, one exp). An SM has 227 KB of
// shared memory and the registers are the scarcer store, so here scores live
// only in registers and no padding is stored: keys past L are masked (p = 0)
// and rows past L are not written. Any L; head width DH in {4, 8, 16, 32, 48,
// 64} (DH 4 in common.cuh's Head<8>-shaped tiles: a row is one 8-byte chunk).
//
// Arithmetic, that of the TPU kernels:
//   forward  s = (q . k^T) * scale in fp32 (the scale after the product),
//            m = max s, p = exp(s - m), z = sum p, o = cd(p / z) . v with
//            fp32 accumulation (the division before PV), lse = m + log z.
//   backward p = exp(s - lse), delta = rowsum(do * o), dp = do . v^T,
//            ds = p * (dp - delta) * scale, dq = ds . k, dk = ds^T . q,
//            dv = p^T . do, fp32 throughout, each result rounded to cd.
//
// The bf16 forward, routed by L. Because p / z is rounded to bf16 before PV,
// z must be known before the PV product; online rescaling of o is another
// function.
//   L <= 256, the strip route (flash_fwd_strip_bf16_kernel): a warp owns 16
//     queries and keeps their scores against every key in registers,
//     s[NB][2][4] with NB = 8 (L <= 128) or 16 (L <= 256) blocks of 16 keys,
//     each a compile-time register index: 64 or 128 fp32 registers a thread
//     (the whole kernel 127 / 255 at DH 32, no local memory at any DH). K and
//     V of the (sequence, head) land in shared memory by cp.async once per
//     block of 2 warps; one product, one exponential and one normalisation
//     per score, the row max and sum by quad shuffles, every phase without a
//     branch over the key blocks. p = 2^(s c - m c) with c = scale log2(e)
//     in one FMA and one ex2, and p * (1 / z): against the reference's expf
//     and true division it holds the same tolerances and is faster (PERF.md).
//   L > 256, the three-pass route (flash_fwd_bf16_kernel): 64 query rows per
//     block, keys in shared-memory tiles of 256, and three passes over the
//     keys (max, sum, PV) that recompute the scores instead of storing them.
//
// The bf16 backward, routed by L the same way.
//   L <= 256, the one-pass strip (flash_bwd_strip_bf16_kernel, its design
//     below): one block per sequence-head reads q, k, v, do and lse once, o
//     only for delta, and forms each score's s, dp, p and ds once (8
//     products: s, dp, and dv, dk, dq each split hi + lo; one ex2).
//   L > 256, three kernels: a pre-pass writes delta; the dq kernel walks the
//     keys once per 64-query tile, the dk/dv kernel the queries once per
//     64-key tile, each forming s and dp again (10 products, 2 expf).
//
// bf16: the score, dp and PV products have bf16 operands, so mma.sync
// m16n8k16 with fp32 accumulation gives each product exactly, as the TPU's
// fp32 dot of upcast values does. The backward's dq, dk, dv contract fp32 ds
// and p: each is split into two bf16 terms (hi = bf16(x), lo = bf16(x - hi))
// and both go through mma.sync, which keeps ~16 bits of ds and p (the output
// is bf16, 8 bits) and keeps the products on the tensor cores. fp32 runs on
// CUDA-core FMAs (no TF32), one warp per row.
//
// Bound on the H100 at the training shapes (G = 2016 or 4000 sequences x 8
// heads, L = 251 or 127, DH = 32, bf16): the forward reads q, k, v and
// writes o and lse, ~1.05 GB = 0.31 ms at 3.35 TB/s, against 0.13 TFLOP =
// 0.13 ms on the tensor cores; the backward moves ~2.09 GB = 0.62 ms against
// 0.33 TFLOP = 0.33 ms. Both are bound by bytes on paper. The strip route
// also pays one ex2 per score on the special-function unit (16 a clock per
// SM: 1.0e9 scores at intra ~0.27 ms); at 255 registers a thread an SM
// holds 8 warps, too few to hide the latency of a strip's dependent phases
// (product, max, exp, sum, PV), which keeps it at 2.3x its byte bound at
// intra, 1.3x at inter. The backward's strip reads each operand once and
// writes each output once, and sits at 4.1x / 2.1x its byte bound (one
// block of 16 warps an SM at intra, two of 8 at inter; PERF.md); beyond
// L = 256, K and V are re-read by the ceil(L / 64) blocks of a sequence
// (mostly from L2), and q and do too.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 = launched).

#include "common.cuh"

namespace {

constexpr int RT = 64;    // rows (queries, or keys) per block
constexpr int KT = 256;   // keys per shared-memory tile (bf16 kernels)
constexpr int QT = 128;   // queries per shared-memory tile (bf16 dk/dv)
constexpr int T32 = 64;   // keys or queries per shared-memory tile (fp32 kernels)

__device__ __forceinline__ unsigned ld_pair(const bf16* p) { return *reinterpret_cast<const unsigned*>(p); }

// x = hi + lo, both bf16, packed as two pairs for an A fragment
__device__ __forceinline__ void split_pack(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// a row of [L, DH] bf16 moves in chunks of CW columns: 16 bytes, or the
// whole 8-byte row at DH 4
template <int DH>
__host__ __device__ constexpr int chunk_cols() { return DH < 8 ? DH : 8; }
template <int DH>
using Chunk = std::conditional_t<chunk_cols<DH>() == 8, uint4, uint2>;

// one chunk global -> shared by cp.async (zero-filled when !pred)
template <int DH>
__device__ __forceinline__ void cp_async_chunk(bf16* smem, const bf16* gmem, bool pred) {
  if constexpr (DH < 8) cp_async8(smem, gmem, pred);
  else cp_async16(smem, gmem, pred);
}

// rows r0 .. r0 + n - 1 of src [L, DH] (bf16) into dst [n][LDH], zero past L
template <int DH>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, int r0, int n, int L) {
  constexpr int CW = chunk_cols<DH>(), C = DH / CW;  // chunks per row
  for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
    const int r = e / C, c = (e % C) * CW;
    Chunk<DH> v{};
    if (r0 + r < L) v = *reinterpret_cast<const Chunk<DH>*>(src + (long long)(r0 + r) * DH + c);
    *reinterpret_cast<Chunk<DH>*>(dst + r * Head<DH>::LD + c) = v;
  }
}

// A fragments (m16 x k16 each, Head<DH>::KS of them) of rows ra, ra + 8 of x [L, DH]
template <int DH>
__device__ __forceinline__ void load_afrag(unsigned (&f)[Head<DH>::KS][4], const bf16* x, int ra, int L, int lane) {
  const int rb = ra + 8;
#pragma unroll
  for (int ks = 0; ks < Head<DH>::KS; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int d = ks * 16 + hi * 8 + (lane & 3) * 2;
      const bool in = ks * 16 + hi * 8 < DH && in_head<DH>(ks * 16 + hi * 8, lane);  // past the head: zero
      f[ks][hi * 2] = in && ra < L ? ld_pair(x + (long long)ra * DH + d) : 0u;
      f[ks][hi * 2 + 1] = in && rb < L ? ld_pair(x + (long long)rb * DH + d) : 0u;
    }
}

template <int DH>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[Head<DH>::NT][4], int ra, int L,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < Head<DH>::NT; ++j) {
    if (!in_head<DH>(j * 8, lane)) continue;  // DH 4: the tile's columns 4 .. 7
    const int d = j * 8 + (lane & 3) * 2;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)ra * DH + d) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (ra + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(ra + 8) * DH + d) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------- forward, bf16
// Block: sequence-head bh = blockIdx.x / ntile, queries (blockIdx.x % ntile) * 64
// onwards; 4 warps x 16 query rows. K and V of up to KT keys in shared memory.
template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      bf16* __restrict__ o, float* __restrict__ lse, int L, float scale, int kt_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kt_rows][LDH]
  bf16* Vs = Ks + kt_rows * Head<DH>::LD;
  const int ntile = (L + RT - 1) / RT;
  const long long bh = blockIdx.x / ntile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long off = bh * L * DH;
  const bf16 *qb = q + off, *kb_ = k + off, *vb = v + off;
  const int nkt = (L + KT - 1) / KT;
  const float NEG_INF = __int_as_float(0xff800000);

  const int q0 = (blockIdx.x % ntile) * RT + warp * 16;
  const int ra = q0 + (lane >> 2), rb = ra + 8;
  const bool active = q0 < L;  // warp-uniform
  unsigned qa[Head<DH>::KS][4];
  load_afrag<DH>(qa, qb, ra, L, lane);

  auto load_kv = [&](int k0, bool with_v) {
    load_tile_bf16<DH>(Ks, kb_, k0, kt_rows, L);
    if (with_v) load_tile_bf16<DH>(Vs, vb, k0, kt_rows, L);
  };
  if (nkt == 1) {
    load_kv(0, true);
    __syncthreads();
  }
  float ma = NEG_INF, mb = NEG_INF, za = 0.f, zb = 0.f, acc[Head<DH>::NT][4];
#pragma unroll
  for (int j = 0; j < Head<DH>::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // pass 0: the row max; pass 1: z = sum exp(s - m); pass 2: o = cd(p / z) . v
  for (int pass = 0; pass < 3; ++pass) {
    for (int kt = 0; kt < nkt; ++kt) {
      if (nkt > 1) {
        __syncthreads();
        load_kv(kt * KT, pass == 2);
        __syncthreads();
      }
      const int nk = min(KT, L - kt * KT);
      if (!active) continue;
      for (int cb = 0; cb < nk; cb += 16) {
        float s[2][4];
        prod16<DH>(s, qa, Ks, cb, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool valid = cb + j * 8 + (lane & 3) * 2 + (e & 1) < nk;
            const float x = __fmul_rn(s[j][e], scale);  // the scale after the product, unfused
            if (pass == 0) {
              if (valid) {
                if (e < 2) ma = fmaxf(ma, x);
                else mb = fmaxf(mb, x);
              }
            } else {
              const float p = valid ? expf(x - (e < 2 ? ma : mb)) : 0.f;
              if (pass == 1) {
                if (e < 2) za += p;
                else zb += p;
              } else {
                s[j][e] = p / (e < 2 ? za : zb);
              }
            }
          }
        if (pass == 2) {
          const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                  pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
          mma_rows<DH>(acc, pa, Vs, cb, lane);
        }
      }
    }
    // the four lanes of a quad share a row
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      if (pass == 0) {
        ma = fmaxf(ma, __shfl_xor_sync(FULL, ma, x));
        mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, x));
      } else if (pass == 1) {
        za += __shfl_xor_sync(FULL, za, x);
        zb += __shfl_xor_sync(FULL, zb, x);
      }
    }
  }
  if (!active) return;
  store_rows<DH>(o + off, acc, ra, L, lane);
  if ((lane & 3) == 0) {
    if (ra < L) lse[bh * L + ra] = ma + logf(za);
    if (rb < L) lse[bh * L + rb] = mb + logf(zb);
  }
}

// ---------------------------------------------------------------- forward, bf16, L <= 256
// Block: sequence-head bh = blockIdx.x, all of its L query rows; warp w takes
// the 16-row strips 16 w, 16 (w + W), ... K and V of NB * 16 keys in shared
// memory (zero past L), loaded once. Per strip, the scores of key block cb
// sit in s[cb] (the m16n8 accumulators of two n8 tiles). Every phase runs
// over all NB blocks without a branch, so the compiler interleaves the
// blocks' products and reductions; the row max and sum keep four partials
// per row (j, e & 1) for the same reason. The next strip's q fragments are
// loaded while this one computes.
template <int DH, int NB>
constexpr size_t strip_smem() { return sizeof(bf16) * 2 * NB * 16 * Head<DH>::LD; }

template <int DH, int NB>
__global__ void __launch_bounds__(256, 1)
flash_fwd_strip_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                            bf16* __restrict__ o, float* __restrict__ lse, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = Head<DH>::LD, CW = chunk_cols<DH>(), C = DH / CW;
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [NB * 16][LD]
  bf16* Vs = Ks + NB * 16 * LD;
  const long long bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const long long off = bh * L * DH;
  for (int e = threadIdx.x; e < NB * 16 * C; e += blockDim.x) {
    const int r = e / C, c = (e % C) * CW;
    const long long g = off + (long long)min(r, L - 1) * DH + c;
    cp_async_chunk<DH>(Ks + r * LD + c, k + g, r < L);  // zero past L
    cp_async_chunk<DH>(Vs + r * LD + c, v + g, r < L);
  }
  cp_async_commit();
  const float NEG_INF = __int_as_float(0xff800000);
  const float c2 = scale * 1.4426950408889634f;  // scale * log2(e): the exponent is taken of the raw s
  int q0 = warp * 16;
  unsigned qn[Head<DH>::KS][4];
  if (q0 < L) load_afrag<DH>(qn, q + off, q0 + (lane >> 2), L, lane);
  cp_async_wait<0>();
  __syncthreads();

  for (; q0 < L; q0 += nw * 16) {
    const int ra = q0 + (lane >> 2), rb = ra + 8;
    unsigned qa[Head<DH>::KS][4];
#pragma unroll
    for (int i = 0; i < Head<DH>::KS; ++i)
#pragma unroll
      for (int f = 0; f < 4; ++f) qa[i][f] = qn[i][f];
    if (q0 + nw * 16 < L) load_afrag<DH>(qn, q + off, ra + nw * 16, L, lane);

    float s[NB][2][4];
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) prod16<DH>(s[cb], qa, Ks, cb * 16, lane);
    // keys past L -> -inf (for NB = 16, L > 128: blocks 0-7 hold none)
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      const bool edge = cb >= (NB == 16 ? 8 : 0) && cb * 16 + 16 > L;  // warp-uniform
      const int lim = L - cb * 16 - (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (edge && j * 8 + (e & 1) >= lim) s[cb][j][e] = NEG_INF;
    }
    float m[2], z[2];
    strip_row_max<NB>(s, m);
    strip_exp<NB, true>(s, m, c2, z);  // p in place of s
    const float iz[2] = {1.0f / z[0], 1.0f / z[1]};
    // o = cd(p / z) . v
    float acc[Head<DH>::NT][4];
#pragma unroll
    for (int j = 0; j < Head<DH>::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      float pn[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pn[j][e] = s[cb][j][e] * iz[e >> 1];
      const unsigned pa[4] = {pack_bf16(pn[0][0], pn[0][1]), pack_bf16(pn[0][2], pn[0][3]),
                              pack_bf16(pn[1][0], pn[1][1]), pack_bf16(pn[1][2], pn[1][3])};
      mma_rows<DH>(acc, pa, Vs, cb * 16, lane);
    }
    store_rows<DH>(o + off, acc, ra, L, lane);
    if ((lane & 3) == 0) {
      // lse = max of the scaled scores + log z; scaling by scale > 0 keeps the order
      const float la = __fmul_rn(m[0], scale) + logf(z[0]);
      const float lb = __fmul_rn(m[1], scale) + logf(z[1]);
      if (ra < L) lse[bh * L + ra] = la;
      if (rb < L) lse[bh * L + rb] = lb;
    }
  }
}

// ---------------------------------------------------------------- forward, fp32
// 8 warps x 8 query rows; lane j scores key c + j and owns output columns
// j, j + 32. K (DH + 1-word rows), V and the block's q rows in shared memory.
template <int DH>
constexpr size_t fwd_f32_smem() { return sizeof(float) * (T32 * (DH + 1) + T32 * DH + RT * DH); }

template <int DH>
__global__ void __launch_bounds__(256)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LK = DH + 1, CPL = (DH + 31) / 32, ROWS = RT / 8;
  float* Ks = reinterpret_cast<float*>(smem);  // [T32][LK]
  float* Vs = Ks + T32 * LK;                   // [T32][DH]
  float* Qs = Vs + T32 * DH;                   // [RT][DH]
  const int ntile = (L + RT - 1) / RT;
  const long long bh = blockIdx.x / ntile;
  const int r0 = (blockIdx.x % ntile) * RT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long off = bh * L * DH;
  const int nkt = (L + T32 - 1) / T32;

  for (int e = tid; e < RT * DH; e += 256) {
    const int r = r0 + e / DH;
    Qs[e] = r < L ? q[off + (long long)r * DH + e % DH] : 0.f;
  }
  auto load_kv = [&](int k0) {
    for (int e = tid; e < T32 * DH; e += 256) {
      const int r = e / DH, d = e % DH, key = k0 + r;
      Ks[r * LK + d] = key < L ? k[off + (long long)key * DH + d] : 0.f;
      Vs[r * DH + d] = key < L ? v[off + (long long)key * DH + d] : 0.f;
    }
  };
  float m[ROWS], z[ROWS], acc[ROWS][CPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = __int_as_float(0xff800000);
    z[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  }
  for (int pass = 0; pass < 3; ++pass) {
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      load_kv(kt * T32);
      __syncthreads();
      const int nk = min(T32, L - kt * T32);
#pragma unroll 1
      for (int r = 0; r < ROWS; ++r) {
        const int qr = warp + r * 8;
        if (r0 + qr >= L) continue;  // warp-uniform
        float qv[DH];
#pragma unroll
        for (int d = 0; d < DH; ++d) qv[d] = Qs[qr * DH + d];
        for (int c = 0; c < nk; c += 32) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) s = fmaf(qv[d], Ks[(c + lane) * LK + d], s);
          s = __fmul_rn(s, scale);
          const bool valid = c + lane < nk;
          if (pass == 0) {
            if (valid) m[r] = fmaxf(m[r], s);
          } else if (pass == 1) {
            z[r] += valid ? expf(s - m[r]) : 0.f;
          } else {
            const float p = valid ? expf(s - m[r]) / z[r] : 0.f;
#pragma unroll 4
            for (int j = 0; j < 32; ++j) {
              const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
              for (int cc = 0; cc < CPL; ++cc)
                if (lane + cc * 32 < DH) acc[r][cc] = fmaf(pj, Vs[(c + j) * DH + lane + cc * 32], acc[r][cc]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (pass == 0) m[r] = warp_max(m[r]);
      if (pass == 1) z[r] = warp_sum(z[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = r0 + warp + r * 8;
    if (row >= L) continue;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
      if (lane + cc * 32 < DH) o[off + (long long)row * DH + lane + cc * 32] = acc[r][cc];
    if (lane == 0) lse[bh * L + row] = m[r] + logf(z[r]);
  }
}

// ---------------------------------------------------------------- backward
// delta[row] = sum_d do[row, d] * o[row, d] in fp32: one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta, long long rows,
                   int DH) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < DH; d += 32) s += to_f(dout[row * DH + d]) * to_f(o[row * DH + d]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// bf16 dq: 4 warps x 16 query rows; K and V of up to KT keys in shared memory.
// One walk over the keys: p = exp(s - lse), dp = do . v^T, ds = p (dp - delta)
// scale, dq += (ds_hi + ds_lo) . k.
template <int DH>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const bf16* __restrict__ dout, bf16* __restrict__ dq, int L, float scale, int kt_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [kt_rows][LDH]
  bf16* Vs = Ks + kt_rows * Head<DH>::LD;
  const int ntile = (L + RT - 1) / RT;
  const long long bh = blockIdx.x / ntile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long off = bh * L * DH;
  const int nkt = (L + KT - 1) / KT;
  const int q0 = (blockIdx.x % ntile) * RT + warp * 16;
  const int ra = q0 + (lane >> 2), rb = ra + 8;
  const bool active = q0 < L;
  unsigned qa[Head<DH>::KS][4], da[Head<DH>::KS][4];
  load_afrag<DH>(qa, q + off, ra, L, lane);
  load_afrag<DH>(da, dout + off, ra, L, lane);
  const float la = ra < L ? lse[bh * L + ra] : 0.f, lb = rb < L ? lse[bh * L + rb] : 0.f;
  const float ea = ra < L ? delta[bh * L + ra] : 0.f, eb = rb < L ? delta[bh * L + rb] : 0.f;
  float acc[Head<DH>::NT][4];
#pragma unroll
  for (int j = 0; j < Head<DH>::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_tile_bf16<DH>(Ks, k + off, kt * KT, kt_rows, L);
    load_tile_bf16<DH>(Vs, v + off, kt * KT, kt_rows, L);
    __syncthreads();
    const int nk = min(KT, L - kt * KT);
    if (!active) continue;
    for (int cb = 0; cb < nk; cb += 16) {
      float s[2][4], dp[2][4];
      prod16<DH>(s, qa, Ks, cb, lane);
      prod16<DH>(dp, da, Vs, cb, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = cb + j * 8 + (lane & 3) * 2 + (e & 1) < nk;
          const float p = valid ? expf(__fmul_rn(s[j][e], scale) - (e < 2 ? la : lb)) : 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? ea : eb)) * scale;  // ds
        }
      unsigned hi[4], lo[4];
      split_pack(s[0][0], s[0][1], hi[0], lo[0]);
      split_pack(s[0][2], s[0][3], hi[1], lo[1]);
      split_pack(s[1][0], s[1][1], hi[2], lo[2]);
      split_pack(s[1][2], s[1][3], hi[3], lo[3]);
      mma_rows<DH>(acc, hi, Ks, cb, lane);
      mma_rows<DH>(acc, lo, Ks, cb, lane);
    }
  }
  if (active) store_rows<DH>(dq + off, acc, ra, L, lane);
}

// bf16 dk, dv: 4 warps x 16 keys; queries in tiles of QT in shared memory (q,
// do, and each row's lse and delta). Per 16 queries the transposed products
// sT = k . q^T, dpT = v . do^T give pT and dsT in the accumulators, which
// go on as A fragments: dv += pT . do, dk += dsT . q (each split hi + lo).
template <int DH>
constexpr size_t dkdv_bf16_smem() { return sizeof(bf16) * 2 * QT * Head<DH>::LD + sizeof(float) * 2 * QT; }

template <int DH>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const bf16* __restrict__ dout, bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
                           float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [QT][LDH]
  bf16* Os = Qs + QT * Head<DH>::LD;            // do
  float* ql = reinterpret_cast<float*>(Os + QT * Head<DH>::LD);
  float* qd = ql + QT;
  const int ntile = (L + RT - 1) / RT;
  const long long bh = blockIdx.x / ntile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long off = bh * L * DH;
  const int k0 = (blockIdx.x % ntile) * RT + warp * 16;
  const int ka = k0 + (lane >> 2);
  unsigned kf[Head<DH>::KS][4], vf[Head<DH>::KS][4];
  load_afrag<DH>(kf, k + off, ka, L, lane);
  load_afrag<DH>(vf, v + off, ka, L, lane);
  float gk[Head<DH>::NT][4], gv[Head<DH>::NT][4];
#pragma unroll
  for (int j = 0; j < Head<DH>::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  for (int q0 = 0; q0 < L; q0 += QT) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile_bf16<DH>(Qs, q + off, q0, QT, L);
    load_tile_bf16<DH>(Os, dout + off, q0, QT, L);
    for (int r = tid; r < QT; r += 128) {
      ql[r] = q0 + r < L ? lse[bh * L + q0 + r] : 0.f;
      qd[r] = q0 + r < L ? delta[bh * L + q0 + r] : 0.f;
    }
    __syncthreads();
    if (k0 >= L) continue;  // warp-uniform; the barriers above are reached by all
    const int nq = min(QT, L - q0);
    for (int cb = 0; cb < nq; cb += 16) {
      float s[2][4], dp[2][4];
      prod16<DH>(s, kf, Qs, cb, lane);
      prod16<DH>(dp, vf, Os, cb, lane);
      // column (query) of fragment element e of n8 tile j: cb + j*8 + 2*(lane&3) + (e&1)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = cb + j * 8 + (lane & 3) * 2 + (e & 1);
          const float p = qr < nq ? expf(__fmul_rn(s[j][e], scale) - ql[qr]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - qd[qr]) * scale;  // dsT
        }
      unsigned ph[4], pl[4], sh[4], sl[4];
      split_pack(s[0][0], s[0][1], ph[0], pl[0]);
      split_pack(s[0][2], s[0][3], ph[1], pl[1]);
      split_pack(s[1][0], s[1][1], ph[2], pl[2]);
      split_pack(s[1][2], s[1][3], ph[3], pl[3]);
      split_pack(dp[0][0], dp[0][1], sh[0], sl[0]);
      split_pack(dp[0][2], dp[0][3], sh[1], sl[1]);
      split_pack(dp[1][0], dp[1][1], sh[2], sl[2]);
      split_pack(dp[1][2], dp[1][3], sh[3], sl[3]);
      mma_rows<DH>(gv, ph, Os, cb, lane);
      mma_rows<DH>(gv, pl, Os, cb, lane);
      mma_rows<DH>(gk, sh, Qs, cb, lane);
      mma_rows<DH>(gk, sl, Qs, cb, lane);
    }
  }
  if (k0 >= L) return;
  store_rows<DH>(dk + off, gk, ka, L, lane);
  store_rows<DH>(dv + off, gv, ka, L, lane);
}

// bf16, L <= 256: one block per sequence-head, one pass. K and V of the
// whole sequence land in shared memory by cp.async in the first group, q
// and do in chunks of QC = 64 rows, one group each, so that chunk 0
// computes while the later chunks land; meanwhile a thread a row reads that
// row's lse (times log2(e)) and forms delta = rowsum(do * o) from o and do
// in device memory (o is read for nothing else). Warp w owns the key strip
// 16 w .. 16 w + 15 (NB warps for L <= 16 NB) and, for each 16-query block
// of a chunk, holds the transposed scores s^T = k . q^T and dp^T = v . do^T
// of its keys in registers: p = exp(s scale - lse) as one FMA and one ex2
// per score, ds = p (dp - delta) scale in fp32, then dv += p^T . do and
// dk += ds^T . q (an m16n8 accumulator tile is an A fragment; p and ds each
// split hi + lo), and ds^T (hi and lo) goes to a [keys][chunk] tile. dk and
// dv stay in registers across the chunks. Once the chunk's tile is whole,
// warp w forms dq of query strip w % 4 of the chunk over the key group
// w / 4 (4 key blocks: every warp has the same share) from the tile by
// ldmatrix.trans; the groups' partials take the tiles' place and are added
// in group order, so dq is the same bits on every run, and written out.
template <int DH, int NB>
struct BwdStrip {
  static constexpr int NR = NB * 16, LD = Head<DH>::LD, QC = 64, LDT = QC + 8, NCH = NR / QC;
  static constexpr int G = NB / 4, KB = NB / G;  // key groups of the dq products, key blocks a group
  static constexpr int LDP = DH + 4;             // row of a dq partial (fp32)
  static constexpr bool REGS = DH <= 32;         // the strip's k and v A fragments held in registers
  // shared memory: Ks, Vs, Qs, Os (do) [NR][LD]; DsH, DsL [NR][LDT] (the dq partials [G][QC][LDP]
  // in their place); lse * log2(e) and delta [NR] fp32
  static constexpr size_t TILE = sizeof(bf16) * NR * LD, DS = sizeof(bf16) * NR * LDT;
  static constexpr size_t OFF_DS = 4 * TILE, OFF_F = OFF_DS + 2 * DS, SMEM = OFF_F + sizeof(float) * 2 * NR;
  static_assert(sizeof(float) * G * QC * LDP <= 2 * DS, "the dq partials fit in the ds tiles");
};

// cp.async.wait_group n for a run-time n in 0 .. 3
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

template <int DH, int NB>
__global__ void __launch_bounds__(32 * NB, NB == 8 ? 2 : 1)
flash_bwd_strip_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                            const bf16* __restrict__ o, const float* __restrict__ lse,
                            const bf16* __restrict__ dout, bf16* __restrict__ dq, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int L, float scale) {
  using S = BwdStrip<DH, NB>;
  constexpr int LD = S::LD, QC = S::QC, LDT = S::LDT, LDP = S::LDP, NT = Head<DH>::NT, KS = Head<DH>::KS;
  constexpr int CW = chunk_cols<DH>(), C = DH / CW;  // chunks a row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + S::NR * LD;
  bf16* Qs = Vs + S::NR * LD;
  bf16* Os = Qs + S::NR * LD;
  bf16* DsH = reinterpret_cast<bf16*>(smem + S::OFF_DS);
  bf16* DsL = DsH + S::NR * LDT;
  float* P = reinterpret_cast<float*>(smem + S::OFF_DS);
  float* lL = reinterpret_cast<float*>(smem + S::OFF_F);  // lse * log2(e), +inf past L (p = 0 there)
  float* dl = lL + S::NR;                                 // delta, 0 past L
  const long long bh = blockIdx.x, off = bh * L * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q4 = lane & 3;
  const int k0 = warp * 16, nkw = (L + 15) / 16;     // this warp's keys; key blocks with keys
  const bool keys = k0 < L, edge = k0 + 16 > L;      // warp-uniform
  const float LOG2E = 1.4426950408889634f, c2 = scale * LOG2E;

  auto fetch = [&](bf16* dst, const bf16* src, int r0, int n) {  // rows r0 .. r0 + n - 1, zero past L
    for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
      const int r = r0 + e / C, c = (e % C) * CW;
      cp_async_chunk<DH>(dst + r * LD + c, src + off + (long long)min(r, L - 1) * DH + c, r < L);
    }
  };
  fetch(Ks, k, 0, S::NR);
  fetch(Vs, v, 0, S::NR);
#pragma unroll
  for (int ci = 0; ci < S::NCH; ++ci) {  // one group a chunk (empty past L), so that every chunk waits alike
    if (ci * QC < L) {
      fetch(Qs, q, ci * QC, QC);
      fetch(Os, dout, ci * QC, QC);
    }
    cp_async_commit();
  }
  if (threadIdx.x < S::NR) {
    const int r = threadIdx.x;
    float d = 0.f, l = __int_as_float(0x7f800000);
    if (r < L) {
      l = lse[bh * L + r] * LOG2E;
      const bf16 *orow = o + off + (long long)r * DH, *drow = dout + off + (long long)r * DH;
#pragma unroll
      for (int c = 0; c < DH; c += CW) {
        const Chunk<DH> a = *reinterpret_cast<const Chunk<DH>*>(orow + c);
        const Chunk<DH> b = *reinterpret_cast<const Chunk<DH>*>(drow + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) {
          const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
          d = fmaf(y.x, x.x, d);
          d = fmaf(y.y, x.y, d);
        }
      }
    }
    lL[r] = l;
    dl[r] = d;
  }
  cp_async_wait<S::NCH - 1>();
  __syncthreads();  // K, V, chunk 0, lse and delta are in place

  unsigned kf[S::REGS ? KS : 1][4], vf[S::REGS ? KS : 1][4];
  if constexpr (S::REGS) {
    if (keys) {
      afrag_smem<DH>(kf, Ks, k0, lane);
      afrag_smem<DH>(vf, Vs, k0, lane);
    }
  }
  float gk[NT][4], gv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  for (int ci = 0, q0 = 0; q0 < L; ++ci, q0 += QC) {
    if (ci > 0) {
      cp_async_wait_upto(S::NCH - 1 - ci);
      __syncthreads();  // chunk ci landed; the previous chunk's dq partials are read
    }
    if (keys) {
#pragma unroll
      for (int qb = 0; qb < QC / 16; ++qb) {
        const int c0 = q0 + qb * 16;  // the block's first query
        if (c0 >= L) break;           // warp-uniform
        // s^T, dp^T [keys][queries]: element (j, e) is key k0 + g8 + 8 (e / 2), query c0 + 8 j + 2 q4 + e % 2
        float s[2][4], dp[2][4];
        if constexpr (S::REGS) {
          prod16<DH>(s, kf, Qs, c0, lane);
          prod16<DH>(dp, vf, Os, c0, lane);
        } else {
          prod16_smem<DH>(s, Ks, k0, Qs, c0, lane);
          prod16_smem<DH>(dp, Vs, k0, Os, c0, lane);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lL + c0 + 8 * j + 2 * q4);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + c0 + 8 * j + 2 * q4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2_approx(fmaf(s[j][e], c2, -(e & 1 ? l2.y : l2.x)));
            if (edge && k0 + g8 + 8 * (e >> 1) >= L) p = 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - (e & 1 ? d2.y : d2.x)) * scale;  // ds
          }
        }
        unsigned ph[4], pl[4], sh[4], sl[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          split_pack(s[j][0], s[j][1], ph[2 * j], pl[2 * j]);
          split_pack(s[j][2], s[j][3], ph[2 * j + 1], pl[2 * j + 1]);
          split_pack(dp[j][0], dp[j][1], sh[2 * j], sl[2 * j]);
          split_pack(dp[j][2], dp[j][3], sh[2 * j + 1], sl[2 * j + 1]);
        }
        mma_rows<DH>(gv, ph, Os, c0, lane);
        mma_rows<DH>(gv, pl, Os, c0, lane);
        mma_rows<DH>(gk, sh, Qs, c0, lane);
        mma_rows<DH>(gk, sl, Qs, c0, lane);
        bf16* th = DsH + (k0 + g8) * LDT + qb * 16 + 2 * q4;
        bf16* tl = DsL + (k0 + g8) * LDT + qb * 16 + 2 * q4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          *reinterpret_cast<unsigned*>(th + j * 8) = sh[2 * j];
          *reinterpret_cast<unsigned*>(th + 8 * LDT + j * 8) = sh[2 * j + 1];
          *reinterpret_cast<unsigned*>(tl + j * 8) = sl[2 * j];
          *reinterpret_cast<unsigned*>(tl + 8 * LDT + j * 8) = sl[2 * j + 1];
        }
      }
    }
    __syncthreads();  // the chunk's ds tiles are whole

    // dq of query strip qs over key group kg: ds [queries][keys] from the tiles (transposed) . k
    const int qs = warp & 3, kg = warp >> 2;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    if (q0 + 16 * qs < L) {
      const int ar = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int i = 0; i < S::KB; ++i) {
        const int cb = kg * S::KB + i;
        if (cb >= nkw) break;  // warp-uniform
        unsigned ah[4], al[4];
        ldmatrix_x4_trans(ah, DsH + (cb * 16 + ar) * LDT + 16 * qs + ac);
        ldmatrix_x4_trans(al, DsL + (cb * 16 + ar) * LDT + 16 * qs + ac);
        mma_rows<DH>(acc, ah, Ks, cb * 16, lane);
        mma_rows<DH>(acc, al, Ks, cb * 16, lane);
      }
    }
    __syncthreads();  // the ds tiles are read: the partials take their place
    float* pw = P + (kg * QC + 16 * qs + g8) * LDP + 2 * q4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<float2*>(pw + 8 * j) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(pw + 8 * LDP + 8 * j) = make_float2(acc[j][2], acc[j][3]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < QC * DH / 2; e += blockDim.x) {  // the groups' partials in order
      const int r = e / (DH / 2), d = (e % (DH / 2)) * 2;
      if (q0 + r >= L) break;  // rows ascend with e
      float2 x = *reinterpret_cast<const float2*>(P + r * LDP + d);
#pragma unroll
      for (int gg = 1; gg < S::G; ++gg) {
        const float2 y = *reinterpret_cast<const float2*>(P + (gg * QC + r) * LDP + d);
        x.x += y.x;
        x.y += y.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(dq + off + (long long)(q0 + r) * DH + d) = __floats2bfloat162_rn(x.x, x.y);
    }
  }
  if (keys) {
    store_rows<DH>(dk + off, gk, k0 + g8, L, lane);
    store_rows<DH>(dv + off, gv, k0 + g8, L, lane);
  }
}

// fp32 dq: 8 warps x 8 query rows; lane j takes key c + j and owns output
// columns j, j + 32. K and V (DH + 1-word rows) of T32 keys in shared memory.
template <int DH>
constexpr size_t dq_f32_smem() { return sizeof(float) * 2 * T32 * (DH + 1); }

template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ dout, float* __restrict__ dq, int L, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LK = DH + 1, CPL = (DH + 31) / 32, ROWS = RT / 8;
  float* Ks = reinterpret_cast<float*>(smem);  // [T32][LK]
  float* Vs = Ks + T32 * LK;
  const int ntile = (L + RT - 1) / RT;
  const long long bh = blockIdx.x / ntile;
  const int r0 = (blockIdx.x % ntile) * RT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long off = bh * L * DH;
  float acc[ROWS][CPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += T32) {
    __syncthreads();
    for (int e = tid; e < T32 * DH; e += 256) {
      const int r = e / DH, d = e % DH, key = k0 + r;
      Ks[r * LK + d] = key < L ? k[off + (long long)key * DH + d] : 0.f;
      Vs[r * LK + d] = key < L ? v[off + (long long)key * DH + d] : 0.f;
    }
    __syncthreads();
    const int nk = min(T32, L - k0);
#pragma unroll 1
    for (int r = 0; r < ROWS; ++r) {
      const int row = r0 + warp + r * 8;
      if (row >= L) continue;  // warp-uniform
      float qv[DH], dv[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qv[d] = q[off + (long long)row * DH + d];
        dv[d] = dout[off + (long long)row * DH + d];
      }
      const float l = lse[bh * L + row], dl = delta[bh * L + row];
      for (int c = 0; c < nk; c += 32) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          s = fmaf(qv[d], Ks[(c + lane) * LK + d], s);
          dp = fmaf(dv[d], Vs[(c + lane) * LK + d], dp);
        }
        const float p = c + lane < nk ? expf(__fmul_rn(s, scale) - l) : 0.f;
        const float ds = p * (dp - dl) * scale;
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const float dj = __shfl_sync(FULL, ds, j);
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
            if (lane + cc * 32 < DH) acc[r][cc] = fmaf(dj, Ks[(c + j) * LK + lane + cc * 32], acc[r][cc]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = r0 + warp + r * 8;
    if (row >= L) continue;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
      if (lane + cc * 32 < DH) dq[off + (long long)row * DH + lane + cc * 32] = acc[r][cc];
  }
}

// fp32 dk, dv: 8 warps x 8 keys; lane j takes query c + j. Queries in tiles
// of T32: q and do (DH + 1-word rows), lse, delta.
template <int DH>
constexpr size_t dkdv_f32_smem() { return sizeof(float) * (2 * T32 * (DH + 1) + 2 * T32); }

template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv, int L,
                          float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LK = DH + 1, CPL = (DH + 31) / 32, ROWS = RT / 8;
  float* Qs = reinterpret_cast<float*>(smem);  // [T32][LK]
  float* Os = Qs + T32 * LK;
  float* ql = Os + T32 * LK;
  float* qd = ql + T32;
  const int ntile = (L + RT - 1) / RT;
  const long long bh = blockIdx.x / ntile;
  const int r0 = (blockIdx.x % ntile) * RT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long off = bh * L * DH;
  float gk[ROWS][CPL], gv[ROWS][CPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) gk[r][c] = gv[r][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += T32) {
    __syncthreads();
    for (int e = tid; e < T32 * DH; e += 256) {
      const int r = e / DH, d = e % DH, qr = q0 + r;
      Qs[r * LK + d] = qr < L ? q[off + (long long)qr * DH + d] : 0.f;
      Os[r * LK + d] = qr < L ? dout[off + (long long)qr * DH + d] : 0.f;
    }
    for (int r = tid; r < T32; r += 256) {
      ql[r] = q0 + r < L ? lse[bh * L + q0 + r] : 0.f;
      qd[r] = q0 + r < L ? delta[bh * L + q0 + r] : 0.f;
    }
    __syncthreads();
    const int nq = min(T32, L - q0);
#pragma unroll 1
    for (int r = 0; r < ROWS; ++r) {
      const int key = r0 + warp + r * 8;
      if (key >= L) continue;  // warp-uniform
      float kv[DH], vv[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        kv[d] = k[off + (long long)key * DH + d];
        vv[d] = v[off + (long long)key * DH + d];
      }
      for (int c = 0; c < nq; c += 32) {
        const int qr = c + lane;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          s = fmaf(kv[d], Qs[qr * LK + d], s);
          dp = fmaf(vv[d], Os[qr * LK + d], dp);
        }
        const float p = qr < nq ? expf(__fmul_rn(s, scale) - ql[qr]) : 0.f;
        const float ds = p * (dp - qd[qr]) * scale;
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const float pj = __shfl_sync(FULL, p, j), dj = __shfl_sync(FULL, ds, j);
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
            if (lane + cc * 32 < DH) {
              gv[r][cc] = fmaf(pj, Os[(c + j) * LK + lane + cc * 32], gv[r][cc]);
              gk[r][cc] = fmaf(dj, Qs[(c + j) * LK + lane + cc * 32], gk[r][cc]);
            }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int key = r0 + warp + r * 8;
    if (key >= L) continue;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
      if (lane + cc * 32 < DH) {
        dk[off + (long long)key * DH + lane + cc * 32] = gk[r][cc];
        dv[off + (long long)key * DH + lane + cc * 32] = gv[r][cc];
      }
  }
}

// ---------------------------------------------------------------- launchers
// The bf16 forward's route: the strip kernel for L <= STRIP_MAX_L, one block
// of STRIP_WARPS warps per sequence-head (all its strips, K and V loaded
// once); three passes beyond. Measured on the H100 (PERF.md): 2 warps
// a block beat 1, 4 and 8, and one block per sequence-head beat 64 or 128
// query rows a block, at both training shapes.
constexpr int STRIP_MAX_L = 256;
constexpr int STRIP_WARPS = 2;

// One launch of a bf16 kernel at L: the kernel (its shared-memory limit
// raised once), key blocks held in registers (0: the multi-pass route),
// threads, query rows and dynamic shared bytes a block.
struct Plan {
  const void* fn;
  int nb, threads, rows;
  size_t smem;
  cudaError_t err;
};

template <int DH, int NB>
Plan strip_plan() {
  static const cudaError_t e = cudaFuncSetAttribute(flash_fwd_strip_bf16_kernel<DH, NB>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    (int)strip_smem<DH, NB>());
  return {reinterpret_cast<const void*>(flash_fwd_strip_bf16_kernel<DH, NB>), NB, 32 * STRIP_WARPS, NB * 16,
          strip_smem<DH, NB>(), e};
}

template <int DH>
Plan plan_fwd_bf16(int L) {
  if (L <= 128) return strip_plan<DH, 8>();
  if (L <= STRIP_MAX_L) return strip_plan<DH, 16>();
  static bool ready = false;
  const cudaError_t e = allow_smem(flash_fwd_bf16_kernel<DH>, sizeof(bf16) * 2 * KT * Head<DH>::LD, ready);
  return {reinterpret_cast<const void*>(flash_fwd_bf16_kernel<DH>), 0, 128, RT,
          sizeof(bf16) * 2 * ((min(L, KT) + 15) / 16 * 16) * Head<DH>::LD, e};
}

template <int DH>
cudaError_t launch_fwd(int bf, const void* q, const void* k, const void* v, void* o, float* lse, int BH, int L,
                       float scale, cudaStream_t st) {
  if (L < 1) return cudaErrorInvalidValue;
  if (bf) {
    const Plan p = plan_fwd_bf16<DH>(L);
    if (p.err != cudaSuccess) return p.err;
    const unsigned blocks = (unsigned)((long long)BH * ((L + p.rows - 1) / p.rows));
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k), *vb = static_cast<const bf16*>(v);
    bf16* ob = static_cast<bf16*>(o);
    if (p.nb == 8)
      flash_fwd_strip_bf16_kernel<DH, 8><<<blocks, p.threads, p.smem, st>>>(qb, kb, vb, ob, lse, L, scale);
    else if (p.nb == 16)
      flash_fwd_strip_bf16_kernel<DH, 16><<<blocks, p.threads, p.smem, st>>>(qb, kb, vb, ob, lse, L, scale);
    else
      flash_fwd_bf16_kernel<DH><<<blocks, p.threads, p.smem, st>>>(qb, kb, vb, ob, lse, L, scale,
                                                                    (min(L, KT) + 15) / 16 * 16);
  } else {
    static bool ready = false;
    const unsigned blocks = (unsigned)((long long)BH * ((L + RT - 1) / RT));
    cudaError_t e;
    if ((e = allow_smem(flash_fwd_f32_kernel<DH>, fwd_f32_smem<DH>(), ready)) != cudaSuccess) return e;
    flash_fwd_f32_kernel<DH><<<blocks, 256, fwd_f32_smem<DH>(), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, L, scale);
  }
  return cudaGetLastError();
}

// a *_info entry point's seven fields for the launch p describes
inline cudaError_t plan_info(const Plan& p, int* info) {
  if (p.err != cudaSuccess) return p.err;
  info[0] = p.nb;
  info[1] = p.threads;
  info[2] = p.rows;
  info[3] = (int)p.smem;
  return kernel_info(p.fn, p.threads, p.smem, info + 4);
}

template <int DH, int NB>
Plan bwd_strip_plan() {
  using S = BwdStrip<DH, NB>;
  static const cudaError_t e = cudaFuncSetAttribute(flash_bwd_strip_bf16_kernel<DH, NB>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  return {reinterpret_cast<const void*>(flash_bwd_strip_bf16_kernel<DH, NB>), NB, 32 * NB, S::NR, S::SMEM, e};
}

// The bf16 backward's route: the strip kernel for L <= STRIP_MAX_L, one
// block of NB warps per sequence-head; beyond, the three kernels (reported
// by the dq kernel).
template <int DH>
Plan plan_bwd_bf16(int L) {
  if (L <= 128) return bwd_strip_plan<DH, 8>();
  if (L <= STRIP_MAX_L) return bwd_strip_plan<DH, 16>();
  static bool ready = false;
  const size_t smem = sizeof(bf16) * 2 * KT * Head<DH>::LD;
  const cudaError_t e = allow_smem(flash_bwd_dq_bf16_kernel<DH>, smem, ready);
  return {reinterpret_cast<const void*>(flash_bwd_dq_bf16_kernel<DH>), 0, 128, RT, smem, e};
}

template <int DH>
cudaError_t launch_bwd(int bf, const void* q, const void* k, const void* v, const void* o, const float* lse,
                       const void* dout, float* delta, void* dq, void* dk, void* dv, int BH, int L, float scale,
                       cudaStream_t st) {
  if (L < 1) return cudaErrorInvalidValue;
  const long long rows = (long long)BH * L;
  const unsigned blocks = (unsigned)((long long)BH * ((L + RT - 1) / RT));
  const unsigned dblocks = (unsigned)((rows + 7) / 8);
  cudaError_t e;
  if (bf) {
    static bool ready_k = false;
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k), *vb = static_cast<const bf16*>(v);
    const bf16 *ob = static_cast<const bf16*>(o), *db = static_cast<const bf16*>(dout);
    bf16 *dqb = static_cast<bf16*>(dq), *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
    const Plan p = plan_bwd_bf16<DH>(L);
    if (p.err != cudaSuccess) return p.err;
    if (p.nb == 8)
      flash_bwd_strip_bf16_kernel<DH, 8><<<BH, p.threads, p.smem, st>>>(qb, kb, vb, ob, lse, db, dqb, dkb, dvb, L,
                                                                        scale);
    else if (p.nb == 16)
      flash_bwd_strip_bf16_kernel<DH, 16><<<BH, p.threads, p.smem, st>>>(qb, kb, vb, ob, lse, db, dqb, dkb, dvb, L,
                                                                         scale);
    if (p.nb) return cudaGetLastError();
    if (!delta) return cudaErrorInvalidValue;
    flash_delta_kernel<bf16><<<dblocks, 256, 0, st>>>(ob, db, delta, rows, DH);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const int kt_rows = (min(L, KT) + 15) / 16 * 16;
    flash_bwd_dq_bf16_kernel<DH><<<blocks, 128, sizeof(bf16) * 2 * kt_rows * Head<DH>::LD, st>>>(
        qb, kb, vb, lse, delta, db, dqb, L, scale, kt_rows);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = allow_smem(flash_bwd_dkdv_bf16_kernel<DH>, dkdv_bf16_smem<DH>(), ready_k)) != cudaSuccess) return e;
    flash_bwd_dkdv_bf16_kernel<DH><<<blocks, 128, dkdv_bf16_smem<DH>(), st>>>(qb, kb, vb, lse, delta, db, dkb, dvb,
                                                                              L, scale);
  } else {
    if (!delta) return cudaErrorInvalidValue;
    static bool ready_q = false, ready_k = false;
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k);
    const float *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
    flash_delta_kernel<float><<<dblocks, 256, 0, st>>>(static_cast<const float*>(o), df, delta, rows, DH);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = allow_smem(flash_bwd_dq_f32_kernel<DH>, dq_f32_smem<DH>(), ready_q)) != cudaSuccess) return e;
    flash_bwd_dq_f32_kernel<DH><<<blocks, 256, dq_f32_smem<DH>(), st>>>(qf, kf, vf, lse, delta, df,
                                                                         static_cast<float*>(dq), L, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = allow_smem(flash_bwd_dkdv_f32_kernel<DH>, dkdv_f32_smem<DH>(), ready_k)) != cudaSuccess) return e;
    flash_bwd_dkdv_f32_kernel<DH><<<blocks, 256, dkdv_f32_smem<DH>(), st>>>(
        qf, kf, vf, lse, delta, df, static_cast<float*>(dk), static_cast<float*>(dv), L, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o [BH, L, dh] (bf16 when bf16 else fp32), lse [BH, L] fp32 = flash forward
// of q, k, v [BH, L, dh] (same type); dh in {4, 8, 16, 32, 48, 64}.
int cse_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bf, int BH, int L, int dh,
                  float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return by_head_width(FlashHeadWidths{}, dh, [&](auto w) {
    return launch_fwd<decltype(w)::value>(bf, q, k, v, o, l, BH, L, scale, st);
  });
}

// info[7] of the bf16 forward cse_flash_fwd launches at (L, dh): key blocks
// held in registers (0: three passes), threads, query rows a block, dynamic
// shared bytes, registers a thread, local-memory bytes a thread, resident
// blocks per SM.
int cse_flash_fwd_info(int L, int dh, int* info) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  return by_head_width(FlashHeadWidths{}, dh,
                       [&](auto w) { return plan_info(plan_fwd_bf16<decltype(w)::value>(L), info); });
}

// dq, dk, dv [BH, L, dh] of the flash attention from q, k, v, o, do (all one
// type) and lse [BH, L]; delta [BH, L] fp32 is scratch (rowsum(do * o)) of
// the three-kernel routes (fp32, and bf16 at L > 256), null on the bf16
// strip route.
int cse_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse, const void* dout,
                  void* delta, void* dq, void* dk, void* dv, int bf, int BH, int L, int dh, float scale,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  return by_head_width(FlashHeadWidths{}, dh, [&](auto w) {
    return launch_bwd<decltype(w)::value>(bf, q, k, v, o, l, dout, dl, dq, dk, dv, BH, L, scale, st);
  });
}

// info[7] of the bf16 backward cse_flash_bwd launches at (L, dh), in
// cse_flash_fwd_info's order: key blocks of the strip (0: the three kernels,
// reported by the dq kernel), threads, query rows a block, dynamic shared
// bytes, registers a thread, local-memory bytes a thread, resident blocks
// per SM.
int cse_flash_bwd_info(int L, int dh, int* info) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  return by_head_width(FlashHeadWidths{}, dh,
                       [&](auto w) { return plan_info(plan_bwd_bf16<decltype(w)::value>(L), info); });
}

}  // extern "C"
