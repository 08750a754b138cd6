// Device helpers shared by the kernel sources: type conversion, warp
// reductions, streaming loads and stores, cp.async, one-dimensional bulk
// copies, ldmatrix and the bf16 mma.sync m16n8k16, the
// head-width fragments of the attention kernels (head width 4 or any multiple
// of 8: the columns of a k-step past the head are zeroed inside the
// fragment), ex2, the
// row max and exp of a warp's score strip, the staging of fp32 rows as bf16
// tiles, Hopper's mbarrier, TMA and wgmma (bf16 and s8) with the TMA ring,
// the operand descriptors, the swizzled epilogue tile and the
// warp-specialised register hand-over of the wgmma kernels (and their
// host-side tensor maps), a kernel's attributes and
// occupancy, and the fixed-order column reduction that turns per-block
// partial sums into one row (every cross-block sum of the port goes through
// it, so no result depends on the order in which blocks run).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as jnp.astype(bfloat16) and torch.to(bfloat16)
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
// N warp sums side by side: each value's butterfly is warp_sum's, the
// shuffles of the N interleaved
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(FULL, v[i], o);
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Loads and stores with the streaming hint (ld/st .cs: evict-first in L1 and
// L2), for data a kernel touches once: a value as fp32; VEC (1 or 4)
// consecutive values from fp32, VEC 4 as one 16-byte (fp32) or 8-byte (bf16)
// store.
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_stream(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}
template <int VEC>
__device__ __forceinline__ void st_stream(float* p, const float* v) {
  if constexpr (VEC == 4) __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else __stcs(p, v[0]);
}
template <int VEC>
__device__ __forceinline__ void st_stream(bf16* p, const float* v) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(*reinterpret_cast<const unsigned*>(&a), *reinterpret_cast<const unsigned*>(&b)));
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem), "r"(n));
}
// 8 bytes (a row of a head of width 4 in bf16), through L1
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool pred) {
  const int n = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. With .trans each thread gets a column pair instead.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// d += a[16x16] . b[16x8], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------- head widths
// A head of HD columns (HD % 8 == 0, or HD == 4) on mma.sync m16n8k16: a
// product that contracts over the head takes KS k-steps of 16, the last one
// half zero when the head ends eight columns into it (its upper eight columns
// are set to zero in both fragments, so the padding columns of a
// shared-memory tile are never read into a sum); a product whose output spans
// the head has NT n8 tiles. Tiles in shared memory are bf16 rows of LD
// elements (ldmatrix without bank conflicts). Head width 4 is staged in a
// Head<8>-shaped tile (W = 8 columns, of which 4 .. 7 are never written):
// its one k-step zeroes its upper twelve columns in both fragments (QUARTER:
// the lanes whose column pair lies at 4 .. 7 as well as HALF's eight), and
// its one n8 output tile is stored only in its first four columns (in_head).
template <int HD>
struct Head {
  static_assert((HD % 8 == 0 && HD >= 8) || HD == 4, "head width must be 4 or a multiple of 8");
  static constexpr int W = HD < 8 ? 8 : HD;  // columns a fragment spans
  static constexpr int KS = (W + 15) / 16;
  static constexpr int NT = W / 8;
  static constexpr int LD = W + 8;
  static constexpr bool HALF = W % 16 == 8;
  static constexpr bool QUARTER = HD % 8 != 0;
};

// whether this lane's column pair c0 + 2 (lane % 4), + 1 of an eight-column
// group starting at c0 (an n8 tile's, or a k-step half's) lies in the head;
// always, for a head width that is a multiple of 8
template <int HD>
__device__ __forceinline__ bool in_head(int c0, int lane) {
  return HD % 8 == 0 || c0 + 2 * (lane & 3) < HD;
}

// The head widths the attention kernels are instantiated for, listed once:
// HeadWidths (ops/fused_stack.py::HEAD_WIDTHS), for the flash kernels
// FlashHeadWidths (ops/attention.py::HEAD_WIDTHS) and for the tool's
// KpHeadWidths (ops/kernel_parts.py::HEAD_WIDTHS). by_head_width(list, hd, f)
// returns (int)f(std::integral_constant<int, HD>{}) for the listed HD equal to
// hd, and cudaErrorInvalidValue for any other hd.
template <int... W>
struct Widths {};
using HeadWidths = Widths<4, 8, 16, 32, 64>;
using FlashHeadWidths = Widths<4, 8, 16, 32, 48, 64>;
// the kernel-parts tool's attention (kernel_parts.cu), at the widths of its own runs
using KpHeadWidths = Widths<8, 16, 32, 64>;

template <int... W, class F>
int by_head_width(Widths<W...>, int hd, F&& f) {
  int r = (int)cudaErrorInvalidValue;
  (void)((hd == W && (r = (int)f(std::integral_constant<int, W>{}), true)) || ...);
  return r;
}

// s[j] = X . Ys^T for the 16 rows cb .. cb + 15 of Ys [.][LD] (n8 tiles j = 0, 1);
// xa: the A fragments of 16 rows of X over the head
template <int HD>
__device__ __forceinline__ void prod16(float (&s)[2][4], const unsigned (&xa)[Head<HD>::KS][4], const bf16* Ys,
                                       int cb, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Head<HD>::KS; ++ks) {
    unsigned f[4];  // {b0, b1} of rows cb .. cb + 7, then of rows cb + 8 .. cb + 15
    ldmatrix_x4(f, Ys + (cb + (lane & 7) + ((lane >> 4) << 3)) * Head<HD>::LD + ks * 16 + ((lane >> 3) & 1) * 8);
    if (Head<HD>::HALF && ks == Head<HD>::KS - 1) f[1] = f[3] = 0u;
    if (Head<HD>::QUARTER && !in_head<HD>(0, lane)) f[0] = f[2] = 0u;
    mma_bf16_16816(s[0], xa[ks], f[0], f[1]);
    mma_bf16_16816(s[1], xa[ks], f[2], f[3]);
  }
}

// prod16 with the A fragments of rows r0 .. r0 + 15 of Xs [.][LD] read a
// k-step at a time from shared memory (4 registers instead of 4 KS)
template <int HD>
__device__ __forceinline__ void prod16_smem(float (&s)[2][4], const bf16* Xs, int r0, const bf16* Ys, int cb,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Head<HD>::KS; ++ks) {
    unsigned a[4], f[4];
    ldmatrix_x4(a, Xs + (r0 + (lane & 15)) * Head<HD>::LD + ks * 16 + (lane >> 4) * 8);
    ldmatrix_x4(f, Ys + (cb + (lane & 7) + ((lane >> 4) << 3)) * Head<HD>::LD + ks * 16 + ((lane >> 3) & 1) * 8);
    if (Head<HD>::HALF && ks == Head<HD>::KS - 1) a[2] = a[3] = f[1] = f[3] = 0u;
    if (Head<HD>::QUARTER && !in_head<HD>(0, lane)) a[0] = a[1] = f[0] = f[2] = 0u;
    mma_bf16_16816(s[0], a, f[0], f[1]);
    mma_bf16_16816(s[1], a, f[2], f[3]);
  }
}

// acc[HD / 8] += A[16 x 16] . Zs[cb .. cb + 15][0 .. HD)  (Zs row-major [.][LD])
template <int HD>
__device__ __forceinline__ void mma_rows(float (&acc)[Head<HD>::NT][4], const unsigned (&a)[4], const bf16* Zs,
                                         int cb, int lane) {
#pragma unroll
  for (int d2 = 0; d2 < Head<HD>::KS; ++d2) {
    unsigned f[4];
    ldmatrix_x4_trans(f, Zs + (cb + (lane & 15)) * Head<HD>::LD + d2 * 16 + (lane >> 4) * 8);
    mma_bf16_16816(acc[d2 * 2], a, f[0], f[1]);
    if (d2 * 2 + 1 < Head<HD>::NT) mma_bf16_16816(acc[d2 * 2 + 1], a, f[2], f[3]);
  }
}

// The A fragments of 16 rows (r0 .. r0 + 15) of a bf16 tile [.][LD] in shared memory
template <int HD>
__device__ __forceinline__ void afrag_smem(unsigned (&f)[Head<HD>::KS][4], const bf16* Xs, int r0, int lane) {
#pragma unroll
  for (int ks = 0; ks < Head<HD>::KS; ++ks) {
    ldmatrix_x4(f[ks], Xs + (r0 + (lane & 15)) * Head<HD>::LD + ks * 16 + (lane >> 4) * 8);
    if (Head<HD>::HALF && ks == Head<HD>::KS - 1) f[ks][2] = f[ks][3] = 0u;
    if (Head<HD>::QUARTER && !in_head<HD>(0, lane)) f[ks][0] = f[ks][1] = 0u;
  }
}

// The A fragments of rows ra and ra + 8 from fp32 rows in device memory
// (row r at x + r * stride, the head's columns 0 .. HD), times mul, rounded
// to bf16; zero for rows >= L and columns >= HD
template <int HD>
__device__ __forceinline__ void afrag_f32(unsigned (&f)[Head<HD>::KS][4], const float* x, long long stride, int ra,
                                          int L, float mul, int lane) {
  const int rb = ra + 8;
#pragma unroll
  for (int ks = 0; ks < Head<HD>::KS; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int d = ks * 16 + hi * 8 + (lane & 3) * 2;
      float2 xa = make_float2(0.f, 0.f), xb = xa;
      if (ks * 16 + hi * 8 < HD && in_head<HD>(ks * 16 + hi * 8, lane)) {
        if (ra < L) xa = *reinterpret_cast<const float2*>(x + (long long)ra * stride + d);
        if (rb < L) xb = *reinterpret_cast<const float2*>(x + (long long)rb * stride + d);
      }
      f[ks][hi * 2] = pack_bf16(xa.x * mul, xa.y * mul);
      f[ks][hi * 2 + 1] = pack_bf16(xb.x * mul, xb.y * mul);
    }
}

// 2^x on the special-function unit, one instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A warp's strip of scores s[NB][2][4]: 16 rows against NB blocks of 16 keys,
// the m16n8 accumulators of two n8 tiles a block. Elements e < 2 belong to
// row lane / 4, e >= 2 to row lane / 4 + 8; the four lanes of a quad share a
// row. The reductions keep four partials a row, so that no chain of
// dependent instructions runs through all NB blocks.
template <int NB>
__device__ __forceinline__ void strip_row_max(const float (&s)[NB][2][4], float (&m)[2]) {
  float mx[2][2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j) mx[h][j][0] = mx[h][j][1] = __int_as_float(0xff800000);
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1][j][e & 1] = fmaxf(mx[e >> 1][j][e & 1], s[cb][j][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(fmaxf(mx[h][0][0], mx[h][0][1]), fmaxf(mx[h][1][0], mx[h][1][1]));
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) m[h] = fmaxf(m[h], __shfl_xor_sync(FULL, m[h], x));
  }
}

// p = exp(s - m) in place of the scores, once per score, as 2^(s c - m c)
// in one FMA and one ex2 (c = log2(e) times the scale the scores still
// lack); with SUM also z = sum p over each row.
template <int NB, bool SUM>
__device__ __forceinline__ void strip_exp(float (&s)[NB][2][4], const float (&m)[2], float c, float (&z)[2]) {
  const float nm[2] = {-m[0] * c, -m[1] * c};
  float zz[2][2][2] = {};
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[cb][j][e] = ex2_approx(fmaf(s[cb][j][e], c, nm[e >> 1]));
        if (SUM) zz[e >> 1][j][e & 1] += s[cb][j][e];
      }
  if constexpr (SUM) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      z[h] = (zz[h][0][0] + zz[h][0][1]) + (zz[h][1][0] + zz[h][1][1]);
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) z[h] += __shfl_xor_sync(FULL, z[h], x);
    }
  }
}

// Rows 0 .. NR - 1 of NU fp32 sources (row r of source u at src[u] + r *
// stride[u], columns 0 .. HD), zero from row L on, handed to put(u, r, c,
// float4) four columns at a time: HD / 4 lanes to a row (eight lanes to a
// row's 128 bytes at HD 32), BATCH rows' loads a thread in flight, so that
// the block waits on the memory once per batch and not once per load.
template <int HD, int NR, int BATCH, int NU, class Put>
__device__ __forceinline__ void stage_rows(const float* const (&src)[NU], const long long (&stride)[NU], int L,
                                           Put&& put) {
  constexpr int C = HD / 4, N = NR * C;
  for (int e0 = threadIdx.x; e0 < N; e0 += BATCH * blockDim.x) {
    float4 t[BATCH][NU];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * blockDim.x, r = e / C, c = (e % C) * 4;
#pragma unroll
      for (int u = 0; u < NU; ++u)
        t[b][u] = e < N && r < L ? *reinterpret_cast<const float4*>(src[u] + r * stride[u] + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * blockDim.x, r = e / C, c = (e % C) * 4;
      if (e >= N) continue;
#pragma unroll
      for (int u = 0; u < NU; ++u) put(u, r, c, t[b][u]);
    }
  }
}

// four values times mul, rounded to bf16, to p (8-byte aligned)
__device__ __forceinline__ void put_bf16x4(bf16* p, float4 v, float mul) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x * mul, v.y * mul), pack_bf16(v.z * mul, v.w * mul));
}

// One sequence-head's q * scale, k and v (rows 0 .. NR - 1 of base, the
// packed fp32 qkv [L, 3D] at the head's columns) as bf16 into Qs, Ks, Vs
// [NR][HD + 8], zero past L.
template <int HD, int NR, int BATCH>
__device__ __forceinline__ void stage_qkv_bf16(const float* __restrict__ base, int D, int L, float scale,
                                               bf16* Qs, bf16* Ks, bf16* Vs) {
  const long long D3 = 3LL * D;
  stage_rows<HD, NR, BATCH, 3>({base, base + D, base + 2 * D}, {D3, D3, D3}, L, [&](int u, int r, int c, float4 v) {
    put_bf16x4((u == 0 ? Qs : u == 1 ? Ks : Vs) + r * Head<HD>::LD + c, v, u == 0 ? scale : 1.f);
  });
}

// Keys past L in a strip's scores -> fill (-inf before a softmax); for
// NB = 16 the strip kernels run only at L > 128, so blocks 0-7 hold none.
template <int NB>
__device__ __forceinline__ void strip_mask(float (&s)[NB][2][4], int L, int lane, float fill) {
#pragma unroll
  for (int cb = 0; cb < NB; ++cb) {
    const bool edge = cb >= (NB == 16 ? 8 : 0) && cb * 16 + 16 > L;  // warp-uniform
    const int lim = L - cb * 16 - (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (edge && j * 8 + (e & 1) >= lim) s[cb][j][e] = fill;
  }
}

// ---------------------------------------------------------------- Hopper: mbarrier, TMA, wgmma
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// one arrival that also announces the bytes the TMA copies bound to this phase will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// wait until the phase of the given parity has completed (a fresh barrier
// counts its phase "before" the first, parity 1, as complete)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// generic-proxy writes to shared memory -> visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// A contiguous run of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) global -> shared by the bulk-copy engine, completing on bar;
// under an L2 evict-first policy: the kernels that use it read each byte once.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// 2-D tile: global (c0 = inner coordinate, c1 = outer) -> shared, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
// 2-D tile: shared -> global (clipped at the tensor's edge), in the issuing thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1, const void* src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(smem_addr(src))
               : "memory");
}
// tma_store_2d under an L2 cache policy (l2_evict_first: lines the kernel will not read again)
__device__ __forceinline__ void tma_store_2d_hint(const CUtensorMap* map, int c0, int c1, const void* src,
                                                  uint64_t policy) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%1, %2}], [%3], %4;\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(smem_addr(src)), "l"(policy)
               : "memory");
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// the shared-memory source of every committed store has been read
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// every committed store has completed
__device__ __forceinline__ void tma_store_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units); the tiles start on
// 1024-byte boundaries, so the base offset is 0
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }
// keep the compiler from moving reads or writes of the accumulators across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], bf16 operands from shared memory
// (A K-major, or M-major with TA = 1; B N-major: the transpose bits), fp32
// accumulators. Thread t of the warpgroup holds, for n8 tile j, d[4j + e] at
// row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
template <int TA>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA));
}

// The operand tiles of the wgmma kernels, as TMA writes them with the
// 128-byte swizzle: boxes of [rows][64 bf16] (8 KB for 64 rows, 1 KB per 8
// rows), each starting on a 1024-byte boundary. A k16 step of a K-major tile
// (k contiguous: the GEMM's A) moves 32 bytes along the rows; of an MN-major
// tile (m or n contiguous: the GEMM's W, both operands of the weight
// gradient) 16 rows, with its 64-wide column boxes SW_BOX bytes apart.
constexpr int SW_BOX = 8192;
__device__ __forceinline__ uint64_t desc_k_major(const unsigned char* tile, int kk) {
  return gmma_desc_sw128(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn_major(const unsigned char* tile, int kk) {
  return gmma_desc_sw128(tile + kk * 2048, SW_BOX, 1024);
}

// d[64 x 128] += A . B over one 64-deep chunk (four k16 steps): A's 64 rows
// K-major (TA 0) or M-major (TA 1), B's 128 columns N-major (two boxes)
template <int TA>
__device__ __forceinline__ void wgmma_chunk64(float (&d)[64], const unsigned char* a, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16<TA>(d, TA ? desc_mn_major(a, kk) : desc_k_major(a, kk), desc_mn_major(b, kk), 1);
}

// d[64 x 128] (+)= A[64 x 32] . B[32 x 128], int8 operands from shared memory,
// both K-major (8-bit wgmma takes no transpose), int32 accumulators in the
// fp32 version's layout. Integer sums are exact.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] (+)= A[64 x 32] . B[32 x 64], int8, A's fragment in registers:
// four 32-bit registers a thread of four int8 each, rows 16 (t / 32) +
// (t % 32) / 4 and + 8 (a[0], a[1]) at k 4 (t % 4) .. + 3, the same at k 16 +
// 4 (t % 4) .. + 3 (a[2], a[3]), the order ldmatrix_x4 gives them, unchanged
// until the products retire; B's 64 K-major rows from shared memory as
// wgmma_m64n128k32_s8 reads them. Thread t holds d[4 j + e] at row 16 (t / 32)
// + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int (&d)[32], const unsigned (&a)[4], uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// byte offset of element (r, c) of a wgmma kernel's epilogue tile: fp32 as
// four 32-column boxes, bf16 as two 64-column boxes, each [128 rows][128
// bytes] with TMA's 128-byte swizzle (16-byte chunk index XOR row % 8)
__device__ __forceinline__ int stage_off_f32(int r, int c) {
  return (c >> 5) * 16384 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}
__device__ __forceinline__ int stage_off_bf16(int r, int c) {
  return (c >> 6) * 16384 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// A ring of S slots in shared memory that TMA fills: bars[s] (full)
// completes when fill i = s, s + S, ... has landed (one producer arrival that
// announces its bytes), bars[S + s] (empty) when each of the `consumers`
// warps has released it. Fill i takes slot i % S in phase (i / S) & 1.
template <int S>
struct TmaRing {
  uint64_t* bars;  // [2 S]
  __device__ void init(unsigned consumers) const {
    for (int s = 0; s < S; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[S + s], consumers);
    }
  }
  // producer: wait until fill i's slot is free, announce its bytes; the barrier its TMA copies complete on
  __device__ uint64_t* fill(int i, unsigned bytes) const {
    const int s = i % S;
    mbar_wait(&bars[S + s], ((i / S) & 1) ^ 1);
    mbar_expect_tx(&bars[s], bytes);
    return &bars[s];
  }
  __device__ void wait(int i) const { mbar_wait(&bars[i % S], (i / S) & 1); }  // consumer: fill i landed
  __device__ void release(int i) const { mbar_arrive(&bars[S + i % S]); }     // consumer warp: done with fill i
};

// Warp specialisation of the wgmma kernels: WS_THREADS threads, a producer
// warpgroup (warp 0 loads by TMA, warp 1 may store) and two consumer
// warpgroups; setmaxnreg hands the producers' registers to the consumers
// (the kernel is compiled at 168 registers, __launch_bounds__(WS_THREADS, 1),
// so that 4 x 40 + 8 x 232 fit the SM's file).
constexpr int WS_THREADS = 384;
__device__ __forceinline__ void ws_producer_regs() { asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n"); }
__device__ __forceinline__ void ws_consumer_regs() { asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n"); }

// ---------------------------------------------------------------- host side of the wgmma kernels
// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// address, so the library links against nothing new.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// a row-major [outer][inner] tensor of elem-byte values, read and written in
// [box_outer][box_inner] boxes with the 128-byte swizzle (box_inner * elem
// == 128), zero fill out of bounds
inline bool tensor_map(CUtensorMap* m, CUtensorMapDataType dt, const void* ptr, int elem, long long inner,
                       long long outer, unsigned box_inner, unsigned box_outer) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)(inner * elem)};
  const cuuint32_t box[2] = {box_inner, box_outer}, es[2] = {1, 1};
  return enc(m, dt, 2, const_cast<void*>(ptr), dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static const int n = [] {
    int d = 0, c = 0;
    cudaGetDevice(&d);
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, d);
    return c > 0 ? c : 132;
  }();
  return n;
}

// The function attributes and occupancy of a kernel as chip_smoke.py and the
// card tests read them: {registers a thread, local memory bytes a thread,
// resident blocks per SM}.
inline cudaError_t kernel_info(const void* fn, int threads, size_t smem, int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], fn, threads, smem);
}

// out[c] = sum over r of P[r, c] for P [rows, cols] fp32, rows summed in
// ascending order in 8 interleaved lanes (r = ty, ty + 8, ...), the 8 sums
// then added in order: the same result on every run. Block (32, 8), one
// block per 32 columns.
__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ P, float* __restrict__ out, int rows, long long cols) {
  __shared__ float part[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < cols)
    for (int r = ty; r < rows; r += 8) s += P[(long long)r * cols + c];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float t = part[0][tx];
#pragma unroll
    for (int i = 1; i < 8; ++i) t += part[i][tx];
    out[c] = t;
  }
}

inline cudaError_t launch_sum_rows(const float* P, float* out, int rows, long long cols, cudaStream_t st) {
  sum_rows_kernel<<<(unsigned)((cols + 31) / 32), dim3(32, 8), 0, st>>>(P, out, rows, cols);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace
