// Device helpers shared by the kernel sources: type conversion, warp
// reductions, cp.async, ldmatrix and the bf16 mma.sync m16n8k16, ex2, the
// row max and exp of a warp's score strip, a kernel's attributes and
// occupancy, and the fixed-order column reduction that turns per-block
// partial sums into one row (every cross-block sum of the port goes through
// it, so no result depends on the order in which blocks run).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem), "r"(n));
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
