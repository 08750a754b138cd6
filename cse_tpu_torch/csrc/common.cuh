// Device helpers shared by fused_stack.cu and fused_train.cu: type
// conversion, warp reductions, cp.async, ldmatrix and the bf16 mma.sync
// m16n8k16, and the fixed-order column reduction that turns per-block
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
