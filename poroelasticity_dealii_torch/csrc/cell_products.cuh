// Device helpers shared by the cell product passes of comp_major.cu (the
// structured grid's kernels) and generic.cu (the generic mesh's kernels):
// element copies from device to shared memory with cp.async, and the
// float64 16 x 8 x 8 tensor-core product (DMMA).  No float32 product here
// touches the tensor cores: float32 runs on the CUDA cores in full float32,
// as the reference multiplies at Precision.HIGHEST.

#pragma once

#include <cuda_runtime.h>

namespace {

// One element of T from device memory into shared memory, asynchronously
// (in flight until cp_async_wait_all).
template <typename T>
__device__ __forceinline__ void cp_async(T* smem_dst, const T* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem_src), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// D (16x8) += A (16x8, row) B (8x8, col) in float64 on the tensor cores
// (sm_90).  With g = lane/4, t = lane%4: a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void dmma_16x8x8(double (&d)[4],
                                            const double (&a)[4], double b0,
                                            double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

}  // namespace
