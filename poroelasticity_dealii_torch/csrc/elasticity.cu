// Hand-written Hopper kernel for the 3D structured Q2 elasticity apply on
// flat node-grid vectors (see poroelasticity_dealii_torch/ops/elasticity.py
// for the wrapper and its plain PyTorch twin).
//
// Replaces two Pallas kernels that compute the same function, y = A u with
// u and y flat ((2n+1)^3 * 3,) in [z][y][x][comp] order:
//   poroelasticity_dealii_tpu/ops/pallas_comp_major.py _kernel (v1,
//     make_pallas_apply): comp-major rows, z-slab blocks, a host stitch of
//     the slab overlaps;
//   poroelasticity_dealii_tpu/ops/pallas_elasticity.py _kernel
//     (make_pallas_elasticity): 8 parity subgrids, one halo cell layer
//     recomputed per z-slab.
// Both layouts exist to give Mosaic contiguous 2-D slices and a sequential
// slab grid with disjoint output blocks.  CUDA blocks run in no order, so
// this kernel is OUTPUT-centric on the flat layout itself: one thread owns
// one node and writes its three components.  Along each axis an odd node
// coordinate lies inside exactly one cell (local offset 1); an even one
// lies in up to two (offset 0 in cell X/2 if X/2 < n, offset 2 in cell
// X/2 - 1 if that is >= 0).  So a node sums over at most 8 cells, each
// cell's 81 input values gathered straight from u: no float atomics, no
// carry, no stitch, bitwise repeatable.
//
// Threads are ordered by node parity class first (pz, py, px), then
// (zh, yh, xh) with xh fastest, so the threads of a warp share their cell
// offsets and read the same element-matrix entries (shared-memory
// broadcasts) in lockstep.
//
// Bound (H100): one apply at n = 40 is 2*81*81*n^3 = 0.84 GFLOP against
// >= 12.8 MB of compulsory traffic in f32 (u in, y out): compute-bound,
// ~12.5 us at 67 TFLOP/s of non-tensor f32.  This first version does one
// shared-memory load of K per FMA (plus one L1 load of u per three FMAs),
// so the load units, not the FMA pipes, bound it; register blocking of
// several nodes per thread and tensor-core products are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLocal = 81;   // 27 Q2 nodes x 3 components

// Cells touching node 2h+p along one axis, as (cell index, local Q2
// offset 0..2); returns how many (1 or 2).
__device__ __forceinline__ int axis_cells(int h, int p, int n, int* cell,
                                          int* off) {
  int k = 0;
  if (h < n) { cell[k] = h; off[k] = p; ++k; }
  if (p == 0 && h >= 1) { cell[k] = h - 1; off[k] = 2; ++k; }
  return k;
}

// K lives in dynamic shared memory for both types.  In float64 it is
// 52,488 bytes, above the 48 KB a block gets without opting in, so the
// launcher raises the kernel's dynamic shared-memory limit with
// cudaFuncSetAttribute; reading K through __ldg instead would turn each
// of the 3 K reads per FMA into an L1 access.
template <typename T>
__global__ void __launch_bounds__(kThreads)
elasticity_grid_apply_kernel(const T* __restrict__ u,
                             const T* __restrict__ ke, T* __restrict__ y,
                             int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < kLocal * kLocal; i += blockDim.x)
    ks[i] = ke[i];
  __syncthreads();

  const int n1 = n + 1;
  const int g = 2 * n + 1;
  const int sy = 3 * g;          // flat stride of one node row (y)
  const int sz = 3 * g * g;      // flat stride of one node plane (z)
  const int per_class = n1 * n1 * n1;
  const int total = 8 * per_class;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int par = idx / per_class;
    int rem = idx - par * per_class;
    const int zh = rem / (n1 * n1);
    rem -= zh * n1 * n1;
    const int yh = rem / n1;
    const int xh = rem - yh * n1;
    const int px = par & 1, py = (par >> 1) & 1, pz = par >> 2;
    const int X = 2 * xh + px, Y = 2 * yh + py, Z = 2 * zh + pz;
    if (X >= g || Y >= g || Z >= g) continue;   // odd class past the edge

    int cx[2], ox[2], cy[2], oy[2], cz[2], oz[2];
    const int kx = axis_cells(xh, px, n, cx, ox);
    const int ky = axis_cells(yh, py, n, cy, oy);
    const int kz = axis_cells(zh, pz, n, cz, oz);
    T acc0 = T(0), acc1 = T(0), acc2 = T(0);
    for (int a = 0; a < kz; ++a)
      for (int b = 0; b < ky; ++b)
        for (int d = 0; d < kx; ++d) {
          // rows loc*3 + 0..2 of K: this node's three outputs in the cell
          const T* k0 = ks + (ox[d] + 3 * oy[b] + 9 * oz[a]) * 3 * kLocal;
          const T* uc = u + 2 * cz[a] * sz + 2 * cy[b] * sy + 6 * cx[d];
          T s0 = T(0), s1 = T(0), s2 = T(0);
#pragma unroll
          for (int q = 0; q < 27; ++q) {
            const T* uq = uc + (q / 9) * sz + ((q / 3) % 3) * sy + (q % 3) * 3;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const T v = __ldg(uq + c);
              s0 += k0[q * 3 + c] * v;
              s1 += k0[kLocal + q * 3 + c] * v;
              s2 += k0[2 * kLocal + q * 3 + c] * v;
            }
          }
          acc0 += s0;
          acc1 += s1;
          acc2 += s2;
        }
    T* yo = y + Z * sz + Y * sy + 3 * X;
    yo[0] = acc0;
    yo[1] = acc1;
    yo[2] = acc2;
  }
}

template <typename T>
int launch_grid_apply(const void* u, const void* ke, int n, void* y,
                      void* stream) {
  const int smem = kLocal * kLocal * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      elasticity_grid_apply_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, elasticity_grid_apply_kernel<T>, kThreads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  // enough resident blocks to fill the card once; each loads K once and
  // walks the nodes grid-stride
  const long long total = 8LL * (n + 1) * (n + 1) * (n + 1);
  long long grid = (total + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) *
                             (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  elasticity_grid_apply_kernel<T>
      <<<static_cast<unsigned>(grid), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u), static_cast<const T*>(ke),
          static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: every pointer and the stream are void*,
// the entry point returns the first CUDA error of its launch (0 if none).
extern "C" {

int elasticity_grid_apply_f32(const void* u, const void* ke, int n, void* y,
                              void* stream) {
  return launch_grid_apply<float>(u, ke, n, y, stream);
}

int elasticity_grid_apply_f64(const void* u, const void* ke, int n, void* y,
                              void* stream) {
  return launch_grid_apply<double>(u, ke, n, y, stream);
}

}  // extern "C"
