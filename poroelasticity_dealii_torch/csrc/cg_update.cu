// The Jacobi-preconditioned CG iteration's vector update in two passes (see
// poroelasticity_dealii_torch/ops/cg_update.py for the wrappers and
// solvers/cg.py::_jacobi_update_plain for the plain PyTorch twin).
//
// Replaces no TPU kernel: the JAX package leaves this algebra to XLA, which
// fuses it; in plain PyTorch it is ten elementwise launches an iteration
// (27 full-vector passes, the 0-d alpha, beta and active broadcast).  Both
// passes are bound by device memory bandwidth (3.35 TB/s on the H100): the
// step reads x, r, p, ap and the Jacobi inverse diagonal and writes x, r
// and z (8 vector passes), the direction reads z and p and writes p (3).
// Each thread moves 16 bytes per load and store (double2 / float4) in a
// grid-stride loop over one lane's elements, blockIdx.y the lane; a lane
// length that is not a multiple of the vector width leaves a scalar tail.
//
// Each element is rounded as the plain twin's separate torch kernels round
// it: a product, then a sum or difference, each rounded to nearest
// (__dmul_rn, __dadd_rn, __dsub_rn; __fmul_rn, __fadd_rn, __fsub_rn), never
// contracted into a fused multiply-add, so the iterates are bitwise the
// twin's.  alpha, beta and active are device scalars (one per lane of a
// batch), read by the kernels: no host value, so a CUDA graph captures the
// launches.  No atomics: each element is one thread's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// the arithmetic of an element: every operation rounded to nearest on its
// own (the intrinsics are never contracted)
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// update: one element of the step.  x_out = live ? x + alpha p : x;
// r_new = r - alpha ap, r_out = live ? r_new : r; z_out = r_new d.
template <typename T>
__device__ __forceinline__ void step_element(T x, T r, T p, T ap, T d,
                                             T alpha, bool live, T& x_out,
                                             T& r_out, T& z_out) {
  const T r_new = sub_rn(r, mul_rn(alpha, ap));
  x_out = live ? add_rn(x, mul_rn(alpha, p)) : x;
  r_out = live ? r_new : r;
  z_out = mul_rn(r_new, d);
}

// update: one element of the direction.  p_out = live ? z + beta p : p.
template <typename T>
__device__ __forceinline__ T direction_element(T z, T p, T beta, bool live) {
  return live ? add_rn(z, mul_rn(beta, p)) : p;
}

// V consecutive values, loaded and stored as one 16-byte access when V > 1
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* ptr, int i) {
  return *reinterpret_cast<const Pack<T, V>*>(ptr + i);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* ptr, int i,
                                           const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(ptr + i) = v;
}

// x, r, p, ap, the outputs: lanes x lane_len (lanes = gridDim.y); dinv:
// lane_len values, shared by the lanes; alpha, active: one per lane.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) cg_jacobi_step_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const T* __restrict__ p, const T* __restrict__ ap,
    const T* __restrict__ dinv, const T* __restrict__ alpha,
    const bool* __restrict__ active, T* __restrict__ x_out,
    T* __restrict__ r_out, T* __restrict__ z_out, int lane_len) {
  const int lane = blockIdx.y;
  const int base = lane * lane_len;
  const T a = alpha[lane];
  const bool live = active[lane];
  const int packs = lane_len / V;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int g = first; g < packs; g += gridDim.x * blockDim.x) {
    const int i = base + g * V;
    const Pack<T, V> xv = load_pack<T, V>(x, i);
    const Pack<T, V> rv = load_pack<T, V>(r, i);
    const Pack<T, V> pv = load_pack<T, V>(p, i);
    const Pack<T, V> av = load_pack<T, V>(ap, i);
    const Pack<T, V> dv = load_pack<T, V>(dinv, g * V);
    Pack<T, V> xo, ro, zo;
#pragma unroll
    for (int k = 0; k < V; ++k)
      step_element(xv.v[k], rv.v[k], pv.v[k], av.v[k], dv.v[k], a, live,
                   xo.v[k], ro.v[k], zo.v[k]);
    store_pack(x_out, i, xo);
    store_pack(r_out, i, ro);
    store_pack(z_out, i, zo);
  }
  const int j = packs * V + first;      // the scalar tail
  if (j < lane_len) {
    const int i = base + j;
    step_element(x[i], r[i], p[i], ap[i], dinv[j], a, live, x_out[i],
                 r_out[i], z_out[i]);
  }
}

// z, p, p_out: lanes x lane_len; beta, active: one per lane.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) cg_direction_kernel(
    const T* __restrict__ z, const T* __restrict__ p,
    const T* __restrict__ beta, const bool* __restrict__ active,
    T* __restrict__ p_out, int lane_len) {
  const int lane = blockIdx.y;
  const int base = lane * lane_len;
  const T b = beta[lane];
  const bool live = active[lane];
  const int packs = lane_len / V;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int g = first; g < packs; g += gridDim.x * blockDim.x) {
    const int i = base + g * V;
    const Pack<T, V> zv = load_pack<T, V>(z, i);
    const Pack<T, V> pv = load_pack<T, V>(p, i);
    Pack<T, V> po;
#pragma unroll
    for (int k = 0; k < V; ++k)
      po.v[k] = direction_element(zv.v[k], pv.v[k], b, live);
    store_pack(p_out, i, po);
  }
  const int j = packs * V + first;
  if (j < lane_len) {
    const int i = base + j;
    p_out[i] = direction_element(z[i], p[i], b, live);
  }
}

// 16-byte packs when vec is set (the wrapper checked the alignment), else
// one value a thread
template <typename T>
constexpr int kPack = 16 / sizeof(T);

template <typename T, int V>
void step_pass(dim3 blocks, cudaStream_t s, const void* x, const void* r,
               const void* p, const void* ap, const void* dinv,
               const void* alpha, const void* active, void* x_out,
               void* r_out, void* z_out, int lane_len) {
  cg_jacobi_step_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(p), static_cast<const T*>(ap),
      static_cast<const T*>(dinv), static_cast<const T*>(alpha),
      static_cast<const bool*>(active), static_cast<T*>(x_out),
      static_cast<T*>(r_out), static_cast<T*>(z_out), lane_len);
}

template <typename T, int V>
void direction_pass(dim3 blocks, cudaStream_t s, const void* z,
                    const void* p, const void* beta, const void* active,
                    void* p_out, int lane_len) {
  cg_direction_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(p),
      static_cast<const T*>(beta), static_cast<const bool*>(active),
      static_cast<T*>(p_out), lane_len);
}

template <typename T>
int launch_step(const void* x, const void* r, const void* p, const void* ap,
                const void* dinv, const void* alpha, const void* active,
                void* x_out, void* r_out, void* z_out, int n, int lane_len,
                int grid, int vec, void* stream) {
  const dim3 blocks(grid, n / lane_len);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    step_pass<T, kPack<T>>(blocks, s, x, r, p, ap, dinv, alpha, active,
                           x_out, r_out, z_out, lane_len);
  else
    step_pass<T, 1>(blocks, s, x, r, p, ap, dinv, alpha, active, x_out,
                    r_out, z_out, lane_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_direction(const void* z, const void* p, const void* beta,
                     const void* active, void* p_out, int n, int lane_len,
                     int grid, int vec, void* stream) {
  const dim3 blocks(grid, n / lane_len);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    direction_pass<T, kPack<T>>(blocks, s, z, p, beta, active, p_out,
                                lane_len);
  else
    direction_pass<T, 1>(blocks, s, z, p, beta, active, p_out, lane_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n = lanes * lane_len values per vector; grid: blocks per lane; vec: 1 for
// 16-byte packs (every pointer 16-byte aligned and, with more than one
// lane, lane_len a multiple of the pack), 0 for one value a thread.
int cg_jacobi_step_f32(const void* x, const void* r, const void* p,
                       const void* ap, const void* dinv, const void* alpha,
                       const void* active, void* x_out, void* r_out,
                       void* z_out, int n, int lane_len, int grid, int vec,
                       void* stream) {
  return launch_step<float>(x, r, p, ap, dinv, alpha, active, x_out, r_out,
                            z_out, n, lane_len, grid, vec, stream);
}

int cg_jacobi_step_f64(const void* x, const void* r, const void* p,
                       const void* ap, const void* dinv, const void* alpha,
                       const void* active, void* x_out, void* r_out,
                       void* z_out, int n, int lane_len, int grid, int vec,
                       void* stream) {
  return launch_step<double>(x, r, p, ap, dinv, alpha, active, x_out, r_out,
                             z_out, n, lane_len, grid, vec, stream);
}

int cg_direction_f32(const void* z, const void* p, const void* beta,
                     const void* active, void* p_out, int n, int lane_len,
                     int grid, int vec, void* stream) {
  return launch_direction<float>(z, p, beta, active, p_out, n, lane_len,
                                 grid, vec, stream);
}

int cg_direction_f64(const void* z, const void* p, const void* beta,
                     const void* active, void* p_out, int n, int lane_len,
                     int grid, int vec, void* stream) {
  return launch_direction<double>(z, p, beta, active, p_out, n, lane_len,
                                  grid, vec, stream);
}

}  // extern "C"
