// Hand-written Hopper kernels for the 3D Q2/Q1 structured-grid operators in
// the comp-major row layout (see poroelasticity_dealii_torch/ops/comp_major.py
// for the layout and the plain PyTorch twin of every kernel here).
//
// Row layout of a Q2 displacement vector on an n^3 grid: rows
// zh*24 + ((pz*2 + py)*2 + px)*3 + c, lanes yh*(n+1) + xh, W lanes per row,
// for the node (x, y, z) = (2xh+px, 2yh+py, 2zh+pz) and component c.
// Padding lanes and rows (nodes past 2n on any axis) are zero.
//
// Every kernel is OUTPUT-centric: one thread owns the outputs of one node
// (its three components for the elasticity apply, one value for the
// right-hand sides) and sums the contributions of the <= 8 cells that touch
// the node, so there are no float atomics and the result is bitwise
// repeatable (the solver's skip-if-unchanged rule compares mechanics
// right-hand sides bitwise).
//
// Shared bound and design (H100): the element products are small dense
// matvecs (81x81, 81x8, 48x81 per cell) that each node recomputes for its
// own rows only, so a thread reads <= 8*81 operand values and does up to
// 3*8*81 FMAs.  The operand reads of neighbouring threads (neighbouring
// lanes of one row: the same parity) hit neighbouring addresses and the
// same element-matrix rows, so they coalesce and the matrix reads are
// warp-uniform L1 broadcasts.  The kernels are bound by L1/L2 load
// throughput of these repeated operand reads, not by DRAM (the 7 MB f32
// vector stays in the 50 MB L2) nor by FLOPs.  Shared-memory tiling of a
// z-slab and tensor-core products are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kUnmasked = 0;     // y = A x
constexpr int kFree = 1;         // y = m * A x        (x in the free subspace)
constexpr int kConstrained = 2;  // y = m * A(m x) + (1 - m) x

constexpr int kThreads = 256;

// Cells touching node index 2h+p along one axis, as (cell index, local
// Q2 offset 0..2); returns how many (1 or 2).
__device__ __forceinline__ int q2_axis_cells(int h, int p, int n, int* cell,
                                             int* off) {
  int k = 0;
  if (h < n) { cell[k] = h; off[k] = p; ++k; }
  if (p == 0 && h >= 1) { cell[k] = h - 1; off[k] = 2; ++k; }
  return k;
}

// Cells touching Q1 node X along one axis, as (cell index, local Q1 offset).
__device__ __forceinline__ int q1_axis_cells(int X, int n, int* cell,
                                             int* off) {
  int k = 0;
  if (X < n) { cell[k] = X; off[k] = 0; ++k; }
  if (X >= 1) { cell[k] = X - 1; off[k] = 1; ++k; }
  return k;
}

// Row-layout offset of local Q2 node q (x-fastest lattice), component 0,
// relative to the cell base iz*24*W + iy*(n+1) + ix.
__device__ __forceinline__ int q2_node_offset(int q, int n1, int W) {
  const int ox = q % 3, oy = (q / 3) % 3, oz = q / 9;
  const int base = (((oz & 1) * 2 + (oy & 1)) * 2 + (ox & 1)) * 3;
  return ((oz >> 1) * 24 + base) * W + (oy >> 1) * n1 + (ox >> 1);
}

// Dot of one 81-long element-matrix row with a cell's 81 (node, comp)
// values read from the row layout.
template <typename T>
__device__ __forceinline__ T cell_dot81(const T* __restrict__ krow,
                                        const T* __restrict__ x, int cell,
                                        int n1, int W) {
  T s = T(0);
#pragma unroll
  for (int q = 0; q < 27; ++q) {
    const int j0 = cell + q2_node_offset(q, n1, W);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s += __ldg(krow + q * 3 + c) * __ldg(x + j0 + c * W);
  }
  return s;
}

// The three rows (a*3 + 0..2) of the element matrix dotted with one
// cell's 81 values (optionally masked): each operand is loaded once for
// all three output components of a node.
template <typename T, bool MASKED>
__device__ __forceinline__ void cell_dot81x3(const T* __restrict__ k0,
                                             const T* __restrict__ x,
                                             const T* __restrict__ m,
                                             int cell, int n1, int W,
                                             T* s) {
  T s0 = T(0), s1 = T(0), s2 = T(0);
#pragma unroll
  for (int q = 0; q < 27; ++q) {
    const int j0 = cell + q2_node_offset(q, n1, W);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int j = j0 + c * W;
      T v = __ldg(x + j);
      if (MASKED) v *= __ldg(m + j);
      s0 += __ldg(k0 + q * 3 + c) * v;
      s1 += __ldg(k0 + 81 + q * 3 + c) * v;
      s2 += __ldg(k0 + 162 + q * 3 + c) * v;
    }
  }
  s[0] += s0;
  s[1] += s1;
  s[2] += s2;
}

// Decoded output position of a row-layout thread.
struct RowPos {
  int zh, yh, xh, pz, py, px, c;
  bool real;
};

__device__ __forceinline__ RowPos decode_row(int idx, int n, int W) {
  RowPos r;
  const int n1 = n + 1;
  const int row = idx / W, lane = idx - row * W;
  r.zh = row / 24;
  const int rem = row - r.zh * 24;
  const int par = rem / 3;
  r.c = rem - par * 3;
  r.pz = par >> 2;
  r.py = (par >> 1) & 1;
  r.px = par & 1;
  r.yh = lane / n1;
  r.xh = lane - r.yh * n1;
  r.real = lane < n1 * n1 && 2 * r.zh + r.pz <= 2 * n &&
           2 * r.yh + r.py <= 2 * n && 2 * r.xh + r.px <= 2 * n;
  return r;
}

// Replaces poroelasticity_dealii_tpu/ops/pallas_comp_major.py _kernel_v2
// (make_pallas_apply_rows), _kernel_v3 (make_pallas_constrained_apply) and
// _kernel_v4 (make_pallas_free_apply): the Q2 elasticity apply, row layout
// in and out, in the three masking modes.  One thread owns one node's three
// components (rows zh*24 + par*3 + c, c = 0..2, of one lane), so each
// gathered operand feeds three element-matrix rows.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
elasticity_rows_apply_kernel(const T* __restrict__ x, const T* __restrict__ m,
                             const T* __restrict__ ke, T* __restrict__ y,
                             int n, int W) {
  const int total = (n + 1) * 8 * W;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int node_row = idx / W, lane = idx - node_row * W;   // zh*8 + par
  const RowPos r = decode_row((node_row * 3) * W + lane, n, W);
  const int n1 = n + 1;
  T acc[3] = {T(0), T(0), T(0)};
  if (r.real) {
    int cx[2], ox[2], cy[2], oy[2], cz[2], oz[2];
    const int kx = q2_axis_cells(r.xh, r.px, n, cx, ox);
    const int ky = q2_axis_cells(r.yh, r.py, n, cy, oy);
    const int kz = q2_axis_cells(r.zh, r.pz, n, cz, oz);
    for (int a = 0; a < kz; ++a)
      for (int b = 0; b < ky; ++b)
        for (int d = 0; d < kx; ++d) {
          const int loc = ox[d] + 3 * oy[b] + 9 * oz[a];
          const int cell = cz[a] * 24 * W + cy[b] * n1 + cx[d];
          cell_dot81x3<T, MODE == kConstrained>(ke + loc * 3 * 81, x, m,
                                                cell, n1, W, acc);
        }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int o = (node_row * 3 + c) * W + lane;
    if (MODE == kUnmasked) {
      y[o] = acc[c];
    } else if (MODE == kFree) {
      y[o] = m[o] * acc[c];
    } else {
      const T mi = m[o];
      y[o] = mi * acc[c] + (T(1) - mi) * x[o];
    }
  }
}

// Replaces poroelasticity_dealii_tpu/ops/pallas_comp_major.py
// _kernel_coupling (make_coupling_rows_pallas): the mechanics right-hand
// side b = C p from the Q1 pressure (flat (n+1)^3, x fastest) straight into
// the row layout.  ce: (81, 8) element matrix, Biot coefficient folded in.
template <typename T>
__global__ void __launch_bounds__(kThreads)
coupling_rows_kernel(const T* __restrict__ p, const T* __restrict__ ce,
                     T* __restrict__ y, int n, int W) {
  const int total = (n + 1) * 24 * W;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const RowPos r = decode_row(idx, n, W);
  const int g1 = n + 1;
  T acc = T(0);
  if (r.real) {
    int cx[2], ox[2], cy[2], oy[2], cz[2], oz[2];
    const int kx = q2_axis_cells(r.xh, r.px, n, cx, ox);
    const int ky = q2_axis_cells(r.yh, r.py, n, cy, oy);
    const int kz = q2_axis_cells(r.zh, r.pz, n, cz, oz);
    for (int a = 0; a < kz; ++a)
      for (int b = 0; b < ky; ++b)
        for (int d = 0; d < kx; ++d) {
          const int loc = ox[d] + 3 * oy[b] + 9 * oz[a];
          const T* crow = ce + (loc * 3 + r.c) * 8;
          const int base = (cz[a] * g1 + cy[b]) * g1 + cx[d];
          T s = T(0);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            s += __ldg(crow + i) *
                 __ldg(p + base + ((i >> 2) * g1 + ((i >> 1) & 1)) * g1 +
                       (i & 1));
          acc += s;
        }
  }
  y[idx] = acc;
}

// Replaces poroelasticity_dealii_tpu/ops/pallas_comp_major.py
// _kernel_projection (make_projection_rows_pallas): the all-Voigt strain
// projection right-hand side from u in the row layout, out as (C, (n+1)^3).
// pe: (8*C, 81) element matrix, rows (Q1 local node * C + Voigt c).
template <typename T>
__global__ void __launch_bounds__(kThreads)
projection_rows_kernel(const T* __restrict__ x, const T* __restrict__ pe,
                       T* __restrict__ out, int n, int W, int C) {
  const int g1 = n + 1;
  const int nodes = g1 * g1 * g1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * nodes) return;
  const int c = idx / nodes;
  const int node = idx - c * nodes;
  const int Z = node / (g1 * g1);
  const int Y = (node / g1) % g1;
  const int X = node % g1;
  int cx[2], ox[2], cy[2], oy[2], cz[2], oz[2];
  const int kx = q1_axis_cells(X, n, cx, ox);
  const int ky = q1_axis_cells(Y, n, cy, oy);
  const int kz = q1_axis_cells(Z, n, cz, oz);
  T acc = T(0);
  for (int a = 0; a < kz; ++a)
    for (int b = 0; b < ky; ++b)
      for (int d = 0; d < kx; ++d) {
        const int ip = ox[d] + 2 * oy[b] + 4 * oz[a];
        const int cell = cz[a] * 24 * W + cy[b] * g1 + cx[d];
        acc += cell_dot81<T>(pe + (ip * C + c) * 81, x, cell, g1, W);
      }
  out[idx] = acc;
}

inline unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

template <typename T>
int launch_elasticity(const void* x, const void* m, const void* ke, void* y,
                      int n, int W, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for(static_cast<long long>(n + 1) * 8 * W);
  const T* xp = static_cast<const T*>(x);
  const T* mp = static_cast<const T*>(m);
  const T* kp = static_cast<const T*>(ke);
  T* yp = static_cast<T*>(y);
  switch (mode) {
    case kUnmasked:
      elasticity_rows_apply_kernel<T, kUnmasked>
          <<<grid, kThreads, 0, s>>>(xp, mp, kp, yp, n, W);
      break;
    case kFree:
      elasticity_rows_apply_kernel<T, kFree>
          <<<grid, kThreads, 0, s>>>(xp, mp, kp, yp, n, W);
      break;
    case kConstrained:
      elasticity_rows_apply_kernel<T, kConstrained>
          <<<grid, kThreads, 0, s>>>(xp, mp, kp, yp, n, W);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_coupling(const void* p, const void* ce, void* y, int n, int W,
                    void* stream) {
  const unsigned grid = blocks_for(static_cast<long long>(n + 1) * 24 * W);
  coupling_rows_kernel<T><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(ce),
      static_cast<T*>(y), n, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_projection(const void* x, const void* pe, void* out, int n, int W,
                      int C, void* stream) {
  const long long g1 = n + 1;
  const unsigned grid = blocks_for(C * g1 * g1 * g1);
  projection_rows_kernel<T><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(pe),
      static_cast<T*>(out), n, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: every pointer and the stream are void*,
// every entry point returns cudaGetLastError() after its launch.
extern "C" {

int elasticity_rows_apply_f32(const void* x, const void* m, const void* ke,
                              void* y, int n, int W, int mode, void* stream) {
  return launch_elasticity<float>(x, m, ke, y, n, W, mode, stream);
}

int elasticity_rows_apply_f64(const void* x, const void* m, const void* ke,
                              void* y, int n, int W, int mode, void* stream) {
  return launch_elasticity<double>(x, m, ke, y, n, W, mode, stream);
}

int coupling_rows_f32(const void* p, const void* ce, void* y, int n, int W,
                      void* stream) {
  return launch_coupling<float>(p, ce, y, n, W, stream);
}

int coupling_rows_f64(const void* p, const void* ce, void* y, int n, int W,
                      void* stream) {
  return launch_coupling<double>(p, ce, y, n, W, stream);
}

int projection_rows_f32(const void* x, const void* pe, void* out, int n,
                        int W, int C, void* stream) {
  return launch_projection<float>(x, pe, out, n, W, C, stream);
}

int projection_rows_f64(const void* x, const void* pe, void* out, int n,
                        int W, int C, void* stream) {
  return launch_projection<double>(x, pe, out, n, W, C, stream);
}

}  // extern "C"
