// Hand-written Hopper kernels for the 3D Q2/Q1 structured-grid operators in
// the comp-major row layout and on flat node-grid vectors (see
// poroelasticity_dealii_torch/ops/comp_major.py and ops/elasticity.py for the
// layouts, ops/cell_products.py for the launch plans, and the plain PyTorch
// twin of every kernel here).
//
// Row layout of a Q2 displacement vector on an n^3 grid: rows
// zh*24 + ((pz*2 + py)*2 + px)*3 + c, lanes yh*(n+1) + xh, W lanes per row,
// for the node (x, y, z) = (2xh+px, 2yh+py, 2zh+pz) and component c.
// Padding lanes and rows (nodes past 2n on any axis) are zero.  Flat layout:
// ((z*g + y)*g + x)*3 + c with g = 2n+1 nodes per axis, no padding.
//
// No kernel here uses float atomics: every output value is summed by one
// thread in a fixed order, so the results repeat bitwise (the solver's
// skip-if-unchanged rule compares mechanics right-hand sides bitwise).
//
// The elasticity apply in both layouts (K1/K2/K5 in rows, K6/K7 flat) and
// the projection right-hand side (K4) share one cell-centric product pass on
// tiles of cells (rows_products_kernel, a template on the output rows, 81
// per cell for the apply and 48 for the projection, and on the input
// layout), followed by an output-centric sum pass each (Q2 node sums for the
// apply, written in its layout; Q1 node sums for the projection, whose
// product pass multiplies by pe, 48 x 81, as four warps of 12 rows in
// float32 and six DMMA n-tiles in float64).  The coupling right-hand side
// (K3) is one launch: a thread per row-layout column loads its 3x3x3 Q1
// neighbourhood of p once and writes the column's 24 rows parity by parity,
// with the element matrix in shared memory.

#include <cuda_runtime.h>

#include "cell_products.cuh"   // cp_async, cp_async_wait_all, dmma_16x8x8

namespace {

constexpr int kUnmasked = 0;     // y = A x
constexpr int kFree = 1;         // y = m * A x        (x in the free subspace)
constexpr int kConstrained = 2;  // y = m * A(m x) + (1 - m) x

constexpr int kThreads = 256;    // the output-centric sum kernels
constexpr int kLocal = 81;       // 27 local Q2 nodes x 3 components
constexpr int kVoigt = 6;        // Voigt components of the 3D projection
constexpr int kProjRows = 8 * kVoigt;   // rows of pe: Q1 local node x Voigt
constexpr int kCouplingThreads = 128;   // the coupling kernel's blocks

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

// Input layouts of the cell product pass: where cell (iz, iy, ix)'s 81
// values lie, as the offset of its local node 0, component 0 (cell_base)
// plus that of local value b = 3q + c, q the x-fastest local node
// (node_offset).
struct RowLayout {
  static __device__ __forceinline__ int cell_base(int iz, int iy, int ix,
                                                  int n, int W) {
    return iz * 24 * W + iy * (n + 1) + ix;
  }
  static __device__ __forceinline__ int node_offset(int b, int n, int W) {
    return q2_node_offset(b / 3, n + 1, W) + (b % 3) * W;
  }
};

struct FlatLayout {   // W unused
  static __device__ __forceinline__ int cell_base(int iz, int iy, int ix,
                                                  int n, int) {
    const int sy = 3 * (2 * n + 1), sz = sy * (2 * n + 1);
    return 2 * iz * sz + 2 * iy * sy + 6 * ix;
  }
  static __device__ __forceinline__ int node_offset(int b, int n, int) {
    const int sy = 3 * (2 * n + 1), sz = sy * (2 * n + 1);
    const int q = b / 3;
    return (q / 9) * sz + ((q / 3) % 3) * sy + (q % 3) * 3 + b % 3;
  }
};

// Decoded output position of a row-layout thread.
struct RowPos {
  int zh, yh, xh, pz, py, px, c;
  bool real;
};

__device__ __forceinline__ RowPos decode_row(int idx, int n, int nz,
                                             int W) {
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
  r.real = lane < n1 * n1 && 2 * r.zh + r.pz <= 2 * nz &&
           2 * r.yh + r.py <= 2 * n && 2 * r.xh + r.px <= 2 * n;
  return r;
}

// ---------------------------------------------------------------------------
// The cell product pass (K1, K2, K5, K6/K7 and K4)
//
// Replaces poroelasticity_dealii_tpu/ops/pallas_comp_major.py _kernel_v4
// (make_pallas_free_apply, K1), _kernel_v3 (make_pallas_constrained_apply,
// K2) and _kernel_v2 (make_pallas_apply_rows, K5): the Q2 elasticity apply,
// row layout in and out, in the three masking modes, and K5's z-slab form
// (make_pallas_apply_rows(nz=Lz) with a run-time nv, one device's slab in
// parallel/rows.py): nz cell layers swept, ((nz + 1) * 24, W) in (the
// slab plus the next slab's first z-half layer) and out (the last 24 rows
// the band returned to the next slab), cells at iz >= nv contributing
// nothing whatever their input rows hold.  The slab form is the UNMASKED
// launch with nz and nv in place of n: the product pass zeroes the cells
// past nv * n^2 and the sum pass counts nz cell layers on the z axis.  nv
// is a launch argument, not device memory: each rank is its own program
// and knows its count on the host; _kernel v1
// (make_pallas_apply, K6) and ops/pallas_elasticity.py _kernel
// (make_pallas_elasticity, K7): y = A u on flat ((2n+1)^3 * 3,) vectors,
// with a slab mode for the gspmd z-slabs of parallel/sharding.py (nz cell
// layers of n x n cells, (2n+1)^2 (2nz+1) nodes in and out, every cell
// real: the same launch with nz in place of n on the z axis),
// which the TPU kernels take through comp-major rows and a host stitch of
// z-slab overlaps (K6) or 8 parity subgrids and a recomputed halo layer
// (K7), layouts that give Mosaic contiguous 2-D slices; and
// _kernel_projection (make_projection_rows_pallas, K4): the all-Voigt
// strain-projection right-hand side, row layout in, (6, (n+1)^3) out.  The
// TPU kernels gather one cell layer, multiply it by the element matrix
// (81 x 81, or 48 x 81) in one matrix product and scatter it with a z-carry
// through a sequential grid.
//
// Bound (H100, 700 W): K has 5619 nonzeros of 6561 on the bench deck's
// cell, so one apply at n = 40 needs 2*5619*n^3 = 0.72 GFLOP against
// ~13-21 MB of compulsory f32 traffic (x, mask, y; flat u and y 12.8 MB):
// bound by operations, 10.7 us at the 67 TFLOP/s of float32 outside the
// tensor cores (TF32 is not float32, and the reference multiplies at
// Precision.HIGHEST) and of float64 on the tensor cores (DMMA).  The flat
// apply's float64 traffic is 25.5 MB, 7.6 us: still bound by operations.
// A slab's apply does the products of its nv real layers only (at n = 40
// on 4 slabs, nv = 10 or 11 of 41 z-half layers: ~2.7 us), and its sum
// pass and traffic scale with its nz + 1 z-half layers.  pe has 864
// nonzeros of 3888 (a normal-strain row of a Q1 node reads one
// displacement component, a shear row two, and the quadrature zeroes more),
// so the projection needs 0.11 GFLOP and is bound by its 8.7 MB of f32
// traffic, 2.6 us.  The product pass below multiplies every entry, zeros
// included.  The first designs, a thread per output value (row layout) or
// per node (flat) re-gathering its <= 8 cells, issued one or two loads per
// FMA and were bound by the load pipe (11-45x the bound).
//
// Design: two launches, no atomics.
//  1. Products, cell-centric (rows_products_kernel<T, ROWS, MASK_INPUT,
//     Layout>): a persistent grid of at most one resident wave; each block
//     loads the element matrix once into shared memory with cp.async,
//     zero-padded to the product's tile shape, so the load overlaps the
//     first tile's gather (at n = 40 a float32 block walks about one tile),
//     then walks tiles of kCells consecutive cells (z, y, x order).  It
//     gathers the tile's 81 x kCells operand matrix X_E from the input
//     layout (RowLayout or FlatLayout: only the cell base and the 81 value
//     offsets differ) into shared memory with cp.async, element by element
//     (CONSTRAINED: batched loads times the mask).  In the flat layout
//     x-neighbouring cells start 6 values apart, so a warp's 32 loads of
//     one value row touch ~7 cache lines, not 1; the next 8 value rows
//     (the rest of the 3 nodes x 3 components of one (z, y) node row)
//     read the same lines from L1, and the flat pass measured within 4% of
//     the row-layout one (PERF.md).  It computes
//     Y_E = K X_E (ROWS x kCells) and writes it to the
//     scratch ye (ROWS, stride), cell fastest.  float32: each thread owns a
//     12 x 8 register tile of Y_E and reads K and X_E as float4 (K
//     warp-uniform: broadcasts), so 5 loads feed 96 FMAs; ROWS / 12 warps
//     (7 for the apply, 4 for the projection).  float64: mma.sync m16n8k8
//     (sm_90) on the tensor cores (DMMA) with the cells as the M side, each
//     warp a 16-cell x ROWS tile of Y_E^T (11 n-tiles for the apply, 6 for
//     the projection).  A variant of the apply without the gather took ~80%
//     of the product pass's time at n = 40 (PERF.md): the products bound it.
//  2. Sums, output-centric: elasticity_rows_sum_kernel, one thread per Q2
//     node adds its <= 8 cells' entries of ye in a fixed cell order, applies
//     the mode and writes the row layout; elasticity_flat_sum_kernel, the
//     same sum for one node per thread in [z][y][x] order, so a warp writes
//     96 consecutive values of y; projection_sum_kernel, one thread per Q1
//     node adds its <= 8 cells' entries for each Voigt component.
// ---------------------------------------------------------------------------

// Pass-1 tile shapes by value type and output rows (both layouts);
// ops/cell_products.py::rows_apply_plan mirrors them and passes the dynamic
// shared-memory bytes, which the launchers check.
template <typename T, int ROWS>
struct ProductTile;

template <>
struct ProductTile<float, kLocal> {
  static constexpr int kCells = 256;    // cells per tile
  static constexpr int kThreads = 224;  // warp w: rows 12w..12w+11 of Y_E
  static constexpr int kMinBlocks = 2;  // resident blocks per SM
  static constexpr int kKRows = 81;     // K^T[b][a], a padded to 84
  static constexpr int kKCols = 84;
  static constexpr int kXRows = 81;     // X_E[b][cell]
  static constexpr int kXStride = 256;
};

template <>
struct ProductTile<float, kProjRows> {
  static constexpr int kCells = 256;
  static constexpr int kThreads = 128;  // 4 warps x 12 rows = 48
  static constexpr int kMinBlocks = 2;
  static constexpr int kKRows = 81;     // pe^T[b][a]
  static constexpr int kKCols = 48;
  static constexpr int kXRows = 81;
  static constexpr int kXStride = 256;
};

template <>
struct ProductTile<double, kLocal> {
  static constexpr int kCells = 64;
  static constexpr int kThreads = 128;  // warp w: cells 16w..16w+15
  static constexpr int kMinBlocks = 2;
  static constexpr int kKRows = 88;     // K[a][b], 88 x 88 zero-padded; row
  static constexpr int kKCols = 92;     // stride 92 and X_E's 68 keep each
  static constexpr int kXRows = 88;     // fragment load at two wavefronts
  static constexpr int kXStride = 68;   // (no bank conflict); X_E[b][cell]
};

template <>
struct ProductTile<double, kProjRows> {
  static constexpr int kCells = 64;
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = 2;
  static constexpr int kKRows = 48;     // pe[a][b], b zero-padded to 88,
  static constexpr int kKCols = 92;     // with the apply's strides
  static constexpr int kXRows = 88;
  static constexpr int kXStride = 68;
};

template <typename T, int ROWS>
constexpr int product_smem_bytes() {
  using P = ProductTile<T, ROWS>;
  return (P::kKRows * P::kKCols + P::kXRows * P::kXStride) *
             static_cast<int>(sizeof(T)) +
         (P::kCells + kLocal) * static_cast<int>(sizeof(int));
}

// Element matrix (ROWS x 81, row-major) into shared memory in the layout
// its product reads, with cp.async (in flight until the caller's wait) and
// zeros in the padding.
template <int ROWS>
__device__ __forceinline__ void load_k(float* ks, const float* ke) {
  using P = ProductTile<float, ROWS>;
  for (int i = threadIdx.x; i < P::kKRows * P::kKCols; i += P::kThreads) {
    const int b = i / P::kKCols, a = i - b * P::kKCols;
    if (a < ROWS)
      cp_async(ks + i, ke + a * kLocal + b);
    else
      ks[i] = 0.f;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_k(double* ks, const double* ke) {
  using P = ProductTile<double, ROWS>;
  for (int i = threadIdx.x; i < P::kKRows * P::kKCols; i += P::kThreads) {
    const int a = i / P::kKCols, b = i - a * P::kKCols;
    if (a < ROWS && b < kLocal)
      cp_async(ks + i, ke + a * kLocal + b);
    else
      ks[i] = 0.0;
  }
}

// Y_E (ROWS x 256) = K X_E on the CUDA cores; ye points at the tile's first
// cell in the scratch.  Thread (w, lane): rows 12w..12w+11, cells
// 4 lane..4 lane+3 and 128+4 lane..128+4 lane+3 (each float4 load of X_E
// a warp makes is 512 contiguous bytes).
template <int ROWS>
__device__ __forceinline__ void tile_products(const float* ks,
                                              const float* xs,
                                              float* __restrict__ ye,
                                              int stride) {
  using P = ProductTile<float, ROWS>;
  constexpr int kK4 = P::kKCols / 4;    // float4s per row of K^T
  static_assert(P::kThreads == 32 * (P::kKCols / 12), "12 rows per warp");
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* k4 = reinterpret_cast<const float4*>(ks) + 3 * w;
  const float4* x4 = reinterpret_cast<const float4*>(xs) + lane;
  float acc[12][8];
#pragma unroll
  for (int r = 0; r < 12; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 3
  for (int b = 0; b < kLocal; ++b) {
    const float4 k0 = k4[b * kK4], k1 = k4[b * kK4 + 1], k2 = k4[b * kK4 + 2];
    const float4 xv = x4[b * 64], xw = x4[b * 64 + 32];
    const float kr[12] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y,
                          k1.z, k1.w, k2.x, k2.y, k2.z, k2.w};
    const float xr[8] = {xv.x, xv.y, xv.z, xv.w, xw.x, xw.y, xw.z, xw.w};
#pragma unroll
    for (int r = 0; r < 12; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(kr[r], xr[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const int a = 12 * w + r;
    if (a < ROWS) {
      float4* row =
          reinterpret_cast<float4*>(ye + static_cast<long long>(a) * stride);
      row[lane] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      row[lane + 32] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
}

// Y_E^T (64 cells x kKRows, columns >= ROWS dropped) = X_E^T K^T with DMMA:
// A = X_E^T (cells x b), B = K^T (b x a, read from K[a][b]), b padded to 88.
template <int ROWS>
__device__ __forceinline__ void tile_products(const double* ks,
                                              const double* xs,
                                              double* __restrict__ ye,
                                              int stride) {
  using P = ProductTile<double, ROWS>;
  constexpr int kNT = P::kKRows / 8;    // n-tiles of 8 output rows
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const double* xa = xs + t * P::kXStride + 16 * w + g;  // A[cell][b]
  const double* kb = ks + g * P::kKCols + t;             // B[b][a] = K[a][b]
  double acc[kNT][4];
#pragma unroll
  for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.0;
#pragma unroll 1
  for (int k0 = 0; k0 < P::kXRows; k0 += 8) {   // b, padded to 88
    const double a[4] = {xa[k0 * P::kXStride], xa[k0 * P::kXStride + 8],
                         xa[(k0 + 4) * P::kXStride],
                         xa[(k0 + 4) * P::kXStride + 8]};
#pragma unroll
    for (int nb = 0; nb < kNT; ++nb)
      dmma_16x8x8(acc[nb], a, kb[nb * 8 * P::kKCols + k0],
                  kb[nb * 8 * P::kKCols + k0 + 4]);
  }
#pragma unroll
  for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int a = nb * 8 + 2 * t + i;
      if (a < ROWS) {
        double* row = ye + static_cast<long long>(a) * stride + 16 * w + g;
        row[0] = acc[nb][i];
        row[8] = acc[nb][2 + i];
      }
    }
}

// Pass 1: ye[a][cell] = sum_b K[a][b] X_E[b][cell] for every cell and each
// of the ROWS rows of K (ROWS x 81), X_E gathered from x in Layout (times
// the mask when MASK_INPUT).  The first nv layers of n x n cells are real
// (nv = n on a whole grid; the slab form's run-time count of real cell
// layers); stride: the scratch row length, a multiple of kCells >= the
// cells the sum pass reads; cells past nv*n^2 get zero, whatever x holds
// there.
template <typename T, int ROWS, bool MASK_INPUT, typename Layout>
__global__ void __launch_bounds__(ProductTile<T, ROWS>::kThreads,
                                  ProductTile<T, ROWS>::kMinBlocks)
rows_products_kernel(const T* __restrict__ x, const T* __restrict__ m,
                     const T* __restrict__ ke, T* __restrict__ ye, int n,
                     int nv, int W, int stride) {
  using P = ProductTile<T, ROWS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* xs = ks + P::kKRows * P::kKCols;
  int* cell_base = reinterpret_cast<int*>(xs + P::kXRows * P::kXStride);
  int* node_off = cell_base + P::kCells;
  const int tid = threadIdx.x;
  const int nn = n * n, cells = nn * nv;

  load_k<ROWS>(ks, ke);
  for (int b = tid; b < kLocal; b += P::kThreads)
    node_off[b] = Layout::node_offset(b, n, W);
  for (int i = kLocal * P::kXStride + tid; i < P::kXRows * P::kXStride;
       i += P::kThreads)
    xs[i] = T(0);   // padding rows of X_E (float64), never gathered

  for (int tile = blockIdx.x; tile * P::kCells < stride;
       tile += gridDim.x) {
    const int c0 = tile * P::kCells;
    __syncthreads();   // the last tile's products are done
    for (int j = tid; j < P::kCells; j += P::kThreads) {
      const int cell = c0 + j;
      int base = -1;
      if (cell < cells) {
        const int iz = cell / nn, rem = cell - iz * nn;
        const int iy = rem / n, ix = rem - iy * n;
        base = Layout::cell_base(iz, iy, ix, n, W);
      }
      cell_base[j] = base;
    }
    __syncthreads();
    if (MASK_INPUT) {
      // kBatch elements' loads in flight before their stores
      constexpr int kBatch = 8;
      for (int e0 = tid; e0 < kLocal * P::kCells;
           e0 += kBatch * P::kThreads) {
        T v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * P::kThreads;
          const int b = e / P::kCells, j = e - b * P::kCells;
          const int base = e < kLocal * P::kCells ? cell_base[j] : -1;
          v[u] = T(0);
          if (base >= 0) {
            const int i = base + node_off[b];
            v[u] = __ldg(x + i) * __ldg(m + i);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * P::kThreads;
          const int b = e / P::kCells, j = e - b * P::kCells;
          if (e < kLocal * P::kCells) xs[b * P::kXStride + j] = v[u];
        }
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < kLocal * P::kCells; e += P::kThreads) {
        const int b = e / P::kCells, j = e - b * P::kCells;
        T* dst = xs + b * P::kXStride + j;
        const int base = cell_base[j];
        if (base < 0)
          *dst = T(0);
        else
          cp_async(dst, x + base + node_off[b]);
      }
    }
    cp_async_wait_all();   // the tile (and, at the first tile, K) landed
    __syncthreads();
    tile_products<ROWS>(ks, xs, ye + c0, stride);
  }
}

// The three components of Q2 node (2zh+pz, 2yh+py, 2xh+px) of the apply:
// its <= 8 cells' entries of ye added into acc in a fixed order (cells in
// z, y, x order, offset 0 before offset 2 on each axis), the same in both
// layouts.  nz: the cell layers along z (n on a whole grid, the slab
// depth in the slab form, whose z-half layer nz has cells only below it).
template <typename T>
__device__ __forceinline__ void q2_node_sum(const T* __restrict__ ye, int n,
                                            int nz, int stride, int zh,
                                            int pz,
                                            int yh, int py, int xh, int px,
                                            T (&acc)[3]) {
  int cx[2], ox[2], cy[2], oy[2], cz[2], oz[2];
  const int kx = q2_axis_cells(xh, px, n, cx, ox);
  const int ky = q2_axis_cells(yh, py, n, cy, oy);
  const int kz = q2_axis_cells(zh, pz, nz, cz, oz);
  for (int a = 0; a < kz; ++a)
    for (int b = 0; b < ky; ++b)
      for (int d = 0; d < kx; ++d) {
        const int loc = ox[d] + 3 * oy[b] + 9 * oz[a];
        const T* yc = ye + static_cast<long long>(loc * 3) * stride +
                      (cz[a] * n + cy[b]) * n + cx[d];
        acc[0] += yc[0];
        acc[1] += yc[stride];
        acc[2] += yc[2 * stride];
      }
}

// Pass 2 of the row-layout apply: one thread per node of the nz + 1
// z-half layers sums its three components (q2_node_sum), applies the mode
// and writes the row layout.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
elasticity_rows_sum_kernel(const T* __restrict__ ye, const T* __restrict__ x,
                           const T* __restrict__ m, T* __restrict__ y, int n,
                           int nz, int W, int stride) {
  const int total = (nz + 1) * 8 * W;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int node_row = idx / W, lane = idx - node_row * W;   // zh*8 + par
  const RowPos r = decode_row((node_row * 3) * W + lane, n, nz, W);
  T acc[3] = {T(0), T(0), T(0)};
  if (r.real)
    q2_node_sum(ye, n, nz, stride, r.zh, r.pz, r.yh, r.py, r.xh, r.px,
                acc);
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

// Pass 2 of the flat apply (y = A u): one thread per Q2 node of the
// 2nz + 1 node planes in [z][y][x] order sums its three components
// (q2_node_sum) and writes them to y.  nz: the cell layers along z (n on a
// whole grid; the slab mode's depth, its planes (2n+1) x (2n+1) nodes).
template <typename T>
__global__ void __launch_bounds__(kThreads)
elasticity_flat_sum_kernel(const T* __restrict__ ye, T* __restrict__ y,
                           int n, int nz, int stride) {
  const int g = 2 * n + 1;
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= g * g * (2 * nz + 1)) return;
  const int Z = node / (g * g);
  const int rem = node - Z * g * g;
  const int Y = rem / g, X = rem - Y * g;
  T acc[3] = {T(0), T(0), T(0)};
  q2_node_sum(ye, n, nz, stride, Z >> 1, Z & 1, Y >> 1, Y & 1, X >> 1,
              X & 1, acc);
#pragma unroll
  for (int c = 0; c < 3; ++c) y[3 * node + c] = acc[c];
}

// Pass 2 of the projection: one thread per Q1 node adds, for each Voigt
// component c, its <= 8 cells' entries ye[ip*6 + c][cell] (cells in z, y, x
// order, offset 0 before offset 1 on each axis; ip the node's local Q1 index
// in the cell) and writes out[c][node].  Neighbouring threads read
// neighbouring cells.
template <typename T>
__global__ void __launch_bounds__(kThreads)
projection_sum_kernel(const T* __restrict__ ye, T* __restrict__ out, int n,
                      int stride) {
  const int g1 = n + 1;
  const int nodes = g1 * g1 * g1;
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= nodes) return;
  const int Z = node / (g1 * g1);
  const int rem = node - Z * g1 * g1;
  const int Y = rem / g1, X = rem - Y * g1;
  int cx[2], ox[2], cy[2], oy[2], cz[2], oz[2];
  const int kx = q1_axis_cells(X, n, cx, ox);
  const int ky = q1_axis_cells(Y, n, cy, oy);
  const int kz = q1_axis_cells(Z, n, cz, oz);
  T acc[kVoigt];
#pragma unroll
  for (int c = 0; c < kVoigt; ++c) acc[c] = T(0);
  for (int a = 0; a < kz; ++a)
    for (int b = 0; b < ky; ++b)
      for (int d = 0; d < kx; ++d) {
        const int ip = ox[d] + 2 * oy[b] + 4 * oz[a];
        const T* yc = ye + static_cast<long long>(ip * kVoigt) * stride +
                      (cz[a] * n + cy[b]) * n + cx[d];
#pragma unroll
        for (int c = 0; c < kVoigt; ++c) acc[c] += yc[c * stride];
      }
#pragma unroll
  for (int c = 0; c < kVoigt; ++c) out[c * nodes + node] = acc[c];
}

// ---------------------------------------------------------------------------
// The coupling right-hand side (K3)
//
// Replaces poroelasticity_dealii_tpu/ops/pallas_comp_major.py
// _kernel_coupling (make_coupling_rows_pallas): the mechanics right-hand
// side b = C p from the Q1 pressure (flat (n+1)^3, x fastest) straight into
// the row layout.  ce: (81, 8) element matrix, Biot coefficient folded in.
//
// Bound (H100, 700 W): 2*81*8*n^3 = 83 MFLOP against the 7.3 MB row layout
// written (f32, n = 40): bound by bytes, 2.2 us (4.4 us in f64).  The first
// design, a thread per row-layout value, decoded its position (five integer
// divisions) and issued up to 128 loads for 64 FMAs.
//
// Design: one thread per row-layout column (zh, lane = yh*(n+1) + xh) writes
// all 24 rows of it (8 parities x 3 components).  A column's Q2 nodes lie in
// the cells h-1 and h on each axis, whose Q1 nodes are h-1..h+1: the thread
// loads that 3x3x3 neighbourhood of p once (27 loads, neighbouring threads
// on neighbouring addresses), walks the 27 local Q2 nodes q of the element
// matrix parity by parity with the loops unrolled at compile time (q's
// offset 2 on an axis lies in cell h-1, offsets 0 and 1 in cell h), skips
// cells outside the grid per axis (an outside cell still touches nodes
// inside, so a zero p is not enough), and stores each parity's 3 values
// (coalesced across the warp) before the next parity: 3 accumulators live
// instead of 24, which cut the float64 time by 16% (PERF.md).  The 648
// values of ce sit in shared memory, staged while the loads of p are in
// flight and read as warp-uniform broadcasts.  Padding lanes and phantom
// rows touch no cell inside and get zero.
// ---------------------------------------------------------------------------

// Eight consecutive values of a 16-byte aligned shared array.
__device__ __forceinline__ void load8(const float* s, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const double* s, double (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 a = reinterpret_cast<const double2*>(s)[i];
    v[2 * i] = a.x;
    v[2 * i + 1] = a.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCouplingThreads)
coupling_rows_kernel(const T* __restrict__ p, const T* __restrict__ ce,
                     T* __restrict__ y, int n, int W) {
  __shared__ __align__(16) T cs[kLocal * 8];
  const int idx = blockIdx.x * kCouplingThreads + threadIdx.x;
  const int zh = idx / W, lane = idx - zh * W;
  const int n1 = n + 1;
  const int yh = lane / n1, xh = lane - yh * n1;
  const bool real = lane < n1 * n1;
  // cell h-1 (index 0) and h (index 1) on each axis, inside the grid
  const bool vx[2] = {real && xh >= 1, real && xh < n};
  const bool vy[2] = {real && yh >= 1, real && yh < n};
  const bool vz[2] = {real && zh >= 1, real && zh < n};
  // p at Q1 nodes h-1+k, k = 0..2, on each axis (zero outside the grid)
  T pv[3][3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int Z = zh - 1 + a, Y = yh - 1 + b, X = xh - 1 + d;
        const bool in = real && Z >= 0 && Z <= n && Y >= 0 && Y <= n &&
                        X >= 0 && X <= n;
        pv[a][b][d] = in ? __ldg(p + (Z * n1 + Y) * n1 + X) : T(0);
      }
  // ce into shared memory while the loads of p are in flight
  for (int i = threadIdx.x; i < kLocal * 8; i += kCouplingThreads)
    cs[i] = ce[i];
  __syncthreads();
  if (zh > n) return;
  // parity by parity, its local Q2 nodes q in increasing order: the three
  // rows of a parity are stored before the next parity's products start
#pragma unroll
  for (int par = 0; par < 8; ++par) {
    const int px = par & 1, py = (par >> 1) & 1, pz = par >> 2;
    T acc[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int oz = pz; oz < 3; oz += 2)
#pragma unroll
      for (int oy = py; oy < 3; oy += 2)
#pragma unroll
        for (int ox = px; ox < 3; ox += 2) {
          // the cell holding local node q: h-1 for offset 2, else h
          const int dx = ox == 2 ? 0 : 1, dy = oy == 2 ? 0 : 1,
                    dz = oz == 2 ? 0 : 1;
          if (!(vx[dx] && vy[dy] && vz[dz])) continue;
          const int q = ox + 3 * oy + 9 * oz;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            T cv[8];
            load8(cs + (q * 3 + c) * 8, cv);
            T s = T(0);
#pragma unroll
            for (int i = 0; i < 8; ++i)   // local Q1 node (i&1, i>>1&1, i>>2)
              s += cv[i] *
                   pv[dz + (i >> 2)][dy + ((i >> 1) & 1)][dx + (i & 1)];
            acc[c] += s;
          }
        }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      y[(zh * 24 + par * 3 + c) * W + lane] = acc[c];
  }
}

constexpr int kMaxDevices = 64;

inline unsigned blocks_for(long long total, int threads = kThreads) {
  return static_cast<unsigned>((total + threads - 1) / threads);
}

// Launch pass 1 over nv real layers of n x n cells with the plan the
// wrapper passes; refuse any other plan.  The element matrix and a tile
// exceed the 48 KB a block gets without opting in; the attribute is per
// device, set at a device's first launch.
template <typename T, int ROWS, bool MASK_INPUT, typename Layout>
cudaError_t launch_products(const T* x, const T* m, const T* ke, T* ye,
                            int n, int nv, int W, int stride, int grid,
                            int smem, cudaStream_t s) {
  using P = ProductTile<T, ROWS>;
  if (smem != product_smem_bytes<T, ROWS>() || grid < 1 || nv < 0 ||
      stride % P::kCells ||
      static_cast<long long>(stride) < static_cast<long long>(nv) * n * n)
    return cudaErrorInvalidValue;
  void (*products)(const T*, const T*, const T*, T*, int, int, int, int) =
      rows_products_kernel<T, ROWS, MASK_INPUT, Layout>;
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(
        products, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  products<<<grid, P::kThreads, smem, s>>>(x, m, ke, ye, n, nv, W, stride);
  return cudaGetLastError();
}

// The row-layout apply on nz cell layers ((nz + 1) * 24 rows in and out),
// of which the first nv are real: nz = nv = n on a whole grid; the slab
// form (UNMASKED, the wrapper enforces it) passes a slab's depth and its
// run-time count of real layers, and the last 24 rows of y are the band
// the caller returns to the next slab.
template <typename T>
int launch_elasticity(const void* x, const void* m, const void* ke, void* y,
                      void* ye, int n, int nz, int nv, int W, int stride,
                      int grid, int smem, int mode, void* stream) {
  if ((mode != kUnmasked && mode != kFree && mode != kConstrained) ||
      nz < 1 || nv < 0 || nv > nz ||
      static_cast<long long>(stride) < static_cast<long long>(nz) * n * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* mp = static_cast<const T*>(m);
  const T* kp = static_cast<const T*>(ke);
  T* yp = static_cast<T*>(y);
  T* ep = static_cast<T*>(ye);
  const cudaError_t err =
      mode == kConstrained
          ? launch_products<T, kLocal, true, RowLayout>(
                xp, mp, kp, ep, n, nv, W, stride, grid, smem, s)
          : launch_products<T, kLocal, false, RowLayout>(
                xp, mp, kp, ep, n, nv, W, stride, grid, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned sum_grid =
      blocks_for(static_cast<long long>(nz + 1) * 8 * W);
  switch (mode) {
    case kUnmasked:
      elasticity_rows_sum_kernel<T, kUnmasked>
          <<<sum_grid, kThreads, 0, s>>>(ep, xp, mp, yp, n, nz, W, stride);
      break;
    case kFree:
      elasticity_rows_sum_kernel<T, kFree>
          <<<sum_grid, kThreads, 0, s>>>(ep, xp, mp, yp, n, nz, W, stride);
      break;
    default:
      elasticity_rows_sum_kernel<T, kConstrained>
          <<<sum_grid, kThreads, 0, s>>>(ep, xp, mp, yp, n, nz, W, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_coupling(const void* p, const void* ce, void* y, int n, int W,
                    void* stream) {
  const unsigned grid = blocks_for(static_cast<long long>(n + 1) * W,
                                   kCouplingThreads);
  coupling_rows_kernel<T><<<grid, kCouplingThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(ce),
      static_cast<T*>(y), n, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_projection(const void* x, const void* pe, void* out, void* ye,
                      int n, int W, int stride, int grid, int smem,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* ep = static_cast<T*>(ye);
  const cudaError_t err = launch_products<T, kProjRows, false, RowLayout>(
      static_cast<const T*>(x), nullptr, static_cast<const T*>(pe), ep, n, n,
      W, stride, grid, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g1 = n + 1;
  projection_sum_kernel<T><<<blocks_for(g1 * g1 * g1), kThreads, 0, s>>>(
      ep, static_cast<T*>(out), n, stride);
  return static_cast<int>(cudaGetLastError());
}

// The flat apply on nz layers of n x n cells ((2n+1)^2 (2nz+1) nodes in
// and out): nz = n on a whole grid; the slab mode (a z-slab of the node
// grid, every cell of it real) passes its depth.
template <typename T>
int launch_flat(const void* u, const void* ke, void* y, void* ye, int n,
                int nz, int stride, int grid, int smem, void* stream) {
  if (n < 1 || nz < 1 ||
      static_cast<long long>(stride) < static_cast<long long>(nz) * n * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* ep = static_cast<T*>(ye);
  const cudaError_t err = launch_products<T, kLocal, false, FlatLayout>(
      static_cast<const T*>(u), nullptr, static_cast<const T*>(ke), ep, n,
      nz, 0, stride, grid, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long g = 2 * n + 1;
  elasticity_flat_sum_kernel<T>
      <<<blocks_for(g * g * (2 * nz + 1)), kThreads, 0, s>>>(
          ep, static_cast<T*>(y), n, nz, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: every pointer and the stream are void*,
// every entry point returns cudaGetLastError() after its launches.
extern "C" {

// x, y: ((nz + 1) * 24, W); nz, nv: cell layers swept and real (n, n on
// a whole grid); ye: the (81, stride) product scratch; grid, smem: pass
// 1's launch plan.
int elasticity_rows_apply_f32(const void* x, const void* m, const void* ke,
                              void* y, void* ye, int n, int nz, int nv,
                              int W, int stride, int grid, int smem,
                              int mode, void* stream) {
  return launch_elasticity<float>(x, m, ke, y, ye, n, nz, nv, W, stride,
                                  grid, smem, mode, stream);
}

int elasticity_rows_apply_f64(const void* x, const void* m, const void* ke,
                              void* y, void* ye, int n, int nz, int nv,
                              int W, int stride, int grid, int smem,
                              int mode, void* stream) {
  return launch_elasticity<double>(x, m, ke, y, ye, n, nz, nv, W, stride,
                                   grid, smem, mode, stream);
}

int coupling_rows_f32(const void* p, const void* ce, void* y, int n, int W,
                      void* stream) {
  return launch_coupling<float>(p, ce, y, n, W, stream);
}

int coupling_rows_f64(const void* p, const void* ce, void* y, int n, int W,
                      void* stream) {
  return launch_coupling<double>(p, ce, y, n, W, stream);
}

// ye: the (48, stride) product scratch; grid, smem: pass 1's launch plan.
int projection_rows_f32(const void* x, const void* pe, void* out, void* ye,
                        int n, int W, int stride, int grid, int smem,
                        void* stream) {
  return launch_projection<float>(x, pe, out, ye, n, W, stride, grid,
                                  smem, stream);
}

int projection_rows_f64(const void* x, const void* pe, void* out, void* ye,
                        int n, int W, int stride, int grid, int smem,
                        void* stream) {
  return launch_projection<double>(x, pe, out, ye, n, W, stride, grid,
                                   smem, stream);
}

// y = A u on flat ((2n+1)^2 (2nz+1) * 3,) vectors, nz cell layers along z
// (n on a whole grid); ye: the (81, stride) product scratch; grid, smem:
// pass 1's launch plan (the row-layout apply's).
int elasticity_grid_apply_f32(const void* u, const void* ke, void* y,
                              void* ye, int n, int nz, int stride, int grid,
                              int smem, void* stream) {
  return launch_flat<float>(u, ke, y, ye, n, nz, stride, grid, smem,
                            stream);
}

int elasticity_grid_apply_f64(const void* u, const void* ke, void* y,
                              void* ye, int n, int nz, int stride, int grid,
                              int smem, void* stream) {
  return launch_flat<double>(u, ke, y, ye, n, nz, stride, grid, smem,
                             stream);
}

}  // extern "C"
