// Hand-written Hopper kernels for the operator applies of the generic
// (unstructured) path: any conforming quad or hex mesh, cells-last arrays
// as in poroelasticity_dealii_torch/ops/operators.py and a dof-major
// scatter plan (ops/operators.py::ScatterPlan: row d lists the flat
// indices n * E + e of every connectivity entry equal to d, ascending,
// padded with n_values = n_local * E).  See ops/generic_apply.py for the
// wrappers, operand records and launch plans, ops/operators.py for the
// plain PyTorch twins and ops/geometry.py::map_factors and q1_tensor_map
// for the plain forms of the geometry the kernels rebuild.
//
// No Pallas kernel serves this path: the JAX package leaves it to XLA
// gathers, einsums and segment_sum.  The kernels replace that XLA code:
//
//  * generic_elasticity_apply: y = K u for isotropic elasticity with Q2
//    displacements in 2D and 3D (poroelasticity_dealii_tpu/ops/
//    operators.py:171 apply_elasticity, core elasticity_core :105).
//  * generic_q1_apply: y = alpha M x + beta L x for a Q1 scalar field,
//    batched over up to kMaxLanes leading lanes (operators.py:158
//    apply_mass and :164 apply_laplace, cores :89 and :94, with the
//    generic pressure Jacobian's coefficients, solvers/fss.py:294-295).
//    alpha = 0 leaves the mass out, beta = 0 the Laplacian.
//
// Geometry: every generic cell is the image of the reference cell under
// its trilinear (2D: bilinear) Q1 map.  The kernels read no stored
// Jacobian factors: they rebuild J, det J and J^-1 at each quadrature
// point from the cell's corner offsets X_n - X_0 (n = 1 .. 2^DIM - 1,
// (2^DIM - 1) * DIM values a cell, built in float64 on the host and then
// cast): the elasticity kernel from the Q1 shape gradients at the Q2
// Gauss points (~170 flop a point in 3D), the Q1 kernel in tensor-product
// form.  Offsets, not absolute corners, keep float32 exact enough: the
// map's sum over the corners never subtracts two large coordinates.
//
// Bound (H100, 700 W; bytes at 3.35 TB/s; float32 at 67 TFLOP/s, float64
// outside DMMA at 34 TFLOP/s; the function's least operations: the
// elasticity products sum-factorised, the Q1 element in tensor-product
// form, plus the map's rebuild): on the distorted 40^3 hex mesh (64,000
// cells, 1,594,323 displacement dofs) the elasticity apply moves ~90 MB
// in float32 (the plan 51 MB, conn 21 MB, u and y 13 MB, the offsets
// 5 MB): 0.027 ms, bound by bytes (its ~1.05 GFLOP 0.016 ms); float64
// ~108 MB: 0.032 ms, bound by bytes (the same flop 0.031 ms; the float64
// kernel's dense DMMA products do 3.4x the products' work).  The
// stored-geometry design moved ~154 / 236 MB (the Jacobian factors and
// weights 69 / 138 MB): 0.046 / 0.070 ms.  The Q1 pressure Jacobian
// moves ~16 MB in float64 on one lane (the offsets 11 MB): 0.0048 ms
// (its ~95 MFLOP 0.0028 ms), against ~46 MB and 0.014 ms for the stored
// factors; on 6 lanes ~22 MB and ~272 MFLOP: 0.0080 ms, bound by its
// operations.  tools/apply_bench.py::generic_bound computes both bounds
// from a run's shapes.  The scratch round trip below is outside both.

// Design: two launches per apply, no atomics, results bitwise repeatable
// (the fixed-stress solver's skip-if-unchanged rule compares mechanics
// right-hand sides bitwise).
//  1. Products, cell-centric, no intermediate in device memory.  Each
//     tile's connectivity and offsets columns (cells are the contiguous
//     axis) arrive by TMA: one 2-D box each, (rows, cells of the tile),
//     on an mbarrier, from tensor maps the operand record encodes once
//     (a row stride of a multiple of 16 bytes: the record pads a copy
//     where the cell count does not give one); cells past E arrive as
//     zeros and are never stored.
//     Elasticity (generic_elasticity_products_kernel<T, DIM>): a
//     persistent grid of at most one resident wave walks tiles of kCells
//     consecutive cells through a ring of kStages stages, each holding a
//     tile's conn, offsets and gathered values U[n][(i,c)] (all n_local
//     indices read from the staged conn with cp.async: after a
//     renumbering the components of a node need not be neighbours).
//     While a tile computes, the next tile's U gather and, from the
//     pointwise step on, the tile after next's TMA boxes are in flight.
//     Per tile: R = D1 U, the reference gradients of all cells and
//     components ((q,m) x (i,c)); the pointwise algebra in registers, one
//     thread per (quadrature point, cell): the map's J^-1 and det J from
//     the offsets, h = r J^-1, sigma = lam tr(h) I + mu (h + h^T), times
//     JxW, t = s J^-T, written over R; then Y = D1^T T.  float32: on the
//     CUDA cores, sum-factorised (D1 is a tensor product of the 1D Q2
//     values and derivatives at the 3-point rule: one axis at a time,
//     ~3.4x fewer operations than the dense product, a task per line of
//     3 and column).  float64: mma.sync m16n8k8 (DMMA) with the cells and
//     components as the M side (R^T = U^T D1^T, Y^T = T^T D1), each warp
//     a 16-row tile of up to four 8-column n-tiles.  Y goes to the
//     (n_local, E) scratch in the plan's flat order (coalesced).
//     Q1 (generic_q1_products_kernel<T, DIM>): blocks of kQ1Cells cells,
//     each cell a pair of neighbouring threads of one warp, thread g the
//     nodes and Gauss points with i0 = s0 = g.  The element is evaluated
//     in tensor-product form (Q1Tensor: one axis contracted at a time, the
//     1D basis at the 2-point rule as constants), the map's J from the
//     offsets the same way, so the geometry of a point (det J, and K =
//     JxW J^-1 J^-T for the Laplacian) is built once in registers and
//     reused by every lane (input vector).  Each thread gathers every
//     lane's values at its own nodes first (all loads in flight at once);
//     per lane the pair exchanges them by one shuffle a node, each thread
//     takes its points' mass and Laplace weights, combined per point, back
//     to all nodes by the adjoint, and each node's sum is the thread's
//     part plus its partner's (one shuffle), written at once (a warp: two
//     node rows of 16 consecutive cells).
//  2. Sums, output-centric (plan_sum_kernel): one thread per dof walks its
//     plan row in ascending order, stops at the pad index and writes every
//     lane's sum: the fixed order of ops/operators.py::scatter_sum.  AMR
//     bucketing's phantom cells (dof 0 in conn, the reference cube's
//     offsets) are computed harmlessly and never summed: they are absent
//     from the plan.

#include <cuda.h>            // CUtensorMap and its enums (types only: the
                             // encoder is the driver's, found at run time)
#include <cuda_runtime.h>

#include <cstring>

#include "cell_products.cuh"   // cp_async, dmma_16x8x8

namespace {

constexpr int kSumThreads = 256;   // plan_sum_kernel
constexpr int kQ1Cells = 32;       // cells of a Q1 product block
constexpr int kQ1Group = 2;        // threads of a cell in that block
constexpr int kMaxLanes = 6;       // lanes of the Q1 apply (Voigt components)
constexpr int kMapBytes = 128;     // sizeof(CUtensorMap)

static_assert(sizeof(CUtensorMap) == kMapBytes, "tensor map size");

// Tile shapes of the elasticity product pass by value type and dimension;
// ops/generic_apply.py::ELASTICITY_TILE mirrors them.  float64 needs the
// cells x components of a tile (DIM * kCells) in whole 16-row DMMA tiles.
template <typename T, int DIM>
struct GenericTile;

template <>
struct GenericTile<float, 3> {
  static constexpr int kCells = 32;
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;
};

template <>
struct GenericTile<double, 3> {
  static constexpr int kCells = 16;
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = 2;
};

template <>
struct GenericTile<float, 2> {
  static constexpr int kCells = 64;
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = 4;
};

template <>
struct GenericTile<double, 2> {
  static constexpr int kCells = 32;
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = 4;
};

// Shared-memory layout of the elasticity product pass.  Values (element
// offsets of T): float32 the sum factorisation's intermediates X (XRows x
// LDX), float64 D1 (QMPad x LD1); R / T (RRows x LDX), kStages stages of
// U / Y (URows x LDX), the map's Q1 shape gradients DN (NQ x NV1 x DIM)
// and the quadrature weights (NQ).  Then, in bytes, 128-byte aligned for
// TMA: kStages stages of the tile's conn (NV x kCells int32) and offsets
// (OffRows x kCells), and one mbarrier per stage.  float64's row strides
// keep each DMMA fragment load at two wavefronts (LD1 = 4, LDX = 8 modulo
// 16 doubles) and its pads zero (whole 16-row tiles, 8-deep K steps).
template <typename T, int DIM>
struct ElasticityShape {
  using P = GenericTile<T, DIM>;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kStages = 2;
  static constexpr int kNQ = DIM == 3 ? 27 : 9;    // Q2 nodes = Gauss points
  static constexpr int kNV1 = DIM == 3 ? 8 : 4;    // corners of the Q1 map
  static constexpr int kQM = kNQ * DIM;             // rows (q, m)
  static constexpr int kNV = kNQ * DIM;             // local dofs (n, i)
  static constexpr int kOffRows = (kNV1 - 1) * DIM; // offsets (n - 1, i)
  static constexpr int kQMPad = (kQM + 7) / 8 * 8;  // 88 / 24
  static constexpr int kNPad = (kNQ + 7) / 8 * 8;   // 32 / 16
  static constexpr int kLD1 = kNPad + 4;
  static constexpr int kCols = DIM * P::kCells;     // columns (i, c)
  static constexpr int kLDX = kCols + 8;
  static constexpr int kXRows = kF32 ? 2 * kNQ : 0;   // (line, B | G, q)
  static constexpr int kRRows = kF32 ? kQM : kQMPad;
  static constexpr int kURows = kF32 ? kNQ : kNPad;
  static constexpr int kX = 0;
  static constexpr int kD1 = kX + kXRows * kLDX;
  static constexpr int kR = kD1 + (kF32 ? 0 : kQMPad * kLD1);
  static constexpr int kU = kR + kRRows * kLDX;
  static constexpr int kUStage = kURows * kLDX;
  static constexpr int kDN = kU + kStages * kUStage;
  static constexpr int kWQ = kDN + kNQ * kNV1 * DIM;
  static constexpr int kValues = kWQ + kNQ;
  static constexpr int kConnBox = kNV * P::kCells * 4;   // bytes of a box
  static constexpr int kOffBox =
      kOffRows * P::kCells * static_cast<int>(sizeof(T));
  static constexpr int kConnStage = (kConnBox + 127) / 128 * 128;
  static constexpr int kOffStage = (kOffBox + 127) / 128 * 128;
  static constexpr int kConnAt =
      (kValues * static_cast<int>(sizeof(T)) + 127) / 128 * 128;
  static constexpr int kOffAt = kConnAt + kStages * kConnStage;
  static constexpr int kBarAt = kOffAt + kStages * kOffStage;
  static constexpr int kSmemBytes = kBarAt + kStages * 8;
};

// The Q1 product pass's block: kQ1Cells cells, each a pair of
// neighbouring threads (kQ1Group), each thread half the quadrature points.
template <typename T, int DIM>
struct Q1Shape {
  static constexpr int kNP = 1 << DIM;              // Q1 nodes = Gauss points
  static constexpr int kThreads = kQ1Cells * kQ1Group;
  static constexpr int kOffRows = (kNP - 1) * DIM;
  static constexpr int kConnBox = kNP * kQ1Cells * 4;
  static constexpr int kOffBox =
      kOffRows * kQ1Cells * static_cast<int>(sizeof(T));
  static_assert(kQ1Group == 2, "the kernel pairs neighbouring lanes");
};

// ---------------------------------------------------------------------------
// TMA, mbarrier and cp.async groups
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the block's generic-proxy accesses of shared memory ordered before the
// async proxy's next writes there
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the one arrival of a barrier's phase, expecting `bytes` of TMA data
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// the 2-D box at (column x, row y) of `map` into shared memory at dst,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// the same, with an L2 cache policy (l2_evict_first) for the box's lines
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y,
                                            unsigned long long* bar,
                                            unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// an L2 policy that evicts the lines it loads first
__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N committed groups of this thread's cp.async landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the cell map
// ---------------------------------------------------------------------------

// 1 / v, correctly rounded (the value of the division 1 / v)
__device__ __forceinline__ float rcp(float v) { return __frcp_rn(v); }
__device__ __forceinline__ double rcp(double v) { return __drcp_rn(v); }

// The Q1 cell map at one quadrature point, rebuilt from the cell's corner
// offsets off[((n - 1) * DIM + i) * ld] = X_n[i] - X_0[i] (n = 1 ..
// 2^DIM - 1) and the Q1 shape gradients dn[n * DIM + j] at the point:
// J[i][j] = sum_n off_n[i] dn[n][j], n ascending (the gradients sum to
// zero over the corners, so X_0 drops out), jv = J^-1 by cofactors as
// ops/geometry.py::geometry_factors (its plain twin: map_factors);
// returns det J.
template <typename T, int DIM>
__device__ __forceinline__ T cell_map(const T* off, int ld, const T* dn,
                                      T (&jv)[DIM][DIM]) {
  constexpr int NV = 1 << DIM;
  T a[DIM][DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) {
    const T o = off[i * ld];
#pragma unroll
    for (int j = 0; j < DIM; ++j) a[i][j] = o * dn[DIM + j];
  }
#pragma unroll
  for (int n = 2; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      const T o = off[((n - 1) * DIM + i) * ld];
#pragma unroll
      for (int j = 0; j < DIM; ++j) a[i][j] += o * dn[n * DIM + j];
    }
  if constexpr (DIM == 2) {
    const T det = a[0][0] * a[1][1] - a[0][1] * a[1][0];
    const T inv = rcp(det);
    jv[0][0] = a[1][1] * inv;
    jv[0][1] = -a[0][1] * inv;
    jv[1][0] = -a[1][0] * inv;
    jv[1][1] = a[0][0] * inv;
    return det;
  } else {
    const T c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
    const T c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
    const T c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
    const T c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
    const T c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
    const T c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
    const T c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
    const T c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
    const T c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
    const T det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
    const T inv = rcp(det);
    jv[0][0] = c00 * inv;
    jv[0][1] = c10 * inv;
    jv[0][2] = c20 * inv;
    jv[1][0] = c01 * inv;
    jv[1][1] = c11 * inv;
    jv[1][2] = c21 * inv;
    jv[2][0] = c02 * inv;
    jv[2][1] = c12 * inv;
    jv[2][2] = c22 * inv;
    return det;
  }
}

// C^T = (A B)^T in float64 on the tensor cores: A[m][k] = At[k*LDA + m]
// (M rows, 16 per tile), B[k][n] = Bp[k*SK + n*SN] (N = 8 NT columns), K a
// multiple of 8 whose padding is zero in both; C[n][m] = C[n*LDC + m].
// Units of one 16-row tile x NB n-tiles over the block's warps.
template <int M, int N, int K, int LDA, int SK, int SN, int LDC, int NB,
          int THREADS>
__device__ __forceinline__ void gemm_dmma(const double* __restrict__ At,
                                          const double* __restrict__ Bp,
                                          double* __restrict__ C) {
  constexpr int MT = M / 16, NT = N / 8, NG = (NT + NB - 1) / NB;
  static_assert(M % 16 == 0 && N % 8 == 0 && K % 8 == 0, "DMMA tiles");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int unit = warp; unit < MT * NG; unit += THREADS / 32) {
    const int mt = unit % MT, ng = unit / MT;   // warp-uniform
    const double* a = At + 16 * mt + g;
    double acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8) {
      const double av[4] = {a[(k0 + t) * LDA], a[(k0 + t) * LDA + 8],
                            a[(k0 + t + 4) * LDA], a[(k0 + t + 4) * LDA + 8]};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int nt = ng * NB + j;
        if (nt < NT) {
          const double* b = Bp + (nt * 8 + g) * SN;
          dmma_16x8x8(acc[j], av, b[(k0 + t) * SK], b[(k0 + t + 4) * SK]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int nt = ng * NB + j;
      if (nt < NT) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          double* col = C + (nt * 8 + 2 * t + i) * LDC + 16 * mt + g;
          col[0] = acc[j][i];
          col[8] = acc[j][2 + i];
        }
      }
    }
  }
}

// The Q2 element's 1D factors at the 3-point Gauss rule: B(q, n) =
// l_n(xi_q) and G(q, n) = l_n'(xi_q), nodes -1, 0, 1, points xi_q =
// -sqrt(3/5), 0, sqrt(3/5).  D1[(q,m)][n] is their tensor product: G on
// axis m, B on the others (the record checks its dref is this rule).
struct Gauss3 {
  __device__ static __forceinline__ float b(int q, int n) {
    return q == 1 ? (n == 1 ? 1.f : 0.f)
                  : n == 1 ? 0.4f
                           : (n == q ? 0.68729833462074168852f
                                     : -0.08729833462074168852f);
  }
  __device__ static __forceinline__ float g(int q, int n) {
    return q == 1 ? (n == 0 ? -0.5f : n == 2 ? 0.5f : 0.f)
           : q == 0
               ? (n == 0 ? -1.27459666924148337704f
                         : n == 1 ? 1.54919333848296675408f
                                  : -0.27459666924148337704f)
               : (n == 0 ? 0.27459666924148337704f
                         : n == 1 ? -1.54919333848296675408f
                                  : 1.27459666924148337704f);
  }
};

// c0 x0 + c1 x1 + c2 x2 with the coefficients known at compile time (the
// loops that call it unroll): the terms of a zero coefficient left out
__device__ __forceinline__ float dot3(float c0, float x0, float c1, float x1,
                                      float c2, float x2) {
  float v = 0.f;
  bool any = false;
  if (c0 != 0.f) { v = c0 * x0; any = true; }
  if (c1 != 0.f) { v = any ? fmaf(c1, x1, v) : c1 * x1; any = true; }
  if (c2 != 0.f) v = any ? fmaf(c2, x2, v) : c2 * x2;
  return v;
}

// float32, sum-factorised on the CUDA cores: R[(q,m)][(i,c)] = sum_n
// D1[(q,m)][n] U[n][(i,c)], one axis at a time, each stage a task per
// (line of 3, column) over the block (consecutive threads on consecutive
// columns).  3D: axis 2 (U -> X: B and G of each line (n0, n1)), axis 1
// (X -> R at the rows of q0 = n0: B, G of the B half, B of the G half),
// axis 0 in place (G, B, B: the derivatives along xi0, xi1, xi2).  2D:
// axis 1 (U -> X), axis 0 (X -> R).
template <int DIM>
__device__ __forceinline__ void gradients(const float*, float* xs,
                                          const float* us, float* rs) {
  using S = ElasticityShape<float, DIM>;
  using G3 = Gauss3;
  constexpr int NC = S::kCols, LD = S::kLDX, NT = S::P::kThreads;
  constexpr int NL = DIM == 3 ? 9 : 3;   // lines of 3 nodes along an axis
  for (int w = threadIdx.x; w < NL * NC; w += NT) {
    const int line = w / NC, j = w - line * NC;
    const float* u = us + line * LD + j;
    const float u0 = u[0], u1 = u[NL * LD], u2 = u[2 * NL * LD];
    float* x = xs + line * 6 * LD + j;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      x[q * LD] = dot3(G3::b(q, 0), u0, G3::b(q, 1), u1, G3::b(q, 2), u2);
      x[(3 + q) * LD] =
          dot3(G3::g(q, 0), u0, G3::g(q, 1), u1, G3::g(q, 2), u2);
    }
  }
  __syncthreads();
  if constexpr (DIM == 3) {
    for (int w = threadIdx.x; w < 9 * NC; w += NT) {   // lines (n0, q2)
      const int line = w / NC, j = w - line * NC;
      const int n0 = line % 3, q2 = line / 3;
      float tb[3], tg[3];
#pragma unroll
      for (int n1 = 0; n1 < 3; ++n1) {
        tb[n1] = xs[((n0 + 3 * n1) * 6 + q2) * LD + j];
        tg[n1] = xs[((n0 + 3 * n1) * 6 + 3 + q2) * LD + j];
      }
#pragma unroll
      for (int q1 = 0; q1 < 3; ++q1) {
        float* r = rs + (n0 + 3 * q1 + 9 * q2) * 3 * LD + j;
        r[0] = dot3(G3::b(q1, 0), tb[0], G3::b(q1, 1), tb[1], G3::b(q1, 2),
                    tb[2]);
        r[LD] = dot3(G3::g(q1, 0), tb[0], G3::g(q1, 1), tb[1],
                     G3::g(q1, 2), tb[2]);
        r[2 * LD] = dot3(G3::b(q1, 0), tg[0], G3::b(q1, 1), tg[1],
                         G3::b(q1, 2), tg[2]);
      }
    }
    __syncthreads();
    for (int w = threadIdx.x; w < 9 * NC; w += NT) {   // lines (q1, q2)
      const int line = w / NC, j = w - line * NC;
      float* r = rs + (3 * line) * 3 * LD + j;   // q = n0 + 3 line
      float v[3][3];
#pragma unroll
      for (int n0 = 0; n0 < 3; ++n0)
#pragma unroll
        for (int m = 0; m < 3; ++m) v[m][n0] = r[(n0 * 3 + m) * LD];
#pragma unroll
      for (int q0 = 0; q0 < 3; ++q0) {
        r[(q0 * 3) * LD] = dot3(G3::g(q0, 0), v[0][0], G3::g(q0, 1),
                                v[0][1], G3::g(q0, 2), v[0][2]);
        r[(q0 * 3 + 1) * LD] = dot3(G3::b(q0, 0), v[1][0], G3::b(q0, 1),
                                    v[1][1], G3::b(q0, 2), v[1][2]);
        r[(q0 * 3 + 2) * LD] = dot3(G3::b(q0, 0), v[2][0], G3::b(q0, 1),
                                    v[2][1], G3::b(q0, 2), v[2][2]);
      }
    }
  } else {
    for (int w = threadIdx.x; w < 3 * NC; w += NT) {   // lines q1
      const int q1 = w / NC, j = w - q1 * NC;
      float tb[3], tg[3];
#pragma unroll
      for (int n0 = 0; n0 < 3; ++n0) {
        tb[n0] = xs[(n0 * 6 + q1) * LD + j];
        tg[n0] = xs[(n0 * 6 + 3 + q1) * LD + j];
      }
      float* r = rs + (3 * q1) * 2 * LD + j;
#pragma unroll
      for (int q0 = 0; q0 < 3; ++q0) {
        r[(q0 * 2) * LD] = dot3(G3::g(q0, 0), tb[0], G3::g(q0, 1), tb[1],
                                G3::g(q0, 2), tb[2]);
        r[(q0 * 2 + 1) * LD] = dot3(G3::b(q0, 0), tg[0], G3::b(q0, 1),
                                    tg[1], G3::b(q0, 2), tg[2]);
      }
    }
  }
}

template <int DIM>
__device__ __forceinline__ void gradients(const double* d1, double*,
                                          const double* us, double* rs) {
  using S = ElasticityShape<double, DIM>;
  gemm_dmma<S::kCols, S::kQMPad, S::kNPad, S::kLDX, 1, S::kLD1, S::kLDX, 4,
            S::P::kThreads>(us, d1, rs);
}

// Y[n][(i,c)] = sum_{(q,m)} D1[(q,m)][n] T[(q,m)][(i,c)]: float32 the
// adjoint stages of gradients in reverse order (axis 0 in place, axis 1
// to X, axis 2 to Y over U).
template <int DIM>
__device__ __forceinline__ void back_products(const float*, float* xs,
                                              float* rs, float* us) {
  using S = ElasticityShape<float, DIM>;
  using G3 = Gauss3;
  constexpr int NC = S::kCols, LD = S::kLDX, NT = S::P::kThreads;
  constexpr int NL = DIM == 3 ? 9 : 3;
  if constexpr (DIM == 3) {
    for (int w = threadIdx.x; w < 9 * NC; w += NT) {   // lines (q1, q2)
      const int line = w / NC, j = w - line * NC;
      float* r = rs + (3 * line) * 3 * LD + j;
      float t[3][3];
#pragma unroll
      for (int q0 = 0; q0 < 3; ++q0)
#pragma unroll
        for (int m = 0; m < 3; ++m) t[m][q0] = r[(q0 * 3 + m) * LD];
#pragma unroll
      for (int n0 = 0; n0 < 3; ++n0) {
        r[(n0 * 3) * LD] = dot3(G3::g(0, n0), t[0][0], G3::g(1, n0),
                                t[0][1], G3::g(2, n0), t[0][2]);
        r[(n0 * 3 + 1) * LD] = dot3(G3::b(0, n0), t[1][0], G3::b(1, n0),
                                    t[1][1], G3::b(2, n0), t[1][2]);
        r[(n0 * 3 + 2) * LD] = dot3(G3::b(0, n0), t[2][0], G3::b(1, n0),
                                    t[2][1], G3::b(2, n0), t[2][2]);
      }
    }
    __syncthreads();
    for (int w = threadIdx.x; w < 9 * NC; w += NT) {   // lines (n0, q2)
      const int line = w / NC, j = w - line * NC;
      const int n0 = line % 3, q2 = line / 3;
      float p[3][3];
#pragma unroll
      for (int q1 = 0; q1 < 3; ++q1)
#pragma unroll
        for (int m = 0; m < 3; ++m)
          p[m][q1] = rs[((n0 + 3 * q1 + 9 * q2) * 3 + m) * LD + j];
#pragma unroll
      for (int n1 = 0; n1 < 3; ++n1) {
        float* x = xs + ((n0 + 3 * n1) * 6 + q2) * LD + j;
        x[0] = dot3(G3::b(0, n1), p[0][0], G3::b(1, n1), p[0][1],
                    G3::b(2, n1), p[0][2]) +
               dot3(G3::g(0, n1), p[1][0], G3::g(1, n1), p[1][1],
                    G3::g(2, n1), p[1][2]);
        x[3 * LD] = dot3(G3::b(0, n1), p[2][0], G3::b(1, n1), p[2][1],
                         G3::b(2, n1), p[2][2]);
      }
    }
  } else {
    for (int w = threadIdx.x; w < 3 * NC; w += NT) {   // lines q1
      const int q1 = w / NC, j = w - q1 * NC;
      const float* r = rs + (3 * q1) * 2 * LD + j;
      float t0[3], t1[3];
#pragma unroll
      for (int q0 = 0; q0 < 3; ++q0) {
        t0[q0] = r[(q0 * 2) * LD];
        t1[q0] = r[(q0 * 2 + 1) * LD];
      }
#pragma unroll
      for (int n0 = 0; n0 < 3; ++n0) {
        xs[(n0 * 6 + q1) * LD + j] = dot3(G3::g(0, n0), t0[0], G3::g(1, n0),
                                          t0[1], G3::g(2, n0), t0[2]);
        xs[(n0 * 6 + 3 + q1) * LD + j] =
            dot3(G3::b(0, n0), t1[0], G3::b(1, n0), t1[1], G3::b(2, n0),
                 t1[2]);
      }
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < NL * NC; w += NT) {   // lines of the last axis
    const int line = w / NC, j = w - line * NC;
    const float* x = xs + line * 6 * LD + j;
    float sb[3], sg[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      sb[q] = x[q * LD];
      sg[q] = x[(3 + q) * LD];
    }
#pragma unroll
    for (int n = 0; n < 3; ++n)
      us[(line + n * NL) * LD + j] =
          dot3(G3::b(0, n), sb[0], G3::b(1, n), sb[1], G3::b(2, n), sb[2]) +
          dot3(G3::g(0, n), sg[0], G3::g(1, n), sg[1], G3::g(2, n), sg[2]);
  }
}

template <int DIM>
__device__ __forceinline__ void back_products(const double* d1, double*,
                                              const double* rs, double* us) {
  using S = ElasticityShape<double, DIM>;
  gemm_dmma<S::kCols, S::kNPad, S::kQMPad, S::kLDX, S::kLD1, 1, S::kLDX, 4,
            S::P::kThreads>(rs, d1, us);
}

// Pass 1 of the elasticity apply: ye[(n*DIM + i)*E + e] = (K_e u_e)[n, i]
// for every cell e < E.  conn_map: (DIM*3^DIM, E) int32; offs_map:
// ((2^DIM - 1)*DIM, E) values; boxes of kCells cells.
template <typename T, int DIM>
__global__ void __launch_bounds__(GenericTile<T, DIM>::kThreads,
                                  GenericTile<T, DIM>::kMinBlocks)
generic_elasticity_products_kernel(const __grid_constant__ CUtensorMap
                                       conn_map,
                                   const __grid_constant__ CUtensorMap
                                       offs_map,
                                   const T* __restrict__ u,
                                   const T* __restrict__ dref,
                                   const T* __restrict__ dn1,
                                   const T* __restrict__ wq,
                                   T* __restrict__ ye, T lam, T mu, int E) {
  using S = ElasticityShape<T, DIM>;
  constexpr int TC = S::P::kCells, NT = S::P::kThreads;
  constexpr int NS = S::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* xs = sm + S::kX;
  T* d1 = sm + S::kD1;
  T* rs = sm + S::kR;
  T* dn = sm + S::kDN;
  T* ws = sm + S::kWQ;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem_raw + S::kBarAt);
  const int tid = threadIdx.x;
  const int tiles = (E + TC - 1) / TC;
  // this block's tiles: blockIdx.x + k * gridDim.x, k < mine
  const int mine = static_cast<int>(blockIdx.x) < tiles
                       ? (tiles - 1 - static_cast<int>(blockIdx.x)) /
                                 static_cast<int>(gridDim.x) + 1
                       : 0;
  auto first_cell = [&](int k) {
    return (static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x)) *
           TC;
  };
  auto conn_stage = [&](int s) {
    return reinterpret_cast<int*>(smem_raw + S::kConnAt + s * S::kConnStage);
  };
  auto offs_stage = [&](int s) {
    return reinterpret_cast<T*>(smem_raw + S::kOffAt + s * S::kOffStage);
  };
  auto u_stage = [&](int s) { return sm + S::kU + s * S::kUStage; };
  // one thread: tile k's conn and offsets boxes into stage s
  auto issue = [&](int k, int s) {
    mbar_expect_tx(bars + s, S::kConnBox + S::kOffBox);
    tma_load_2d(conn_stage(s), &conn_map, first_cell(k), 0, bars + s);
    tma_load_2d(offs_stage(s), &offs_map, first_cell(k), 0, bars + s);
  };
  // every thread: tile k's values U[n][(i,c)] from its staged conn, async
  auto gather = [&](int k, int s) {
    const int c0 = first_cell(k);
    const int* cs = conn_stage(s);
    T* us = u_stage(s);
    for (int w = tid; w < S::kNV * TC; w += NT) {
      const int row = w / TC, c = w - row * TC;
      const int n = row / DIM, i = row - n * DIM;
      T* dst = us + n * S::kLDX + i * TC + c;
      if (c0 + c < E)
        cp_async(dst, u + cs[w]);
      else
        *dst = T(0);
    }
    cp_async_commit();
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bars + s);
    fence_barrier_init();
    for (int k = 0; k < NS && k < mine; ++k) issue(k, k);
  }
  // zeros in every value region once: every padding the products read
  // stays zero (the boxes' regions are the TMA's alone)
  for (int i = tid; i < S::kValues; i += NT) sm[i] = T(0);
  __syncthreads();
  if constexpr (!S::kF32) {
    for (int i = tid; i < S::kNQ * S::kNQ * DIM; i += NT) {
      const int q = i / (S::kNQ * DIM), rem = i - q * (S::kNQ * DIM);
      const int n = rem / DIM, m = rem - n * DIM;
      d1[(q * DIM + m) * S::kLD1 + n] = dref[i];
    }
  }
  for (int i = tid; i < S::kNQ * S::kNV1 * DIM; i += NT) dn[i] = dn1[i];
  for (int i = tid; i < S::kNQ; i += NT) ws[i] = wq[i];
  if (mine > 0) {
    mbar_wait(bars, 0);
    gather(0, 0);
  }

  for (int k = 0; k < mine; ++k) {
    const int s = k % NS, c0 = first_cell(k);
    T* us = u_stage(s);
    // the next tile's gather goes out before this tile computes
    if (k + 1 < mine) {
      const int s1 = (k + 1) % NS;
      mbar_wait(bars + s1, ((k + 1) / NS) & 1);
      gather(k + 1, s1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // U of tile k, and the tables, in for every thread
    gradients<DIM>(d1, xs, us, rs);
    __syncthreads();
    // the pointwise algebra of ops/operators.py::elasticity_core, one
    // (quadrature point, cell) per thread, the map rebuilt from the
    // offsets, T written over R; cells past E give zeros
    const T* os = offs_stage(s);
    for (int w = tid; w < S::kNQ * TC; w += NT) {
      const int q = w / TC, c = w - q * TC;
      const bool live = c0 + c < E;
      T jv[DIM][DIM], r[DIM][DIM], h[DIM][DIM], sg[DIM][DIM];
      const T det = cell_map<T, DIM>(os + c, TC, dn + q * S::kNV1 * DIM, jv);
      const T wjq = det * ws[q];
#pragma unroll
      for (int m = 0; m < DIM; ++m)
#pragma unroll
        for (int j = 0; j < DIM; ++j)
          r[m][j] = rs[(q * DIM + m) * S::kLDX + j * TC + c];   // r[m][i]
#pragma unroll
      for (int i = 0; i < DIM; ++i)
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
          T v = r[0][i] * jv[0][j];
#pragma unroll
          for (int m = 1; m < DIM; ++m) v += r[m][i] * jv[m][j];
          h[i][j] = v;
        }
      T tr = h[0][0];
#pragma unroll
      for (int i = 1; i < DIM; ++i) tr += h[i][i];
#pragma unroll
      for (int i = 0; i < DIM; ++i)
#pragma unroll
        for (int j = 0; j < DIM; ++j)
          sg[i][j] =
              (mu * (h[i][j] + h[j][i]) + (i == j ? lam * tr : T(0))) * wjq;
#pragma unroll
      for (int m = 0; m < DIM; ++m)
#pragma unroll
        for (int i = 0; i < DIM; ++i) {
          T v = sg[i][0] * jv[m][0];
#pragma unroll
          for (int j = 1; j < DIM; ++j) v += sg[i][j] * jv[m][j];
          rs[(q * DIM + m) * S::kLDX + i * TC + c] = live ? v : T(0);
        }
    }
    __syncthreads();   // stage s's conn and offsets read: free for TMA
    if (tid == 0 && k + NS < mine) {
      fence_proxy_async();
      issue(k + NS, s);
    }
    back_products<DIM>(d1, xs, rs, us);
    __syncthreads();
    for (int w = tid; w < S::kNV * TC; w += NT) {
      const int row = w / TC, c = w - row * TC, e = c0 + c;
      const int n = row / DIM, i = row - n * DIM;
      if (e < E)
        ye[static_cast<long long>(row) * E + e] =
            us[n * S::kLDX + i * TC + c];
    }
    __syncthreads();   // Y out of stage s: free for tile k + NS's gather
  }
}

// The Q1 element on the 2-point Gauss rule, in tensor-product form: the 1D
// basis l_0 = (1 - xi) / 2, l_1 = (1 + xi) / 2 at xi_s = -+1/sqrt(3) is
// B(s, i) = P if s == i else M, its derivative -+1/2; the weights are 1.
// A nodal field v[i0 + 2 i1 (+ 4 i2)] gives its value and gradient at the
// points (s0 = g, s1 (, s2)) of one thread (g: the thread's place in its
// cell's pair) by contracting one axis at a time, and the adjoint maps
// weights at those points back to the nodes.  The record checks that its
// shape tables are this rule (ops/generic_apply.py::Q1Operands); the map
// built this way has the plain twin ops/geometry.py::q1_tensor_map.
template <typename T>
struct Gauss2 {
  static constexpr T kP = T(0.78867513459481288225457439025098);
  static constexpr T kM = T(0.21132486540518711774542560974902);
  static constexpr T kH = T(0.5);
  __device__ static __forceinline__ T b(int s, int i) {
    return s == i ? kP : kM;
  }
};

// Forward: v (NP nodes) -> at the thread's points k = s1 (+ 2 s2): val[k],
// the reference gradient d0[k] (along xi0), d1 (along xi1: by s2 in 3D,
// one value in 2D) and, in 3D, d2[s1] (along xi2); b0, b1 = B(g, 0),
// B(g, 1).  The derivatives are computed only with `grad`.
template <typename T, int DIM>
struct Q1Tensor;

template <typename T>
struct Q1Tensor<T, 3> {
  using G = Gauss2<T>;
  __device__ static __forceinline__ void interp2(const T (&x)[4],
                                                 T (&out)[4]) {
    T c[4];   // [s1 + 2 i2]
#pragma unroll
    for (int s1 = 0; s1 < 2; ++s1)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
        c[s1 + 2 * i2] =
            G::b(s1, 0) * x[2 * i2] + G::b(s1, 1) * x[1 + 2 * i2];
#pragma unroll
    for (int s1 = 0; s1 < 2; ++s1)
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2)
        out[s1 + 2 * s2] = G::b(s2, 0) * c[s1] + G::b(s2, 1) * c[s1 + 2];
  }
  __device__ static __forceinline__ void interp2_t(const T (&x)[4],
                                                   T (&out)[4]) {
    T c[4];   // [s1 + 2 i2]
#pragma unroll
    for (int s1 = 0; s1 < 2; ++s1)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
        c[s1 + 2 * i2] = G::b(0, i2) * x[s1] + G::b(1, i2) * x[s1 + 2];
#pragma unroll
    for (int i1 = 0; i1 < 2; ++i1)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
        out[i1 + 2 * i2] =
            G::b(0, i1) * c[2 * i2] + G::b(1, i1) * c[1 + 2 * i2];
  }
  // val, d0: [s1 + 2 s2]; d1: [s2]; d2: [s1]
  __device__ static __forceinline__ void forward(
      const T (&v)[8], T b0, T b1, bool value, bool grad, T (&val)[4],
      T (&d0)[4], T (&d1)[2], T (&d2)[2]) {
    T a[4], d[4];   // [i1 + 2 i2]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = b0 * v[2 * j] + b1 * v[2 * j + 1];
      d[j] = G::kH * (v[2 * j + 1] - v[2 * j]);
    }
    if (value) interp2(a, val);
    if (grad) {
      interp2(d, d0);
      const T e0 = G::kH * (a[1] - a[0]), e1 = G::kH * (a[3] - a[2]);
      const T f0 = G::kH * (a[2] - a[0]), f1 = G::kH * (a[3] - a[1]);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        d1[s] = G::b(s, 0) * e0 + G::b(s, 1) * e1;
        d2[s] = G::b(s, 0) * f0 + G::b(s, 1) * f1;
      }
    }
  }
  // Adjoint: y (NP nodes) = the transposed forward of W (values) and
  // T0, T1, T2 (gradient components) at the thread's points.
  __device__ static __forceinline__ void adjoint(
      const T (&W)[4], const T (&T0)[4], const T (&T1)[4], const T (&T2)[4],
      T b0, T b1, bool value, bool grad, T (&y)[8]) {
    T A[4], A0[4];   // [i1 + 2 i2]
    if (value) {
      interp2_t(W, A);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) A[j] = T(0);
    }
    if (grad) {
      interp2_t(T0, A0);
      const T t1s0 = T1[0] + T1[1], t1s1 = T1[2] + T1[3];   // by s2
      const T t2s0 = T2[0] + T2[2], t2s1 = T2[1] + T2[3];   // by s1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T e = G::kH * (G::b(0, i) * t1s0 + G::b(1, i) * t1s1);
        A[1 + 2 * i] += e;
        A[2 * i] -= e;
        const T f = G::kH * (G::b(0, i) * t2s0 + G::b(1, i) * t2s1);
        A[i + 2] += f;
        A[i] -= f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) A0[j] = T(0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[2 * j] = b0 * A[j] - G::kH * A0[j];
      y[2 * j + 1] = b1 * A[j] + G::kH * A0[j];
    }
  }
  // the reference gradient of the forward at point k
  __device__ static __forceinline__ void at(const T (&d0)[4],
                                            const T (&d1)[2],
                                            const T (&d2)[2], int k,
                                            T (&r)[3]) {
    r[0] = d0[k];
    r[1] = d1[k >> 1];
    r[2] = d2[k & 1];
  }
};

template <typename T>
struct Q1Tensor<T, 2> {
  using G = Gauss2<T>;
  // val, d0: [s1]; d1: one value (its 2 entries equal); d2 unused
  __device__ static __forceinline__ void forward(
      const T (&v)[4], T b0, T b1, bool value, bool grad, T (&val)[2],
      T (&d0)[2], T (&d1)[2], T (&)[2]) {
    const T a0 = b0 * v[0] + b1 * v[1], a1 = b0 * v[2] + b1 * v[3];
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (value) val[s] = G::b(s, 0) * a0 + G::b(s, 1) * a1;
    if (grad) {
      const T c0 = G::kH * (v[1] - v[0]), c1 = G::kH * (v[3] - v[2]);
#pragma unroll
      for (int s = 0; s < 2; ++s) d0[s] = G::b(s, 0) * c0 + G::b(s, 1) * c1;
      d1[0] = d1[1] = G::kH * (a1 - a0);
    }
  }
  __device__ static __forceinline__ void adjoint(
      const T (&W)[2], const T (&T0)[2], const T (&T1)[2], const T (&)[2],
      T b0, T b1, bool value, bool grad, T (&y)[4]) {
    T A[2], A0[2];   // [i1]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      A[i] = value ? G::b(0, i) * W[0] + G::b(1, i) * W[1] : T(0);
      A0[i] = grad ? G::b(0, i) * T0[0] + G::b(1, i) * T0[1] : T(0);
    }
    if (grad) {
      const T t1 = G::kH * (T1[0] + T1[1]);
      A[1] += t1;
      A[0] -= t1;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      y[2 * i] = b0 * A[i] - G::kH * A0[i];
      y[2 * i + 1] = b1 * A[i] + G::kH * A0[i];
    }
  }
  __device__ static __forceinline__ void at(const T (&d0)[2],
                                            const T (&d1)[2],
                                            const T (&)[2], int k,
                                            T (&r)[2]) {
    r[0] = d0[k];
    r[1] = d1[0];
  }
};

// The map's det J at the thread's points and, with `grad`, K = JxW J^-1
// J^-T (symmetric, [m][m'] packed as kSym entries), from the J columns at
// point k: the cofactors, det, 1/det (one IEEE reciprocal), K = (1/det)
// C^T C with C the cofactor matrix (the weights are 1).
template <typename T, int DIM>
__device__ __forceinline__ T q1_map(const T (&J)[DIM][DIM], bool grad,
                                    T (&K)[DIM * (DIM + 1) / 2]) {
  if constexpr (DIM == 2) {
    const T det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    if (grad) {
      const T inv = rcp(det);
      K[0] = inv * (J[1][1] * J[1][1] + J[0][1] * J[0][1]);
      K[1] = -inv * (J[1][1] * J[1][0] + J[0][1] * J[0][0]);
      K[2] = inv * (J[1][0] * J[1][0] + J[0][0] * J[0][0]);
    }
    return det;
  } else {
    const T c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const T c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const T c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const T det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
    if (grad) {
      const T c10 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
      const T c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
      const T c12 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
      const T c20 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
      const T c21 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
      const T c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      const T inv = rcp(det);
      K[0] = inv * (c00 * c00 + c10 * c10 + c20 * c20);   // [0][0]
      K[1] = inv * (c00 * c01 + c10 * c11 + c20 * c21);   // [0][1]
      K[2] = inv * (c00 * c02 + c10 * c12 + c20 * c22);   // [0][2]
      K[3] = inv * (c01 * c01 + c11 * c11 + c21 * c21);   // [1][1]
      K[4] = inv * (c01 * c02 + c11 * c12 + c21 * c22);   // [1][2]
      K[5] = inv * (c02 * c02 + c12 * c12 + c22 * c22);   // [2][2]
    }
    return det;
  }
}

// Pass 1 of the Q1 apply: ye[(b*NP + n)*E + e] = (alpha M_e + beta L_e)
// x_b,e [n] for every lane b < lanes and cell e < E (NP = 2^DIM).
// conn_map: (NP, E) int32; offs_map: ((NP - 1)*DIM, E) values; boxes of
// kQ1Cells cells.  A cell is a pair of neighbouring lanes of one warp:
// thread g holds the nodes and takes the points with i0 = s0 = g.  LANES:
// the most lanes (1 or kMaxLanes: a one-lane call holds one lane's
// registers); LAP: beta != 0 (the mass alone holds no Laplacian
// registers).  A kMaxLanes call's scratch (kMaxLanes * 2^DIM values a
// cell, read back by the plan sum) outweighs the boxes, which are read
// once: it loads them evict-first from L2.
template <typename T, int DIM, int LANES, bool LAP>
__global__ void __launch_bounds__(Q1Shape<T, DIM>::kThreads)
generic_q1_products_kernel(const __grid_constant__ CUtensorMap conn_map,
                           const __grid_constant__ CUtensorMap offs_map,
                           const T* __restrict__ x, T* __restrict__ ye,
                           T alpha, T beta, int lanes, int n_in, int E) {
  using S = Q1Shape<T, DIM>;
  using Q = Q1Tensor<T, DIM>;
  constexpr int NP = S::kNP, NH = NP / 2, TC = kQ1Cells;
  constexpr int NS = DIM * (DIM + 1) / 2;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ __align__(128) int conn_s[NP * TC];          // [n][c]
  __shared__ __align__(128) T offs_s[S::kOffRows * TC];   // [(n-1, i)][c]
  __shared__ __align__(8) unsigned long long bar;
  const int tid = threadIdx.x, c = tid >> 1, g = tid & 1;
  const int c0 = static_cast<int>(blockIdx.x) * TC, e = c0 + c;
  const bool live = e < E;
  const T b0 = Gauss2<T>::b(g, 0), b1 = Gauss2<T>::b(g, 1);
  if (tid == 0) {
    mbar_init(&bar);
    fence_barrier_init();
    mbar_expect_tx(&bar, S::kConnBox + S::kOffBox);
    if constexpr (LANES == kMaxLanes) {
      const unsigned long long policy = l2_evict_first();
      tma_load_2d(conn_s, &conn_map, c0, 0, &bar, policy);
      tma_load_2d(offs_s, &offs_map, c0, 0, &bar, policy);
    } else {
      tma_load_2d(conn_s, &conn_map, c0, 0, &bar);
      tma_load_2d(offs_s, &offs_map, c0, 0, &bar);
    }
  }
  __syncthreads();   // the barrier initialised
  mbar_wait(&bar, 0);

  // every lane's values at this thread's nodes 2j + g, all loads in flight
  int idx[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j) idx[j] = conn_s[(2 * j + g) * TC + c];
  T xg[LANES][NH];
#pragma unroll
  for (int b = 0; b < LANES; ++b)
#pragma unroll
    for (int j = 0; j < NH; ++j)
      xg[b][j] = (b == 0 || b < lanes) && live
                     ? __ldg(x + static_cast<long long>(b) * n_in + idx[j])
                     : T(0);
  const bool mass = alpha != T(0);
  constexpr bool lap = LAP;
  // the map at the thread's points: J from the corner offsets (X_0 = 0),
  // then det J and K, kept for every lane
  T J[NH][DIM][DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) {
    T v[NP], val[NH], d0[NH], d1[2], d2[2];
    v[0] = T(0);
#pragma unroll
    for (int n = 1; n < NP; ++n) v[n] = offs_s[((n - 1) * DIM + i) * TC + c];
    Q::forward(v, b0, b1, false, true, val, d0, d1, d2);
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      T r[DIM];
      Q::at(d0, d1, d2, k, r);
#pragma unroll
      for (int m = 0; m < DIM; ++m) J[k][i][m] = r[m];
    }
  }
  T det[NH], K[NH][NS];
#pragma unroll
  for (int k = 0; k < NH; ++k) det[k] = q1_map<T, DIM>(J[k], lap, K[k]);

#pragma unroll
  for (int b = 0; b < LANES; ++b) {
    if (b >= lanes) break;
    // the cell's values: this thread's nodes and its partner's
    T v[NP];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const T other = __shfl_xor_sync(kAll, xg[b][j], 1);
      v[2 * j] = g ? other : xg[b][j];
      v[2 * j + 1] = g ? xg[b][j] : other;
    }
    T val[NH], d0[NH], d1[2], d2[2];
    Q::forward(v, b0, b1, mass, lap, val, d0, d1, d2);
    T W[NH], T0[NH], T1[NH], T2[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      W[k] = mass ? alpha * (det[k] * val[k]) : T(0);
      T r[DIM];
      Q::at(d0, d1, d2, k, r);
      T t[DIM];
      if constexpr (DIM == 2) {
        t[0] = K[k][0] * r[0] + K[k][1] * r[1];
        t[1] = K[k][1] * r[0] + K[k][2] * r[1];
      } else {
        t[0] = K[k][0] * r[0] + K[k][1] * r[1] + K[k][2] * r[2];
        t[1] = K[k][1] * r[0] + K[k][3] * r[1] + K[k][4] * r[2];
        t[2] = K[k][2] * r[0] + K[k][4] * r[1] + K[k][5] * r[2];
      }
      T0[k] = lap ? beta * t[0] : T(0);
      T1[k] = lap ? beta * t[1] : T(0);
      T2[k] = lap && DIM == 3 ? beta * t[DIM - 1] : T(0);
    }
    T y[NP];
    Q::adjoint(W, T0, T1, T2, b0, b1, mass, lap, y);
    // each node's sum by the thread holding it: its own part, then its
    // partner's; a warp writes two node rows of 16 consecutive cells
    T* out = ye + static_cast<long long>(b) * NP * E + e;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const T send = g ? y[2 * j] : y[2 * j + 1];
      const T keep = g ? y[2 * j + 1] : y[2 * j];
      const T sum = keep + __shfl_xor_sync(kAll, send, 1);
      if (live) out[static_cast<long long>(2 * j + g) * E] = sum;
    }
  }
}

// Pass 2: y[b*n_out + d] = the lane-b entries of ye (lane stride n_values)
// that plan row d lists, summed in its order; a row ends at its first pad
// index (>= n_values).  LANES: the most lanes (1 for the elasticity apply,
// kMaxLanes for the Q1 apply; the profiler tells the two apart by it).
template <typename T, int LANES>
__global__ void __launch_bounds__(kSumThreads)
plan_sum_kernel(const T* __restrict__ ye, const int* __restrict__ table,
                T* __restrict__ y, int n_out, int V, int n_values,
                int lanes) {
  const int d = blockIdx.x * kSumThreads + threadIdx.x;
  if (d >= n_out) return;
  const int* row = table + static_cast<long long>(d) * V;
  T acc[LANES];
#pragma unroll
  for (int b = 0; b < LANES; ++b) acc[b] = T(0);
  for (int v = 0; v < V; ++v) {
    const int idx = __ldg(row + v);
    if (idx >= n_values) break;
#pragma unroll
    for (int b = 0; b < LANES; ++b)
      if (b < lanes) acc[b] += ye[static_cast<long long>(b) * n_values + idx];
  }
#pragma unroll
  for (int b = 0; b < LANES; ++b)
    if (b < lanes) y[static_cast<long long>(b) * n_out + d] = acc[b];
}

constexpr int kMaxDevices = 64;
constexpr long long kIntMax = 2147483647LL;

inline unsigned sum_blocks(int n) {
  return static_cast<unsigned>((n + kSumThreads - 1) / kSumThreads);
}

// The two tensor maps (conn, offsets) an operand record encoded, from the
// host buffer the wrapper passes: copied into the launch's parameters.
struct Maps {
  CUtensorMap conn, offs;
};

inline Maps read_maps(const void* maps) {
  Maps m;
  std::memcpy(&m.conn, maps, kMapBytes);
  std::memcpy(&m.offs, static_cast<const unsigned char*>(maps) + kMapBytes,
              kMapBytes);
  return m;
}

// Pass 1 of the elasticity apply with the plan the wrapper passes; refuse
// any other plan.  The tile exceeds the 48 KB a block gets without opting
// in; the attribute is per device, set at a device's first launch.
template <typename T, int DIM>
cudaError_t launch_elasticity_products(const Maps& m, const T* u,
                                       const T* dref, const T* dn1,
                                       const T* wq, T* ye, T lam, T mu,
                                       int E, int grid, int smem,
                                       cudaStream_t s) {
  using S = ElasticityShape<T, DIM>;
  const long long tiles = (E + S::P::kCells - 1) / S::P::kCells;
  if (smem != S::kSmemBytes || grid < 1 || grid > tiles)
    return cudaErrorInvalidValue;
  void (*products)(const CUtensorMap, const CUtensorMap, const T*, const T*,
                   const T*, const T*, T*, T, T, int) =
      generic_elasticity_products_kernel<T, DIM>;
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
  products<<<grid, S::P::kThreads, smem, s>>>(m.conn, m.offs, u, dref, dn1,
                                              wq, ye, lam, mu, E);
  return cudaGetLastError();
}

// y = K u: u (any length: it is read at conn's indices only), maps the
// record's tensor maps of conn (DIM*3^DIM, E) and the offsets
// ((2^DIM - 1)*DIM, E), dref (3^DIM, 3^DIM, DIM), dn1 (3^DIM, 2^DIM, DIM)
// and wq (3^DIM,) the map's gradients and weights at the Q2 Gauss points,
// table (n_out, V), y (n_out,), ye the (DIM*3^DIM, E) scratch.
template <typename T>
int launch_generic_elasticity(const void* u, const void* maps,
                              const void* dref, const void* dn1,
                              const void* wq, const void* table, void* y,
                              void* ye, double lam, double mu, int dim,
                              int E, int V, int n_out, int grid, int smem,
                              void* stream) {
  if ((dim != 2 && dim != 3) || E < 0 || V < 1 || n_out < 0 ||
      static_cast<long long>(dim == 3 ? 81 : 18) * E > kIntMax ||
      static_cast<long long>(n_out) * V > kIntMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_values = (dim == 3 ? 81 : 18) * E;
  T* ep = static_cast<T*>(ye);
  if (E > 0) {
    const Maps m = read_maps(maps);
    const T* up = static_cast<const T*>(u);
    const T* dp = static_cast<const T*>(dref);
    const T* np = static_cast<const T*>(dn1);
    const T* wp = static_cast<const T*>(wq);
    const cudaError_t err =
        dim == 3 ? launch_elasticity_products<T, 3>(m, up, dp, np, wp, ep,
                                                    T(lam), T(mu), E, grid,
                                                    smem, s)
                 : launch_elasticity_products<T, 2>(m, up, dp, np, wp, ep,
                                                    T(lam), T(mu), E, grid,
                                                    smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_out > 0)
    plan_sum_kernel<T, 1><<<sum_blocks(n_out), kSumThreads, 0, s>>>(
        ep, static_cast<const int*>(table), static_cast<T*>(y), n_out, V,
        n_values, 1);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 of the Q1 apply: the one-lane instance for one lane, else the
// kMaxLanes one; the Laplacian's where beta != 0, else the mass's.
template <typename T, int DIM>
cudaError_t launch_q1_products(const Maps& m, const T* x, T* ye, T alpha,
                               T beta, int lanes, int n_in, int E, int grid,
                               cudaStream_t s) {
  constexpr int threads = Q1Shape<T, DIM>::kThreads;
  const bool lap = beta != T(0);
  if (lanes == 1 && lap)
    generic_q1_products_kernel<T, DIM, 1, true><<<grid, threads, 0, s>>>(
        m.conn, m.offs, x, ye, alpha, beta, lanes, n_in, E);
  else if (lanes == 1)
    generic_q1_products_kernel<T, DIM, 1, false><<<grid, threads, 0, s>>>(
        m.conn, m.offs, x, ye, alpha, beta, lanes, n_in, E);
  else if (lap)
    generic_q1_products_kernel<T, DIM, kMaxLanes, true>
        <<<grid, threads, 0, s>>>(m.conn, m.offs, x, ye, alpha, beta, lanes,
                                  n_in, E);
  else
    generic_q1_products_kernel<T, DIM, kMaxLanes, false>
        <<<grid, threads, 0, s>>>(m.conn, m.offs, x, ye, alpha, beta, lanes,
                                  n_in, E);
  return cudaGetLastError();
}

// y = alpha M x + beta L x: x (lanes, n_in), maps the record's tensor maps
// of conn (2^DIM, E) and the offsets ((2^DIM - 1)*DIM, E) (the element:
// Q1 at the 2-point Gauss rule, Gauss2), table (n_out, V), y (lanes,
// n_out), ye the (lanes, 2^DIM, E) scratch; grid: ceil(E / kQ1Cells)
// blocks.
template <typename T>
int launch_generic_q1(const void* x, const void* maps, const void* table,
                      void* y, void* ye, double alpha, double beta, int dim,
                      int lanes, int n_in, int E, int V, int n_out, int grid,
                      void* stream) {
  const long long np = dim == 3 ? 8 : 4;
  if ((dim != 2 && dim != 3) || lanes < 1 || lanes > kMaxLanes || E < 0 ||
      V < 1 || n_out < 0 || n_in < 0 ||
      static_cast<long long>(grid) * kQ1Cells < static_cast<long long>(E) ||
      (E > 0 && static_cast<long long>(grid - 1) * kQ1Cells >= E) ||
      lanes * np * E > kIntMax || lanes * static_cast<long long>(n_in) >
      kIntMax || lanes * static_cast<long long>(n_out) > kIntMax ||
      static_cast<long long>(n_out) * V > kIntMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* ep = static_cast<T*>(ye);
  if (E > 0) {
    const Maps m = read_maps(maps);
    const T* xp = static_cast<const T*>(x);
    const cudaError_t err =
        dim == 3 ? launch_q1_products<T, 3>(m, xp, ep, T(alpha), T(beta),
                                            lanes, n_in, E, grid, s)
                 : launch_q1_products<T, 2>(m, xp, ep, T(alpha), T(beta),
                                            lanes, n_in, E, grid, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_out > 0)
    plan_sum_kernel<T, kMaxLanes><<<sum_blocks(n_out), kSumThreads, 0, s>>>(
        ep, static_cast<const int*>(table), static_cast<T*>(y), n_out, V,
        static_cast<int>(np * E), lanes);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, looked up once through the runtime (no link
// against the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of a (rows, E) array with row stride Ep elements, boxes of
// (rows, box_cells); columns past E read as zeros.
int encode_rows(EncodeTiled encode, unsigned char* out,
                CUtensorMapDataType type, int bytes, const void* base,
                int rows, int E, int Ep, int box_cells) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(E),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Ep) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cells),
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  std::memcpy(out, &map, kMapBytes);
  return 0;
}

template <typename T>
int elasticity_box_cells(int dim) {
  return dim == 3 ? GenericTile<T, 3>::kCells : GenericTile<T, 2>::kCells;
}

}  // namespace

// Plain C interface for ctypes: every pointer and the stream are void*,
// every entry point returns cudaGetLastError() after its launches.
extern "C" {

// The tensor maps of one operand record into out (2 * kMapBytes, host):
// conn (rows, E) int32 and offsets ((2^dim - 1)*dim, E) of value_bytes
// each, both with row stride Ep (a multiple of 4 elements, 16-byte
// aligned bases), boxes of the kernel's tile (kernel 0: the elasticity
// product pass, rows dim*3^dim; 1: the Q1 pass, rows 2^dim).  Returns 0,
// a cudaError_t, or the encoder's CUresult.
int generic_tensor_maps(void* out, const void* conn, const void* offsets,
                        int kernel, int value_bytes, int dim, int E, int Ep) {
  if ((dim != 2 && dim != 3) || (kernel != 0 && kernel != 1) ||
      (value_bytes != 4 && value_bytes != 8) || E < 1 || Ep < E ||
      Ep % 4 != 0 || out == nullptr ||
      reinterpret_cast<unsigned long long>(conn) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(offsets) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int nv1 = 1 << dim, nq = dim == 3 ? 27 : 9;
  const int conn_rows = kernel == 0 ? dim * nq : nv1;
  const int box = kernel == 1 ? kQ1Cells
                  : value_bytes == 4 ? elasticity_box_cells<float>(dim)
                                     : elasticity_box_cells<double>(dim);
  unsigned char* o = static_cast<unsigned char*>(out);
  const int err = encode_rows(encode, o, CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                              conn, conn_rows, E, Ep, box);
  if (err != 0) return err;
  return encode_rows(encode, o + kMapBytes,
                     value_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                     value_bytes, offsets, (nv1 - 1) * dim, E, Ep, box);
}

// grid, smem: pass 1's launch plan (ops/generic_apply.py::elasticity_plan)
int generic_elasticity_apply_f32(const void* u, const void* maps,
                                 const void* dref, const void* dn1,
                                 const void* wq, const void* table, void* y,
                                 void* ye, double lam, double mu, int dim,
                                 int E, int V, int n_out, int grid, int smem,
                                 void* stream) {
  return launch_generic_elasticity<float>(u, maps, dref, dn1, wq, table, y,
                                          ye, lam, mu, dim, E, V, n_out,
                                          grid, smem, stream);
}

int generic_elasticity_apply_f64(const void* u, const void* maps,
                                 const void* dref, const void* dn1,
                                 const void* wq, const void* table, void* y,
                                 void* ye, double lam, double mu, int dim,
                                 int E, int V, int n_out, int grid, int smem,
                                 void* stream) {
  return launch_generic_elasticity<double>(u, maps, dref, dn1, wq, table, y,
                                           ye, lam, mu, dim, E, V, n_out,
                                           grid, smem, stream);
}

int generic_q1_apply_f32(const void* x, const void* maps, const void* table,
                         void* y, void* ye, double alpha, double beta,
                         int dim, int lanes, int n_in, int E, int V,
                         int n_out, int grid, void* stream) {
  return launch_generic_q1<float>(x, maps, table, y, ye, alpha, beta, dim,
                                  lanes, n_in, E, V, n_out, grid, stream);
}

int generic_q1_apply_f64(const void* x, const void* maps, const void* table,
                         void* y, void* ye, double alpha, double beta,
                         int dim, int lanes, int n_in, int E, int V,
                         int n_out, int grid, void* stream) {
  return launch_generic_q1<double>(x, maps, table, y, ye, alpha, beta, dim,
                                   lanes, n_in, E, V, n_out, grid, stream);
}

}  // extern "C"
