// Hand-written Hopper kernels for the operator applies of the generic
// (unstructured) path: any conforming quad or hex mesh, cells-last arrays
// as in poroelasticity_dealii_torch/ops/operators.py (connectivity
// (n_local, E) int32, Jacobian factors (Q, dim, dim, Eg), weights (Q, Eg),
// Eg = E or 1 for geometry shared by every cell) and a dof-major scatter
// plan (ops/operators.py::ScatterPlan: row d lists the flat indices
// n * E + e of every connectivity entry equal to d, ascending, padded with
// n_values = n_local * E).  See ops/generic_apply.py for the wrappers and
// launch plans, and ops/operators.py for the plain PyTorch twins.
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
// Bound (H100, 700 W): on the distorted 40^3 hex mesh (64,000 cells,
// 1,594,323 displacement dofs) the elasticity apply moves ~155 MB in
// float32 (the Jacobian factors 62 MB, the plan 51 MB, conn 21 MB, u and y
// 13 MB): 0.046 ms at 3.35 TB/s, 0.070 ms in float64, against ~1.7 GFLOP
// of cell products (0.025 ms at 67 TFLOP/s): bound by bytes.  The scratch
// round trip below adds ~41 MB that the bound leaves out.  The Q1 apply
// moves ~25 MB (float32, one lane): 0.008 ms.  The plain twins are ~30x
// (elasticity) and ~20x (Q1) their bounds: every einsum and every
// pointwise step of the Jacobian algebra writes a (Q, dim, dim, E) array
// to device memory and reads it back.
//
// Design: two launches per apply, no atomics, results bitwise repeatable
// (the fixed-stress solver's skip-if-unchanged rule compares mechanics
// right-hand sides bitwise).
//  1. Products, cell-centric, no intermediate in device memory.
//     Elasticity (generic_elasticity_products_kernel<T, DIM>): a
//     persistent grid of at most one resident wave walks tiles of kCells
//     consecutive cells.  Each block stages the reference gradients once
//     (D1[(q,m)][n] = dref[q][n][m], zero-padded to the products' tile
//     shapes; float32 also the transpose).  Per tile it gathers the cells'
//     local values U[n][(i,c)] (all n_local indices read from conn: after
//     a renumbering the components of a node need not be neighbours) and
//     copies the tile's jinv and JxW columns (cells are the contiguous
//     axis: coalesced; Eg = 1 reads one column for all) into shared memory
//     with cp.async, one wait.  Then R = D1 U, the reference gradients of
//     all cells and components ((q,m) x (i,c)); the pointwise algebra in
//     registers, one thread per (quadrature point, cell): h = r J^-1,
//     sigma = lam tr(h) I + mu (h + h^T), times JxW, t = s J^-T, written
//     over R; then Y = D1^T T.  float32: register tiles of 4 x 4 on the
//     CUDA cores, both operands read as float4 (the D1 side warp-uniform:
//     broadcasts).  float64: mma.sync m16n8k8 (DMMA) with the cells and
//     components as the M side (R^T = U^T D1^T, Y^T = T^T D1), each warp
//     a 16-row tile of up to four 8-column n-tiles.  Y goes to the
//     (n_local, E) scratch in the plan's flat order (coalesced).
//     Q1 (generic_q1_products_kernel<T, DIM>): one thread per cell, the
//     2^DIM-point shape tables in shared memory, the lanes one after
//     another (a cell's geometry re-read from L1), mass and Laplace
//     contributions combined per cell before they are written.
//  2. Sums, output-centric (plan_sum_kernel): one thread per dof walks its
//     plan row in ascending order, stops at the pad index and writes every
//     lane's sum: the fixed order of ops/operators.py::scatter_sum.  AMR
//     bucketing's phantom cells (dof 0 in conn, zero jinv and JxW) are
//     computed harmlessly and never summed: they are absent from the plan.

#include <cuda_runtime.h>

#include "cell_products.cuh"   // cp_async, cp_async_wait_all, dmma_16x8x8

namespace {

constexpr int kSumThreads = 256;   // plan_sum_kernel
constexpr int kQ1Threads = 128;    // generic_q1_products_kernel
constexpr int kMaxLanes = 6;       // lanes of the Q1 apply (Voigt components)

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

// Shared-memory layout of the elasticity product pass (element offsets):
// D1 (QMPad x LD1), D1T (NPad x LD1T, float32 only), U / Y (NPad x LDX),
// R / T (QMPad x LDX), J (NQ*DIM*DIM x kCells), JW (NQ x kCells).  Row
// strides keep every float4 row aligned and each DMMA fragment load at two
// wavefronts (LD1 = 4, LDX = 8 modulo 16 doubles).
template <typename T, int DIM>
struct ElasticityShape {
  using P = GenericTile<T, DIM>;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kNQ = DIM == 3 ? 27 : 9;    // Q2 nodes = Gauss points
  static constexpr int kQM = kNQ * DIM;             // rows (q, m)
  static constexpr int kNV = kNQ * DIM;             // local dofs (n, i)
  static constexpr int kQMPad = (kQM + 7) / 8 * 8;  // 88 / 24
  static constexpr int kNPad = (kNQ + 7) / 8 * 8;   // 32 / 16
  static constexpr int kLD1 = kNPad + 4;
  static constexpr int kLD1T = kQMPad + 4;
  static constexpr int kCols = DIM * P::kCells;     // columns (i, c)
  static constexpr int kLDX = kCols + 8;
  static constexpr int kJRows = kNQ * DIM * DIM;
  static constexpr int kM1 = (kQM + 3) / 4 * 4;     // float32 rows of R
  static constexpr int kM2 = (kNQ + 3) / 4 * 4;     // float32 rows of Y
  static constexpr int kD1 = 0;
  static constexpr int kD1T = kD1 + kQMPad * kLD1;
  static constexpr int kU = kD1T + (kF32 ? kNPad * kLD1T : 0);
  static constexpr int kR = kU + kNPad * kLDX;
  static constexpr int kJ = kR + kQMPad * kLDX;
  static constexpr int kJW = kJ + kJRows * P::kCells;
  static constexpr int kTotal = kJW + kNQ * P::kCells;
  static constexpr int kSmemBytes = kTotal * static_cast<int>(sizeof(T));
  static_assert(kM1 <= kQMPad && kM2 <= kNPad, "float32 rows in the pads");
};

// C[m][n] (M x N, row stride LDC) = sum_{k<K} At[k][m] B[k][n] in float32
// on the CUDA cores: units of 4 x 4 outputs over the block's threads,
// neighbouring threads on neighbouring column quads (At reads broadcast).
template <int M, int N, int K, int LDA, int LDB, int LDC, int THREADS>
__device__ __forceinline__ void gemm_cuda_cores(const float* __restrict__ At,
                                                const float* __restrict__ B,
                                                float* __restrict__ C) {
  constexpr int NT = N / 4, UNITS = (M / 4) * NT;
  static_assert(M % 4 == 0 && N % 4 == 0 && LDA % 4 == 0 && LDB % 4 == 0 &&
                LDC % 4 == 0, "float4 rows");
  for (int unit = threadIdx.x; unit < UNITS; unit += THREADS) {
    const int mt = unit / NT, nt = unit - mt * NT;
    const float* a = At + 4 * mt;
    const float* b = B + 4 * nt;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 3
    for (int k = 0; k < K; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a + k * LDA);
      const float4 bv = *reinterpret_cast<const float4*>(b + k * LDB);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(C + (4 * mt + r) * LDC + 4 * nt) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
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

// R[(q,m)][(i,c)] = sum_n D1[(q,m)][n] U[n][(i,c)]
template <int DIM>
__device__ __forceinline__ void gradients(const float* d1, const float* d1t,
                                          const float* us, float* rs) {
  using S = ElasticityShape<float, DIM>;
  gemm_cuda_cores<S::kM1, S::kCols, S::kNQ, S::kLD1T, S::kLDX, S::kLDX,
                  S::P::kThreads>(d1t, us, rs);
}

template <int DIM>
__device__ __forceinline__ void gradients(const double* d1, const double*,
                                          const double* us, double* rs) {
  using S = ElasticityShape<double, DIM>;
  gemm_dmma<S::kCols, S::kQMPad, S::kNPad, S::kLDX, 1, S::kLD1, S::kLDX, 4,
            S::P::kThreads>(us, d1, rs);
}

// Y[n][(i,c)] = sum_{(q,m)} D1[(q,m)][n] T[(q,m)][(i,c)]
template <int DIM>
__device__ __forceinline__ void back_products(const float* d1,
                                              const float* rs, float* us) {
  using S = ElasticityShape<float, DIM>;
  gemm_cuda_cores<S::kM2, S::kCols, S::kQM, S::kLD1, S::kLDX, S::kLDX,
                  S::P::kThreads>(d1, rs, us);
}

template <int DIM>
__device__ __forceinline__ void back_products(const double* d1,
                                              const double* rs, double* us) {
  using S = ElasticityShape<double, DIM>;
  gemm_dmma<S::kCols, S::kNPad, S::kQMPad, S::kLDX, S::kLD1, 1, S::kLDX, 4,
            S::P::kThreads>(rs, d1, us);
}

// Pass 1 of the elasticity apply: ye[(n*DIM + i)*E + e] = (K_e u_e)[n, i]
// for every cell e < E.
template <typename T, int DIM>
__global__ void __launch_bounds__(GenericTile<T, DIM>::kThreads,
                                  GenericTile<T, DIM>::kMinBlocks)
generic_elasticity_products_kernel(const T* __restrict__ u,
                                   const int* __restrict__ conn,
                                   const T* __restrict__ dref,
                                   const T* __restrict__ jinv,
                                   const T* __restrict__ jxw,
                                   T* __restrict__ ye, T lam, T mu, int E,
                                   int Eg) {
  using S = ElasticityShape<T, DIM>;
  constexpr int TC = S::P::kCells, NT = S::P::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* d1 = sm + S::kD1;
  T* d1t = sm + S::kD1T;
  T* us = sm + S::kU;
  T* rs = sm + S::kR;
  T* js = sm + S::kJ;
  T* jw = sm + S::kJW;
  const int tid = threadIdx.x;
  const int cell_stride = Eg == 1 ? 0 : 1;   // geometry shared by all cells

  // zeros everywhere once: every padding the products read stays zero
  for (int i = tid; i < S::kTotal; i += NT) sm[i] = T(0);
  __syncthreads();
  for (int i = tid; i < S::kNQ * S::kNQ * DIM; i += NT) {
    const int q = i / (S::kNQ * DIM), rem = i - q * (S::kNQ * DIM);
    const int n = rem / DIM, m = rem - n * DIM;
    const T v = dref[i];
    d1[(q * DIM + m) * S::kLD1 + n] = v;
    if constexpr (S::kF32) d1t[n * S::kLD1T + q * DIM + m] = v;
  }

  for (int tile = blockIdx.x; tile * TC < E; tile += gridDim.x) {
    const int c0 = tile * TC;
    __syncthreads();   // the last tile's Y is out of us
    for (int w = tid; w < S::kNV * TC; w += NT) {
      const int row = w / TC, c = w - row * TC, e = c0 + c;
      const int n = row / DIM, i = row - n * DIM;
      T* dst = us + n * S::kLDX + i * TC + c;
      if (e < E)
        cp_async(dst, u + __ldg(conn + static_cast<long long>(row) * E + e));
      else
        *dst = T(0);
    }
    for (int w = tid; w < S::kJRows * TC; w += NT) {
      const int row = w / TC, e = c0 + w - row * TC;
      if (e < E)
        cp_async(js + w,
                 jinv + static_cast<long long>(row) * Eg + e * cell_stride);
      else
        js[w] = T(0);
    }
    for (int w = tid; w < S::kNQ * TC; w += NT) {
      const int q = w / TC, e = c0 + w - q * TC;
      if (e < E)
        cp_async(jw + w,
                 jxw + static_cast<long long>(q) * Eg + e * cell_stride);
      else
        jw[w] = T(0);
    }
    cp_async_wait_all();
    __syncthreads();
    gradients<DIM>(d1, d1t, us, rs);
    __syncthreads();
    // the pointwise algebra of ops/operators.py::elasticity_core, one
    // (quadrature point, cell) per thread, T written over R
    for (int w = tid; w < S::kNQ * TC; w += NT) {
      const int q = w / TC, c = w - q * TC;
      T jv[DIM][DIM], r[DIM][DIM], h[DIM][DIM], s[DIM][DIM];
#pragma unroll
      for (int m = 0; m < DIM; ++m)
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
          jv[m][j] = js[((q * DIM + m) * DIM + j) * TC + c];
          r[m][j] = rs[(q * DIM + m) * S::kLDX + j * TC + c];   // r[m][i]
        }
      const T wq = jw[q * TC + c];
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
          s[i][j] = (mu * (h[i][j] + h[j][i]) + (i == j ? lam * tr : T(0))) *
                    wq;
#pragma unroll
      for (int m = 0; m < DIM; ++m)
#pragma unroll
        for (int i = 0; i < DIM; ++i) {
          T v = s[i][0] * jv[m][0];
#pragma unroll
          for (int j = 1; j < DIM; ++j) v += s[i][j] * jv[m][j];
          rs[(q * DIM + m) * S::kLDX + i * TC + c] = v;
        }
    }
    __syncthreads();
    back_products<DIM>(d1, rs, us);
    __syncthreads();
    for (int w = tid; w < S::kNV * TC; w += NT) {
      const int row = w / TC, c = w - row * TC, e = c0 + c;
      const int n = row / DIM, i = row - n * DIM;
      if (e < E)
        ye[static_cast<long long>(row) * E + e] =
            us[n * S::kLDX + i * TC + c];
    }
  }
}

// Pass 1 of the Q1 apply: ye[(b*NP + n)*E + e] = (alpha M_e + beta L_e)
// x_b,e [n] for every lane b < lanes and cell e < E (NP = 2^DIM).
template <typename T, int DIM>
__global__ void __launch_bounds__(kQ1Threads)
generic_q1_products_kernel(const T* __restrict__ x,
                           const int* __restrict__ conn,
                           const T* __restrict__ psi,
                           const T* __restrict__ dref,
                           const T* __restrict__ jinv,
                           const T* __restrict__ jxw, T* __restrict__ ye,
                           T alpha, T beta, int lanes, int n_in, int E,
                           int Eg) {
  constexpr int NP = 1 << DIM;         // Q1 nodes = Gauss points
  __shared__ T ps[NP * NP];            // psi[q][n]
  __shared__ T dr[NP * NP * DIM];      // dref[q][n][m]
  for (int i = threadIdx.x; i < NP * NP; i += kQ1Threads) ps[i] = psi[i];
  for (int i = threadIdx.x; i < NP * NP * DIM; i += kQ1Threads)
    dr[i] = dref[i];
  __syncthreads();
  const int e = blockIdx.x * kQ1Threads + threadIdx.x;
  if (e >= E) return;
  const long long ge = Eg == 1 ? 0 : e;
  const bool mass = alpha != T(0), lap = beta != T(0);
  int idx[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n)
    idx[n] = __ldg(conn + static_cast<long long>(n) * E + e);
  for (int b = 0; b < lanes; ++b) {
    const T* xb = x + static_cast<long long>(b) * n_in;
    T pe[NP], ym[NP], yl[NP];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      pe[n] = __ldg(xb + idx[n]);
      ym[n] = T(0);
      yl[n] = T(0);
    }
    // one quadrature point at a time: unrolled, the compiler hoisted the
    // geometry of all of them and ran at 223-255 registers (spilling in
    // float64), too few warps to hide the gather's latency
#pragma unroll 1
    for (int q = 0; q < NP; ++q) {
      const T wq = __ldg(jxw + q * static_cast<long long>(Eg) + ge);
      if (mass) {
        T v = T(0);
#pragma unroll
        for (int n = 0; n < NP; ++n) v += ps[q * NP + n] * pe[n];
        const T w = wq * v;
#pragma unroll
        for (int n = 0; n < NP; ++n) ym[n] += ps[q * NP + n] * w;
      }
      if (lap) {
        T jv[DIM][DIM], r[DIM], g[DIM], t[DIM];
#pragma unroll
        for (int m = 0; m < DIM; ++m)
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            jv[m][d] = __ldg(jinv + ((q * DIM + m) * DIM + d) *
                                        static_cast<long long>(Eg) + ge);
#pragma unroll
        for (int m = 0; m < DIM; ++m) {
          T v = T(0);
#pragma unroll
          for (int n = 0; n < NP; ++n) v += dr[(q * NP + n) * DIM + m] * pe[n];
          r[m] = v;
        }
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          T v = r[0] * jv[0][d];
#pragma unroll
          for (int m = 1; m < DIM; ++m) v += r[m] * jv[m][d];
          g[d] = v * wq;
        }
#pragma unroll
        for (int m = 0; m < DIM; ++m) {
          T v = g[0] * jv[m][0];
#pragma unroll
          for (int d = 1; d < DIM; ++d) v += g[d] * jv[m][d];
          t[m] = v;
        }
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          T v = T(0);
#pragma unroll
          for (int m = 0; m < DIM; ++m) v += dr[(q * NP + n) * DIM + m] * t[m];
          yl[n] += v;
        }
      }
    }
    T* out = ye + static_cast<long long>(b) * NP * E + e;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      out[static_cast<long long>(n) * E] =
          mass && lap ? alpha * ym[n] + beta * yl[n]
                      : (mass ? alpha * ym[n] : beta * yl[n]);
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

// Pass 1 of the elasticity apply with the plan the wrapper passes; refuse
// any other plan.  The tile exceeds the 48 KB a block gets without opting
// in; the attribute is per device, set at a device's first launch.
template <typename T, int DIM>
cudaError_t launch_elasticity_products(const T* u, const int* conn,
                                       const T* dref, const T* jinv,
                                       const T* jxw, T* ye, T lam, T mu,
                                       int E, int Eg, int grid, int smem,
                                       cudaStream_t s) {
  using S = ElasticityShape<T, DIM>;
  const long long tiles = (E + S::P::kCells - 1) / S::P::kCells;
  if (smem != S::kSmemBytes || grid < 1 || grid > tiles)
    return cudaErrorInvalidValue;
  void (*products)(const T*, const int*, const T*, const T*, const T*, T*, T,
                   T, int, int) = generic_elasticity_products_kernel<T, DIM>;
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
  products<<<grid, S::P::kThreads, smem, s>>>(u, conn, dref, jinv, jxw, ye,
                                              lam, mu, E, Eg);
  return cudaGetLastError();
}

// y = K u: u (any length: it is read at conn's indices only), conn
// (DIM*3^DIM, E), dref (3^DIM, 3^DIM, DIM), jinv (3^DIM, DIM, DIM, Eg), jxw
// (3^DIM, Eg), table (n_out, V), y (n_out,), ye the (DIM*3^DIM, E) scratch.
template <typename T>
int launch_generic_elasticity(const void* u, const void* conn,
                              const void* dref, const void* jinv,
                              const void* jxw, const void* table, void* y,
                              void* ye, double lam, double mu, int dim,
                              int E, int Eg, int V, int n_out, int grid,
                              int smem, void* stream) {
  if ((dim != 2 && dim != 3) || E < 0 || (Eg != E && Eg != 1) || V < 1 ||
      n_out < 0 ||
      static_cast<long long>(dim == 3 ? 81 : 18) * E > kIntMax ||
      static_cast<long long>(n_out) * V > kIntMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_values = (dim == 3 ? 81 : 18) * E;
  T* ep = static_cast<T*>(ye);
  if (E > 0) {
    const T* up = static_cast<const T*>(u);
    const int* cp = static_cast<const int*>(conn);
    const T* dp = static_cast<const T*>(dref);
    const T* jp = static_cast<const T*>(jinv);
    const T* wp = static_cast<const T*>(jxw);
    const cudaError_t err =
        dim == 3 ? launch_elasticity_products<T, 3>(
                       up, cp, dp, jp, wp, ep, T(lam), T(mu), E, Eg, grid,
                       smem, s)
                 : launch_elasticity_products<T, 2>(
                       up, cp, dp, jp, wp, ep, T(lam), T(mu), E, Eg, grid,
                       smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_out > 0)
    plan_sum_kernel<T, 1><<<sum_blocks(n_out), kSumThreads, 0, s>>>(
        ep, static_cast<const int*>(table), static_cast<T*>(y), n_out, V,
        n_values, 1);
  return static_cast<int>(cudaGetLastError());
}

// y = alpha M x + beta L x: x (lanes, n_in), conn (2^DIM, E), psi (2^DIM,
// 2^DIM), dref (2^DIM, 2^DIM, DIM), jinv (2^DIM, DIM, DIM, Eg), jxw (2^DIM,
// Eg), table (n_out, V), y (lanes, n_out), ye the (lanes, 2^DIM, E)
// scratch; grid: ceil(E / kQ1Threads) blocks.
template <typename T>
int launch_generic_q1(const void* x, const void* conn, const void* psi,
                      const void* dref, const void* jinv, const void* jxw,
                      const void* table, void* y, void* ye, double alpha,
                      double beta, int dim, int lanes, int n_in, int E,
                      int Eg, int V, int n_out, int grid, void* stream) {
  const long long np = dim == 3 ? 8 : 4;
  if ((dim != 2 && dim != 3) || lanes < 1 || lanes > kMaxLanes || E < 0 ||
      (Eg != E && Eg != 1) || V < 1 || n_out < 0 || n_in < 0 ||
      static_cast<long long>(grid) * kQ1Threads <
          static_cast<long long>(E) ||
      (E > 0 && static_cast<long long>(grid - 1) * kQ1Threads >= E) ||
      lanes * np * E > kIntMax || lanes * static_cast<long long>(n_in) >
      kIntMax || lanes * static_cast<long long>(n_out) > kIntMax ||
      static_cast<long long>(n_out) * V > kIntMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* ep = static_cast<T*>(ye);
  if (E > 0) {
    const T* xp = static_cast<const T*>(x);
    const int* cp = static_cast<const int*>(conn);
    const T* pp = static_cast<const T*>(psi);
    const T* dp = static_cast<const T*>(dref);
    const T* jp = static_cast<const T*>(jinv);
    const T* wp = static_cast<const T*>(jxw);
    if (dim == 3)
      generic_q1_products_kernel<T, 3><<<grid, kQ1Threads, 0, s>>>(
          xp, cp, pp, dp, jp, wp, ep, T(alpha), T(beta), lanes, n_in, E, Eg);
    else
      generic_q1_products_kernel<T, 2><<<grid, kQ1Threads, 0, s>>>(
          xp, cp, pp, dp, jp, wp, ep, T(alpha), T(beta), lanes, n_in, E, Eg);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_out > 0)
    plan_sum_kernel<T, kMaxLanes><<<sum_blocks(n_out), kSumThreads, 0, s>>>(
        ep, static_cast<const int*>(table), static_cast<T*>(y), n_out, V,
        static_cast<int>(np * E), lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: every pointer and the stream are void*,
// every entry point returns cudaGetLastError() after its launches.
extern "C" {

// grid, smem: pass 1's launch plan (ops/generic_apply.py::elasticity_plan)
int generic_elasticity_apply_f32(const void* u, const void* conn,
                                 const void* dref, const void* jinv,
                                 const void* jxw, const void* table, void* y,
                                 void* ye, double lam, double mu, int dim,
                                 int E, int Eg, int V, int n_out, int grid,
                                 int smem, void* stream) {
  return launch_generic_elasticity<float>(u, conn, dref, jinv, jxw, table, y,
                                          ye, lam, mu, dim, E, Eg, V, n_out,
                                          grid, smem, stream);
}

int generic_elasticity_apply_f64(const void* u, const void* conn,
                                 const void* dref, const void* jinv,
                                 const void* jxw, const void* table, void* y,
                                 void* ye, double lam, double mu, int dim,
                                 int E, int Eg, int V, int n_out, int grid,
                                 int smem, void* stream) {
  return launch_generic_elasticity<double>(u, conn, dref, jinv, jxw, table,
                                           y, ye, lam, mu, dim, E, Eg, V,
                                           n_out, grid, smem, stream);
}

int generic_q1_apply_f32(const void* x, const void* conn, const void* psi,
                         const void* dref, const void* jinv, const void* jxw,
                         const void* table, void* y, void* ye, double alpha,
                         double beta, int dim, int lanes, int n_in, int E,
                         int Eg, int V, int n_out, int grid, void* stream) {
  return launch_generic_q1<float>(x, conn, psi, dref, jinv, jxw, table, y, ye,
                                  alpha, beta, dim, lanes, n_in, E, Eg, V,
                                  n_out, grid, stream);
}

int generic_q1_apply_f64(const void* x, const void* conn, const void* psi,
                         const void* dref, const void* jinv, const void* jxw,
                         const void* table, void* y, void* ye, double alpha,
                         double beta, int dim, int lanes, int n_in, int E,
                         int Eg, int V, int n_out, int grid, void* stream) {
  return launch_generic_q1<double>(x, conn, psi, dref, jinv, jxw, table, y,
                                   ye, alpha, beta, dim, lanes, n_in, E, Eg, V,
                                   n_out, grid, stream);
}

}  // extern "C"
