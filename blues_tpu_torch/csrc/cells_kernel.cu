// Cell-list pair sum (softcore LJ + Ewald-erfc / reaction-field) for
// unfrozen orthorhombic periodic systems, NVIDIA Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel K3,
// blues_tpu/potentials/pallas/cells_kernel.py (_make_kernel, launched by
// make_pallas_cells_pair_sum). Same sum: every row atom visits the full
// 27-cell neighbourhood of its home cell (both-sides visit, row-row pairs
// weighted 1 - 0.5*in_rows_i*in_rows_j), positions wrapped into the box and
// each (cell, neighbour) pair carrying a static lattice shift, in box
// lengths, that IS the minimum image (>= 3 cells per dimension). Validity is
// gid_i != gid_j and r^2 < rc^2, with no exclusion mask (the rest term
// subtracts the excluded pairs); r^2 is clamped at 1e-6. With a row subset,
// a row's F and E are multiplied by its in_rows.
//
// Each replica has its own box lengths (NPT): the wrap, the bounding boxes,
// the lattice shifts and the shrunken-box poison read replica rep's; the
// grid, cap and neighbour table are the ones built from the first box.
//
// Before the sum, per call, three kernels of this source and a torch sort
// build the layout (plain versions in blues_tpu_torch/potentials/pcells.py
// and clusters.py): cells_key_kernel bins the wrapped positions into the JAX
// grid and keys them along a snake over each cell's 2 x 2 xy quarters; after
// a stable torch.sort the shared layout kernel (cluster_layout.cuh) packs
// each cell's atoms into clusters of 32, takes their bounding boxes and
// decides the poison (a bin over cap, a shrunken box) from the bin counts;
// the prune kernel gives each cluster the list of clusters of its 27
// neighbour cells, with the neighbour index k of their shift, whose boxes
// come within the cutoff. The wrapper poisons E and every F to NaN; every
// atom is still written once here.
//
// What bounds it and how the pair math is spent only inside the cutoff:
// cluster_pairs.cuh. Grid (cluster / WARPS, replica), one cluster per warp,
// WARPS warps per block: small blocks balance the ragged lists across the
// SMs (the TPU-shaped design had one 256-thread block per cell, with 30 % of
// its lanes idle); registers (__launch_bounds__ asks for 12 blocks, 24
// warps) and 18 KB of shared memory per block set the resident warps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_layout.cuh"
#include "cluster_pairs.cuh"

using namespace cluster_pairs;

namespace {

// K3's sort keys, one thread per atom: (cell << SUBKEY_BITS) | snake key,
// the cell of the wrapped position in the (nc0, nc1, nc2) grid (clipped as
// the JAX code clips it) and the in-cell snake of pcells.snake_key. The
// plain version is CellsPairSum.key_plain, rounded alike.
__global__ void cells_key_kernel(const float* __restrict__ x,  // (R*n, 3)
                                 const float* __restrict__ L,  // (R, 3)
                                 int64_t* __restrict__ key,    // (R*n,)
                                 int total, int n, int nc0, int nc1, int nc2) {
  constexpr int SUB = cluster_layout::SUBKEY_BITS;
  constexpr int ZL = 1 << (SUB - 2);  // z levels of the snake
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* Lr = L + 3 * (i / n);  // this atom's replica's box
  const int nc[3] = {nc0, nc1, nc2};
  long long ci[3];
  float f[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float l = Lr[d];
    const float g = __fmul_rn(__fdiv_rn(cluster_layout::wrap1(x[(size_t)i * 3 + d], l), l),
                              (float)nc[d]);
    ci[d] = min(max((long long)floorf(g), 0LL), (long long)(nc[d] - 1));
    f[d] = __fsub_rn(g, (float)ci[d]);
  }
  const long long cid = (ci[0] * nc1 + ci[1]) * nc2 + ci[2];
  const int qy = f[1] >= 0.5f;
  const int quarter = f[0] >= 0.5f ? 3 - qy : qy;
  const int z = (int)fminf(fmaxf(__fmul_rn(f[2], (float)ZL), 0.0f), (float)(ZL - 1));
  key[i] = (cid << SUB) | (quarter * ZL + ((quarter & 1) ? ZL - 1 - z : z));
}

__global__ void __launch_bounds__(WARPS * CL, MIN_BLOCKS)
    cells_kernel(Args a, PairConsts c) {
  __shared__ WarpStage stage[WARPS];
  row_cluster<IMG_SHIFT>(a, c, stage[threadIdx.x >> 5]);
}

// The prune: one warp per cluster scans its candidates, the first q_max
// clusters of each of its 27 neighbour cells (candidate t = k * q_max + q),
// 32 at a time, and keeps those whose bounding boxes, the neighbour's moved
// by its static shift, come within the cutoff. Entries are cluster * 32 + k.
// Its plain version is CellsPairSum.prune_plain (potentials/pcells.py).
__global__ void __launch_bounds__(WARPS * CL)
    cells_prune_kernel(const float* __restrict__ centre,   // (R, C, 3)
                       const float* __restrict__ half,     // (R, C, 3)
                       const bool* __restrict__ live,      // (R, C)
                       const int64_t* __restrict__ cl_cell,  // (R, C)
                       const int64_t* __restrict__ ncl,    // (R, nc + 1)
                       const int64_t* __restrict__ start,  // (R, nc + 1)
                       const int64_t* __restrict__ table,  // (nc + 1, 27)
                       const float* __restrict__ shifts,   // (nc + 1, 27, 3)
                       const float* __restrict__ L,        // (R, 3)
                       int* __restrict__ list,             // (R, C, width)
                       int* __restrict__ count,            // (R, C)
                       int C, int nc, int q_max, int width, float thr) {
  const int lane = threadIdx.x & (CL - 1);
  const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int rep = blockIdx.y;
  if (g >= C) return;
  const size_t ra = (size_t)rep * C + g;
  int n = 0;
  if (live[ra]) {
    const int cell = (int)cl_cell[ra];
    float a[3], h[3], l[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a[d] = centre[ra * 3 + d];
      h[d] = half[ra * 3 + d];
      l[d] = L[3 * rep + d];
    }
    const int64_t* ncl_r = ncl + (size_t)rep * (nc + 1);
    const int64_t* start_r = start + (size_t)rep * (nc + 1);
    int* out = list + ra * width;
    const int n_cand = N_NBR * q_max;
    for (int t0 = 0; t0 < n_cand; t0 += CL) {
      const int t = t0 + lane;
      bool keep = false;
      int value = 0;
      if (t < n_cand) {
        const int k = t / q_max, q = t - k * q_max;
        const int nb = (int)table[cell * N_NBR + k];
        if (q < ncl_r[nb]) {
          const int cand = (int)start_r[nb] + q;
          const size_t rb = (size_t)rep * C + cand;
          const float* sh = shifts + ((size_t)cell * N_NBR + k) * 3;
          float gap[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float cbd = __fadd_rn(centre[rb * 3 + d], __fmul_rn(sh[d], l[d]));
            gap[d] = box_gap1(__fsub_rn(a[d], cbd), h[d], half[rb * 3 + d]);
          }
          keep = sum_sq(gap[0], gap[1], gap[2]) < thr;
          value = cand * CL + k;
        }
      }
      append(keep, value, lane, out, n, width - 1);
    }
  }
  if (lane == 0) count[ra] = n;
}

}  // namespace

extern "C" {

// returns cudaGetLastError() after the launch
int cells_launch(const float* xs, const int64_t* ids, const float* feat,
                 const int* list, const int* count, const int64_t* cl_cell,
                 const float* shifts, const float* params, float* out, int R,
                 int n, int n_clusters, int width, int mask_rows, int method,
                 float cutoff, float alpha_ewald, float k_rf, float c_rf,
                 float ann, float softcore_alpha, int has_switch,
                 float switch_distance, int alch_coulomb, float ke,
                 void* stream) {
  if (R <= 0 || n <= 0 || n_clusters <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  const PairConsts c =
      make_consts(method, cutoff, 1, alpha_ewald, k_rf, c_rf, ann,
                  softcore_alpha, 0, has_switch, switch_distance,
                  alch_coulomb, ke);
  Args a{xs,      ids,    xs,     ids, feat,       list,       count,
         cl_cell, shifts, params, out, n,          n_clusters, n_clusters,
         width,   mask_rows};
  const dim3 grid((n_clusters + WARPS - 1) / WARPS, R);
  cells_kernel<<<grid, WARPS * CL, 0, (cudaStream_t)stream>>>(a, c);
  return (int)cudaGetLastError();
}

// returns cudaGetLastError() after the launch
int cells_prune_launch(const float* centre, const float* half,
                       const bool* live, const int64_t* cl_cell,
                       const int64_t* ncl, const int64_t* start,
                       const int64_t* table, const float* shifts,
                       const float* L, int* list, int* count, int R, int C,
                       int nc, int q_max, int width, float thr,
                       void* stream) {
  if (R <= 0 || C <= 0 || nc <= 0 || q_max <= 0 || width < N_NBR * q_max + 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + WARPS - 1) / WARPS, R);
  cells_prune_kernel<<<grid, WARPS * CL, 0, (cudaStream_t)stream>>>(
      centre, half, live, cl_cell, ncl, start, table, shifts, L, list, count,
      C, nc, q_max, width, thr);
  return (int)cudaGetLastError();
}

// returns cudaGetLastError() after the launch
int cells_key_launch(const float* x, const float* L, int64_t* key, int R,
                     int n, int nc0, int nc1, int nc2, void* stream) {
  if (R <= 0 || n <= 0 || nc0 <= 0 || nc1 <= 0 || nc2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int total = R * n, threads = 256;
  cells_key_kernel<<<(total + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(x, L, key, total, n, nc0, nc1,
                                             nc2);
  return (int)cudaGetLastError();
}

}  // extern "C"

// returns cudaGetLastError() after the launch
CLUSTER_LAYOUT_ENTRY(cells_layout_launch)
