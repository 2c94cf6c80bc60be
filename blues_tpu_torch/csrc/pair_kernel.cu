// All-pairs pair sum (softcore LJ + Ewald-erfc / reaction-field) over
// spatial clusters, NVIDIA Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel K2, blues_tpu/potentials/pallas/
// pair_kernel.py (_make_kernel, launched by make_pallas_pair_sum): the
// active rows x all (or a subset of) columns, minimum image when periodic,
// a pair counting when gid_i != gid_j and r^2 < rc^2 (no exclusion mask),
// its energy weighted by 1 - 0.5*in_rows_i*in_rows_j (every row has
// in_rows = 1, so this is the TPU kernel's 1 - 0.5*in_rows_j); row F and E.
//
// The TPU kernel sweeps every (row tile, column tile). Here the wrapper
// (blues_tpu_torch/potentials/pair_kernel.py) orders rows and columns per
// call into compact clusters of 32 (xy columns of the box, z inside) and
// prunes the column clusters of each row cluster by bounding-box distance
// (clusters.py), so a warp visits about 8x the in-cutoff pairs at water
// density instead of 54x. The list holds at most width - 1 entries per row
// cluster (a bound from the box's density, about twice what a row cluster
// keeps at water density); a row cluster that keeps more walks every column
// cluster instead, so the result never depends on the bound. The layout
// itself is built on the card too: pair_key_kernel here, then a torch sort,
// then the shared layout kernel (cluster_layout.cuh). What bounds the pair
// kernel and how the pair math is spent only inside the cutoff:
// cluster_pairs.cuh. The minimum image is
// rint(d * (1/L)) per pair; cluster_pairs.cuh gives the argument that it
// equals the plain version's torch.round(d / L) on every pair it keeps.
//
// Each replica has its own box lengths (NPT): the keys' wrap, the bounding
// boxes, the prune's and the pairs' minimum image read replica rep's; the
// column grid and the list width come from the first box, and a replica's
// row clusters that keep more columns than the list holds walk them all.
//
// Grid (row cluster / WARPS, replica), WARPS warps of 32 threads, one row
// cluster per warp. Blocks are small so the ragged work per row cluster
// balances across SMs; the resident warps per SM are set by the registers
// (__launch_bounds__ asks for 12 blocks, 24 warps) and the 18 KB of shared
// memory per block (12 blocks in 227 KB).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_layout.cuh"
#include "cluster_pairs.cuh"

using namespace cluster_pairs;

namespace {

// K2's sort keys, one block per replica: each laid-out atom's xy column of
// its wrapped position (of the atoms' bounding box when not periodic) and
// its z inside, as (column << SUBKEY_BITS) | z level. The plain version is
// clusters.column_key_plain, rounded alike.
__global__ void __launch_bounds__(cluster_layout::THREADS)
    pair_key_kernel(const float* __restrict__ x,        // (R, n, 3)
                    const int64_t* __restrict__ ids_t,  // (m,)
                    const float* __restrict__ L,        // (R, 3)
                    int64_t* __restrict__ key,          // (R, m)
                    int n, int m, int nx, int ny, int periodic) {
  using cluster_layout::warp_max;
  using cluster_layout::warp_min;
  using cluster_layout::wrap1;
  constexpr int SUB = cluster_layout::SUBKEY_BITS;
  const int rep = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & (CL - 1), w = tid / CL, nw = nt / CL;
  const float* xr = x + (size_t)rep * n * 3;
  const float l[3] = {L[3 * rep + 0], L[3 * rep + 1], L[3 * rep + 2]};
  __shared__ float part[2][3][cluster_layout::THREADS / CL];
  __shared__ float box_lo[3], box_hi[3];
  if (!periodic) {
    float mn[3] = {INFINITY, INFINITY, INFINITY};
    float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int i = tid; i < m; i += nt) {
      const float* p = xr + ids_t[i] * 3;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        mn[d] = fminf(mn[d], p[d]);
        mx[d] = fmaxf(mx[d], p[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float a = warp_min(mn[d]), b = warp_max(mx[d]);
      if (lane == 0) {
        part[0][d][w] = a;
        part[1][d][w] = b;
      }
    }
    __syncthreads();
    if (w == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float a = warp_min(lane < nw ? part[0][d][lane] : INFINITY);
        const float b = warp_max(lane < nw ? part[1][d][lane] : -INFINITY);
        if (lane == 0) {
          box_lo[d] = a;
          box_hi[d] = b;
        }
      }
    }
    __syncthreads();
  }
  const float scale[3] = {(float)nx, (float)ny, (float)(1 << SUB)};
  const float top[3] = {(float)(nx - 1), (float)(ny - 1), (float)((1 << SUB) - 1)};
  for (int i = tid; i < m; i += nt) {
    const float* p = xr + ids_t[i] * 3;
    int q[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float u =
          periodic ? __fdiv_rn(wrap1(p[d], l[d]), l[d])
                   : __fdiv_rn(__fsub_rn(p[d], box_lo[d]),
                               fmaxf(__fsub_rn(box_hi[d], box_lo[d]), 1e-6f));
      q[d] = (int)fminf(fmaxf(__fmul_rn(u, scale[d]), 0.0f), top[d]);
    }
    key[(size_t)rep * m + i] = ((int64_t)(q[0] * ny + q[1]) << SUB) | q[2];
  }
}

template <int kImage>
__global__ void __launch_bounds__(WARPS * CL, MIN_BLOCKS)
    pair_kernel(Args a, PairConsts c) {
  __shared__ WarpStage stage[WARPS];
  row_cluster<kImage>(a, c, stage[threadIdx.x >> 5]);
}

// The prune: one warp per row cluster scans every column cluster, 32 at a
// time, and keeps those whose bounding boxes come within the cutoff (with
// the minimum image of the centres when periodic): the first width - 1 in
// the list, all of them in the count. Its plain version is
// PallasPairSum.prune_plain (potentials/pair_kernel.py).
__global__ void __launch_bounds__(WARPS * CL)
    pair_prune_kernel(const float* __restrict__ ca,     // (R, cr, 3)
                      const float* __restrict__ ha,     // (R, cr, 3)
                      const bool* __restrict__ la,      // (R, cr)
                      const float* __restrict__ cb,     // (R, cc, 3)
                      const float* __restrict__ hb,     // (R, cc, 3)
                      const bool* __restrict__ lb,      // (R, cc)
                      const float* __restrict__ L,      // (R, 3)
                      int* __restrict__ list,           // (R, cr, width)
                      int* __restrict__ count,          // (R, cr)
                      int cr, int cc, int width, int min_image, float thr) {
  const int lane = threadIdx.x & (CL - 1);
  const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int rep = blockIdx.y;
  if (g >= cr) return;
  const size_t ra = (size_t)rep * cr + g;
  int n = 0;
  if (la[ra]) {
    float a[3], h[3], l[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a[d] = ca[ra * 3 + d];
      h[d] = ha[ra * 3 + d];
      l[d] = L[3 * rep + d];
    }
    int* out = list + ra * width;
    for (int c0 = 0; c0 < cc; c0 += CL) {
      const int c = c0 + lane;
      bool keep = false;
      if (c < cc) {
        const size_t rb = (size_t)rep * cc + c;
        if (lb[rb]) {
          float gap[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            float dd = __fsub_rn(a[d], cb[rb * 3 + d]);
            if (min_image)
              dd = __fsub_rn(dd, __fmul_rn(l[d], rintf(__fdiv_rn(dd, l[d]))));
            gap[d] = box_gap1(dd, h[d], hb[rb * 3 + d]);
          }
          keep = sum_sq(gap[0], gap[1], gap[2]) < thr;
        }
      }
      append(keep, c, lane, out, n, width - 1);
    }
  }
  if (lane == 0) count[ra] = n;
}

}  // namespace

extern "C" {

// returns cudaGetLastError() after the launch
int pair_launch(const float* xr, const int64_t* idr, const float* xc,
                const int64_t* idc, const float* feat, const int* list,
                const int* count, const float* params, float* out, int R,
                int n, int cr, int cc, int width, int periodic, int method,
                float cutoff, float alpha_ewald, float k_rf, float c_rf,
                float ann, float softcore_alpha, int has_switch,
                float switch_distance, int alch_coulomb, float ke,
                void* stream) {
  if (R <= 0 || n <= 0 || cr <= 0 || cc <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  const PairConsts c =
      make_consts(method, cutoff, 1, alpha_ewald, k_rf, c_rf, ann,
                  softcore_alpha, periodic, has_switch, switch_distance,
                  alch_coulomb, ke);
  Args a{xr, idr, xc, idc, feat, list, count, nullptr, nullptr, params, out,
         n, cr, cc, width, 0};
  const dim3 grid((cr + WARPS - 1) / WARPS, R);
  cudaStream_t s = (cudaStream_t)stream;
  if (periodic)
    pair_kernel<IMG_MIN><<<grid, WARPS * CL, 0, s>>>(a, c);
  else
    pair_kernel<IMG_NONE><<<grid, WARPS * CL, 0, s>>>(a, c);
  return (int)cudaGetLastError();
}

// returns cudaGetLastError() after the launch
int pair_prune_launch(const float* ca, const float* ha, const bool* la,
                      const float* cb, const float* hb, const bool* lb,
                      const float* L, int* list, int* count, int R, int cr,
                      int cc, int width, int min_image, float thr,
                      void* stream) {
  if (R <= 0 || cr <= 0 || cc <= 0 || width < 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cr + WARPS - 1) / WARPS, R);
  pair_prune_kernel<<<grid, WARPS * CL, 0, (cudaStream_t)stream>>>(
      ca, ha, la, cb, hb, lb, L, list, count, cr, cc, width, min_image, thr);
  return (int)cudaGetLastError();
}

// returns cudaGetLastError() after the launch
int pair_key_launch(const float* x, const int64_t* ids_t, const float* L,
                    int64_t* key, int R, int n, int m, int nx, int ny,
                    int periodic, void* stream) {
  if (R <= 0 || n <= 0 || m <= 0 || nx <= 0 || ny <= 0)
    return (int)cudaErrorInvalidValue;
  pair_key_kernel<<<R, cluster_layout::THREADS, 0, (cudaStream_t)stream>>>(
      x, ids_t, L, key, n, m, nx, ny, periodic);
  return (int)cudaGetLastError();
}

}  // extern "C"

// returns cudaGetLastError() after the launch
CLUSTER_LAYOUT_ENTRY(pair_layout_launch)
