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
// subtracts the excluded pairs); r^2 is clamped at 1e-6.
//
// Binning stays outside the kernel (blues_tpu_torch/potentials/pcells.py,
// torch ops): positions wrapped, a cell id per atom, a stable sort by cell,
// per-cell counts and starts. The kernel reads only real atoms: the TPU
// kernel's (cap x cap) padded tiles become loops over each cell's real count,
// about half the pair slots at the 22k-atom toluene box.
//
// What bounds it: an fp32 ALU/SFU-bound pair kernel (rsqrtf, __expf, the A&S
// erfc of pair_math.cuh, as in the sweep kernel); device memory traffic is a
// few MB per call. Its only locality is the shared-memory staging of each
// neighbour cell; wgmma, TMA and half-shell (Newton) visits are later work.
//
// Design: grid (cell, replica), CELL_THREADS threads, one per row slot of
// the home cell (a loop covers a cell above CELL_THREADS atoms, so every
// atom is written even when the bin overflows; the wrapper then poisons the
// result). For each of the 27 neighbours the block stages that cell's real
// atoms, shifted by their image, into shared memory in tiles of TILE; every
// thread accumulates its row's F and E in registers and writes them once,
// at its atom's index. No float atomics, so the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_math.cuh"

using namespace pair_math;

namespace {

constexpr int CELL_THREADS = 256;
constexpr int TILE = 256;
constexpr int N_NBR = 27;

// per-atom feature slots, shared with pcells.py
constexpr int F_QSTD = 0, F_QALCH = 1, F_SIG = 2, F_EPS = 3, F_ALCH = 4,
              F_INROWS = 5, F_GID = 6;

// params: [lam_s, f_na, f_aa, Lx, Ly, Lz]
__global__ void __launch_bounds__(CELL_THREADS)
    cells_kernel(const float* __restrict__ xw,        // (R, n, 3) wrapped
                 const float* __restrict__ feat,      // (n, 8)
                 const int64_t* __restrict__ order,   // (R, n) ids by cell
                 const int64_t* __restrict__ starts,  // (R, nc)
                 const int64_t* __restrict__ counts,  // (R, nc)
                 const int* __restrict__ table,       // (nc, 27)
                 const float* __restrict__ shifts,    // (nc, 27, 3)
                 const float* __restrict__ params,
                 float* __restrict__ out,  // (R, n, 4): F, E per atom
                 int n, int nc, int mask_rows, PairConsts c) {
  __shared__ float s_x[TILE], s_y[TILE], s_z[TILE];
  __shared__ float s_qs[TILE], s_qa[TILE], s_sig[TILE], s_eps[TILE],
      s_al[TILE], s_in[TILE], s_gid[TILE];

  const int cell = blockIdx.x;
  const int rep = blockIdx.y;
  const float lam_s = params[0], f_na = params[1], f_aa = params[2];
  const float L[3] = {params[3], params[4], params[5]};
  const int64_t* ord = order + (size_t)rep * n;
  const float* xr = xw + (size_t)rep * n * 3;
  const int64_t h0 = starts[(size_t)rep * nc + cell];
  const int hn = (int)counts[(size_t)rep * nc + cell];

  for (int base = 0; base < hn; base += CELL_THREADS) {
    const int slot = base + threadIdx.x;
    const bool live = slot < hn;
    const int64_t id = live ? ord[h0 + slot] : 0;
    const float xi = xr[id * 3 + 0], yi = xr[id * 3 + 1], zi = xr[id * 3 + 2];
    const float* fi = feat + id * 8;
    const float qs_i = fi[F_QSTD], qa_i = fi[F_QALCH], sig_i = fi[F_SIG],
                eps_i = fi[F_EPS], al_i = fi[F_ALCH], in_i = fi[F_INROWS],
                gid_i = fi[F_GID];
    float fx = 0.f, fy = 0.f, fz = 0.f, en = 0.f;

    for (int k = 0; k < N_NBR; ++k) {
      const int nb = table[cell * N_NBR + k];
      if (nb >= nc) continue;  // duplicate wrapped neighbour (tiny grids)
      const float* sh = shifts + ((size_t)cell * N_NBR + k) * 3;
      // unfused, as pcells.py rounds them (see dist2 in pair_math.cuh)
      const float sx = __fmul_rn(sh[0], L[0]), sy = __fmul_rn(sh[1], L[1]),
                  sz = __fmul_rn(sh[2], L[2]);
      const int64_t j0 = starts[(size_t)rep * nc + nb];
      const int jn = (int)counts[(size_t)rep * nc + nb];
      for (int t0 = 0; t0 < jn; t0 += TILE) {
        const int m = min(TILE, jn - t0);
        __syncthreads();  // the previous tile is consumed
        for (int j = threadIdx.x; j < m; j += CELL_THREADS) {
          const int64_t jd = ord[j0 + t0 + j];
          s_x[j] = __fadd_rn(xr[jd * 3 + 0], sx);
          s_y[j] = __fadd_rn(xr[jd * 3 + 1], sy);
          s_z[j] = __fadd_rn(xr[jd * 3 + 2], sz);
          const float* fj = feat + jd * 8;
          s_qs[j] = fj[F_QSTD];
          s_qa[j] = fj[F_QALCH];
          s_sig[j] = fj[F_SIG];
          s_eps[j] = fj[F_EPS];
          s_al[j] = fj[F_ALCH];
          s_in[j] = fj[F_INROWS];
          s_gid[j] = fj[F_GID];
        }
        __syncthreads();
        if (!live) continue;
        for (int j = 0; j < m; ++j) {
          if (s_gid[j] == gid_i) continue;
          const float dx = xi - s_x[j];
          const float dy = yi - s_y[j];
          const float dz = zi - s_z[j];
          float r2 = dist2(dx, dy, dz);
          if (!(r2 < c.cutoff2)) continue;
          r2 = fmaxf(r2, 1e-6f);
          const float aa = al_i * s_al[j];
          const float na = al_i + s_al[j] - 2.0f * aa;
          float e, g;
          pair_ef(r2, 0.5f * (sig_i + s_sig[j]), sqrtf(eps_i * s_eps[j]),
                  qs_i * s_qs[j], qs_i * s_qa[j] + qa_i * s_qs[j],
                  qa_i * s_qa[j], na + c.ann * aa, lam_s, f_na, f_aa, c, e, g);
          const float w = 1.0f - 0.5f * in_i * s_in[j];
          fx -= g * dx;
          fy -= g * dy;
          fz -= g * dz;
          en += w * e;
        }
      }
    }
    if (live) {
      const float keep = mask_rows ? in_i : 1.0f;
      float* o = out + ((size_t)rep * n + id) * 4;
      o[0] = fx * keep;
      o[1] = fy * keep;
      o[2] = fz * keep;
      o[3] = en * keep;
    }
  }
}

}  // namespace

extern "C" {

// returns cudaGetLastError() after the launch
int cells_launch(const float* xw, const float* feat, const int64_t* order,
                 const int64_t* starts, const int64_t* counts,
                 const int* table, const float* shifts, const float* params,
                 float* out, int R, int n, int nc, int mask_rows, int method,
                 float cutoff, float alpha_ewald, float k_rf, float c_rf,
                 float ann, float softcore_alpha, int has_switch,
                 float switch_distance, int alch_coulomb, float ke,
                 void* stream) {
  if (R <= 0 || n <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  const PairConsts c =
      make_consts(method, cutoff, 1, alpha_ewald, k_rf, c_rf, ann,
                  softcore_alpha, 0, has_switch, switch_distance,
                  alch_coulomb, ke);
  cells_kernel<<<dim3(nc, R), CELL_THREADS, 0, (cudaStream_t)stream>>>(
      xw, feat, order, starts, counts, table, shifts, params, out, n, nc,
      mask_rows, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
