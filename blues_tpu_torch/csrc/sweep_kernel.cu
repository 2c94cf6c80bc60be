// Row x column pair sweep (softcore LJ + Ewald-erfc / reaction-field /
// plain Coulomb) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel K1, blues_tpu/potentials/pallas/
// sweep_kernel.py (_make_kernel, launched by make_sweep_pair_sum): the
// culled frozen sweep, on the host-built layout of
// blues_tpu_torch/potentials/sweep.py: rows are packed in blocks of up to 32
// row slots, and each block reads the range [col_range[2b], col_range[2b +
// 1]) of the column storage. Blocks of one Morton group with an exclusion
// mask own private ranges (the exclusion bits are per row slot); unmasked
// blocks of one group share one range. (K2, the all-pairs sum, has its own
// kernel: pair_kernel.cu.)
//
// What bounds it: this is an fp32 pair kernel whose work per pair is SFU and
// ALU arithmetic (one rsqrtf, one __expf, one reciprocal, ~60 FMAs); device
// memory traffic is only the row/column coordinates and features, a few MB
// per call. At small replica counts the grid is (blocks x replicas), a few
// hundred CTAs, so occupancy bounds it too. wgmma, TMA and splitting a
// block's columns over several SMs are later work.
//
// Design:
//   * sweep_rows_kernel (MAIN and E0 instances): grid (row block,
//     replica), 256 threads. Each of the 8 warps owns 4 row slots; the block
//     streams its real column range through shared memory in tiles of 256
//     columns (no padding tiles), lanes stride over the tile, and each row's
//     F and E are summed with warp shuffles and written once. No float
//     atomics, so the result is deterministic.
//   * sweep_cols_kernel (EA instance, <= 128 alchemical rows with column
//     reaction forces): one thread per column loops over the rows held in
//     shared memory and writes its column force directly; per-warp row
//     partials go to scratch and sweep_reduce_kernel sums them in a fixed
//     order.
//
// Numerics: see pair_math.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_math.cuh"

using namespace pair_math;

namespace {

constexpr int ROWS_PER_BLOCK = 32;
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_PER_WARP = ROWS_PER_BLOCK / (ROWS_THREADS / 32);
constexpr int COL_TILE = 256;
constexpr int COLS_THREADS = 128;
constexpr int MAX_EA_ROWS = 128;

// feature slots, shared with sweep.py (ROW_FEATURES / COL_FEATURES)
constexpr int F_QSTD = 0, F_QALCH = 1, F_SIG = 2, F_EPS = 3, F_ALCH = 4,
              F_INROWS = 5, F_GID = 6, F_VALID = 7;

// params: [lam_s, f_na, f_aa, Lx, Ly, Lz]
__global__ void __launch_bounds__(ROWS_THREADS)
    sweep_rows_kernel(const float* __restrict__ xr,     // (R, n_slots, 3)
                      const float* __restrict__ xc,     // (R, S, 3)
                      const float* __restrict__ rfeat,  // (n_slots, 8)
                      const float* __restrict__ cfeat,  // (S, 8)
                      const int* __restrict__ col_range,  // (G, 2)
                      const uint32_t* __restrict__ excl,  // (S,) or null
                      const float* __restrict__ params,
                      float* __restrict__ out,  // (R, n_slots, 4)
                      int n_slots, int S, PairConsts c) {
  __shared__ float s_x[COL_TILE], s_y[COL_TILE], s_z[COL_TILE];
  __shared__ float s_qs[COL_TILE], s_qa[COL_TILE], s_sig[COL_TILE],
      s_eps[COL_TILE], s_al[COL_TILE], s_in[COL_TILE], s_gid[COL_TILE];
  __shared__ uint32_t s_ex[COL_TILE];

  const int g = blockIdx.x;
  const int rep = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float lam_s = params[0], f_na = params[1], f_aa = params[2];
  const float Lx = params[3], Ly = params[4], Lz = params[5];

  const int c0 = col_range[2 * g];
  const int c1 = col_range[2 * g + 1];

  float rx[ROWS_PER_WARP], ry[ROWS_PER_WARP], rz[ROWS_PER_WARP];
  float rqs[ROWS_PER_WARP], rqa[ROWS_PER_WARP], rsig[ROWS_PER_WARP],
      reps[ROWS_PER_WARP], ral[ROWS_PER_WARP], rin[ROWS_PER_WARP],
      rgid[ROWS_PER_WARP];
  bool rvalid[ROWS_PER_WARP];
  float acc[ROWS_PER_WARP][4];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int slot_local = warp * ROWS_PER_WARP + k;
    const int slot = g * ROWS_PER_BLOCK + slot_local;
    const float* p = xr + ((size_t)rep * n_slots + slot) * 3;
    rx[k] = p[0];
    ry[k] = p[1];
    rz[k] = p[2];
    const float* f = rfeat + (size_t)slot * 8;
    rqs[k] = f[F_QSTD];
    rqa[k] = f[F_QALCH];
    rsig[k] = f[F_SIG];
    reps[k] = f[F_EPS];
    ral[k] = f[F_ALCH];
    rin[k] = f[F_INROWS];
    rgid[k] = f[F_GID];
    rvalid[k] = f[F_VALID] > 0.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
  }

  for (int t0 = c0; t0 < c1; t0 += COL_TILE) {
    const int n = min(COL_TILE, c1 - t0);
    for (int j = threadIdx.x; j < n; j += ROWS_THREADS) {
      const int p = t0 + j;
      const float* xp = xc + ((size_t)rep * S + p) * 3;
      s_x[j] = xp[0];
      s_y[j] = xp[1];
      s_z[j] = xp[2];
      const float* f = cfeat + (size_t)p * 8;
      s_qs[j] = f[F_QSTD];
      s_qa[j] = f[F_QALCH];
      s_sig[j] = f[F_SIG];
      s_eps[j] = f[F_EPS];
      s_al[j] = f[F_ALCH];
      s_in[j] = f[F_INROWS];
      s_gid[j] = f[F_GID];
      s_ex[j] = excl ? excl[p] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      if (!rvalid[k]) continue;
      const uint32_t bit = 1u << (warp * ROWS_PER_WARP + k);
      for (int j = lane; j < n; j += 32) {
        if (s_gid[j] == rgid[k] || (s_ex[j] & bit)) continue;
        const float dx = wrap1(rx[k] - s_x[j], Lx, c.wrap);
        const float dy = wrap1(ry[k] - s_y[j], Ly, c.wrap);
        const float dz = wrap1(rz[k] - s_z[j], Lz, c.wrap);
        float r2 = dist2(dx, dy, dz);
        if (c.use_cutoff && !(r2 < c.cutoff2)) continue;
        r2 = fmaxf(r2, 1e-6f);
        const float aa = ral[k] * s_al[j];
        const float na = ral[k] + s_al[j] - 2.0f * aa;
        float e, gg;
        pair_ef(r2, 0.5f * (rsig[k] + s_sig[j]), sqrtf(reps[k] * s_eps[j]),
                rqs[k] * s_qs[j], rqs[k] * s_qa[j] + rqa[k] * s_qs[j],
                rqa[k] * s_qa[j], na + c.ann * aa, lam_s, f_na, f_aa, c, e, gg);
        const float w = 1.0f - 0.5f * rin[k] * s_in[j];
        acc[k][0] -= gg * dx;
        acc[k][1] -= gg * dy;
        acc[k][2] -= gg * dz;
        acc[k][3] += w * e;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const float fx = warp_sum(acc[k][0]);
    const float fy = warp_sum(acc[k][1]);
    const float fz = warp_sum(acc[k][2]);
    const float e = warp_sum(acc[k][3]);
    if (lane == 0) {
      const int slot = g * ROWS_PER_BLOCK + warp * ROWS_PER_WARP + k;
      float* o = out + ((size_t)rep * n_slots + slot) * 4;
      o[0] = fx;
      o[1] = fy;
      o[2] = fz;
      o[3] = e;
    }
  }
}

// EA instance: one thread per column, rows (<= 128) in shared memory.
__global__ void __launch_bounds__(COLS_THREADS)
    sweep_cols_kernel(const float* __restrict__ xr,     // (R, nr, 3)
                      const float* __restrict__ xc,     // (R, S, 3)
                      const float* __restrict__ rfeat,  // (nr, 8)
                      const float* __restrict__ cfeat,  // (S, 8)
                      const uint32_t* __restrict__ excl,  // (S, W) or null
                      const float* __restrict__ params,
                      float* __restrict__ outc,     // (R, S, 4)
                      float* __restrict__ partial,  // (R, n_parts, nr, 4)
                      int nr, int S, int W, PairConsts c) {
  __shared__ float s_rx[MAX_EA_ROWS], s_ry[MAX_EA_ROWS], s_rz[MAX_EA_ROWS];
  __shared__ float s_f[MAX_EA_ROWS][8];

  const int rep = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * COLS_THREADS + threadIdx.x;
  const int n_parts = gridDim.x * (COLS_THREADS / 32);
  const int part = blockIdx.x * (COLS_THREADS / 32) + warp;
  const float lam_s = params[0], f_na = params[1], f_aa = params[2];
  const float Lx = params[3], Ly = params[4], Lz = params[5];

  for (int r = threadIdx.x; r < nr; r += COLS_THREADS) {
    const float* p = xr + ((size_t)rep * nr + r) * 3;
    s_rx[r] = p[0];
    s_ry[r] = p[1];
    s_rz[r] = p[2];
#pragma unroll
    for (int k = 0; k < 8; ++k) s_f[r][k] = rfeat[(size_t)r * 8 + k];
  }
  __syncthreads();

  const bool live = j < S;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  float cqs = 0.f, cqa = 0.f, csig = 0.f, ceps = 0.f, cal = 0.f, cin = 0.f,
        cgid = -1.f;
  if (live) {
    const float* xp = xc + ((size_t)rep * S + j) * 3;
    cx = xp[0];
    cy = xp[1];
    cz = xp[2];
    const float* f = cfeat + (size_t)j * 8;
    cqs = f[F_QSTD];
    cqa = f[F_QALCH];
    csig = f[F_SIG];
    ceps = f[F_EPS];
    cal = f[F_ALCH];
    cin = f[F_INROWS];
    cgid = f[F_GID];
  }
  float fcx = 0.f, fcy = 0.f, fcz = 0.f;
  uint32_t word = 0u;
  for (int r = 0; r < nr; ++r) {
    if ((r & 31) == 0) word = (live && excl) ? excl[(size_t)j * W + (r >> 5)] : 0u;
    float px = 0.f, py = 0.f, pz = 0.f, pe = 0.f;
    const bool ok = live && s_f[r][F_VALID] > 0.0f && s_f[r][F_GID] != cgid &&
                    !(word & (1u << (r & 31)));
    if (ok) {
      const float dx = wrap1(s_rx[r] - cx, Lx, c.wrap);
      const float dy = wrap1(s_ry[r] - cy, Ly, c.wrap);
      const float dz = wrap1(s_rz[r] - cz, Lz, c.wrap);
      float r2 = dist2(dx, dy, dz);
      if (!c.use_cutoff || r2 < c.cutoff2) {
        r2 = fmaxf(r2, 1e-6f);
        const float ai = s_f[r][F_ALCH];
        const float aa = ai * cal;
        const float na = ai + cal - 2.0f * aa;
        const float qsi = s_f[r][F_QSTD], qai = s_f[r][F_QALCH];
        float e, gg;
        pair_ef(r2, 0.5f * (s_f[r][F_SIG] + csig), sqrtf(s_f[r][F_EPS] * ceps),
                qsi * cqs, qsi * cqa + qai * cqs, qai * cqa, na + c.ann * aa,
                lam_s, f_na, f_aa, c, e, gg);
        const float w = 1.0f - 0.5f * s_f[r][F_INROWS] * cin;
        px = -gg * dx;
        py = -gg * dy;
        pz = -gg * dz;
        pe = w * e;
        fcx += gg * dx;
        fcy += gg * dy;
        fcz += gg * dz;
      }
    }
    px = warp_sum(px);
    py = warp_sum(py);
    pz = warp_sum(pz);
    pe = warp_sum(pe);
    if (lane == 0) {
      float* o = partial + (((size_t)rep * n_parts + part) * nr + r) * 4;
      o[0] = px;
      o[1] = py;
      o[2] = pz;
      o[3] = pe;
    }
  }
  if (live) {
    float* o = outc + ((size_t)rep * S + j) * 4;
    o[0] = fcx;
    o[1] = fcy;
    o[2] = fcz;
    o[3] = 0.0f;
  }
}

// sums the EA row partials over the column parts, in a fixed order
__global__ void sweep_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out,  // (R, nr, 4)
                                    int nr, int n_parts) {
  const int rep = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (row, component)
  if (i >= nr * 4) return;
  const int r = i >> 2, k = i & 3;
  float s = 0.0f;
  for (int p = 0; p < n_parts; ++p)
    s += partial[(((size_t)rep * n_parts + p) * nr + r) * 4 + k];
  out[((size_t)rep * nr + r) * 4 + k] = s;
}

}  // namespace

extern "C" {

// MAIN / E0: returns cudaGetLastError() after the launch
int sweep_rows_launch(const float* xr, const float* xc, const float* rfeat,
                      const float* cfeat, const int* col_range,
                      const uint32_t* excl, const float* params, float* out,
                      int R, int G, int S, int method, float cutoff,
                      int use_cutoff, float alpha_ewald, float k_rf, float c_rf,
                      float ann, float softcore_alpha, int wrap, int has_switch,
                      float switch_distance, int alch_coulomb, float ke,
                      void* stream) {
  const PairConsts c =
      make_consts(method, cutoff, use_cutoff, alpha_ewald, k_rf, c_rf, ann,
                  softcore_alpha, wrap, has_switch, switch_distance,
                  alch_coulomb, ke);
  dim3 grid(G, R);
  sweep_rows_kernel<<<grid, ROWS_THREADS, 0, (cudaStream_t)stream>>>(
      xr, xc, rfeat, cfeat, col_range, excl, params, out, G * ROWS_PER_BLOCK,
      S, c);
  return (int)cudaGetLastError();
}

int sweep_cols_n_parts(int S) {
  return ((S + COLS_THREADS - 1) / COLS_THREADS) * (COLS_THREADS / 32);
}

// EA: column forces to outc, row F/E to out; partial is scratch of
// (R, sweep_cols_n_parts(S), nr, 4) floats
int sweep_cols_launch(const float* xr, const float* xc, const float* rfeat,
                      const float* cfeat, const uint32_t* excl, int W,
                      const float* params, float* out, float* outc,
                      float* partial, int R, int nr, int S, int method,
                      float cutoff, int use_cutoff, float alpha_ewald,
                      float k_rf, float c_rf, float ann, float softcore_alpha,
                      int wrap, int has_switch, float switch_distance,
                      int alch_coulomb, float ke, void* stream) {
  if (nr > MAX_EA_ROWS || S <= 0) return (int)cudaErrorInvalidValue;
  const PairConsts c =
      make_consts(method, cutoff, use_cutoff, alpha_ewald, k_rf, c_rf, ann,
                  softcore_alpha, wrap, has_switch, switch_distance,
                  alch_coulomb, ke);
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = (S + COLS_THREADS - 1) / COLS_THREADS;
  sweep_cols_kernel<<<dim3(n_blocks, R), COLS_THREADS, 0, st>>>(
      xr, xc, rfeat, cfeat, excl, params, outc, partial, nr, S, W, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_parts = n_blocks * (COLS_THREADS / 32);
  const int threads = 128;
  sweep_reduce_kernel<<<dim3((nr * 4 + threads - 1) / threads, R), threads, 0,
                        st>>>(partial, out, nr, n_parts);
  return (int)cudaGetLastError();
}

}  // extern "C"
