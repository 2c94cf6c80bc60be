// One warp sums a row cluster (32 row slots, one per lane) against a list of
// column clusters (32 column slots each): the inner routine of the pair
// kernels K2 (pair_kernel.cu) and K3 (cells_kernel.cu), NVIDIA Hopper,
// sm_90a. Its round over staged columns (staged_pairs) also serves K1's
// rows kernel (sweep_kernel.cu), which stages its own static columns.
//
// The layout comes from blues_tpu_torch/potentials/clusters.py (torch ops,
// per call): compact clusters of 32 atoms and, per row cluster, the packed
// list of column clusters whose bounding boxes come within the cutoff. The
// plain PyTorch versions walk the same list, pair for pair.
//
// What bounds it: fp32 ALU and SFU work. A pair inside the cutoff costs about
// 90 fp32 operations in pair_ef (pair_math.cuh), four of them on the SFU
// (rsqrt, exp, two reciprocals); a visited slot outside it costs the
// distance test, 10-25 operations. Device memory traffic is a few MB per
// call. So the design spends the pair math only where it is needed:
//
//   * a round stages STAGE column clusters (positions, ids, features; for
//     K3 already shifted by their image) in the warp's shared memory;
//   * distance phase: each lane tests its row against the 32*STAGE staged
//     columns (cheap) and appends the index of each column inside the
//     cutoff to a lane-private list in shared memory;
//   * math phase: a warp-uniform loop to the longest lane list runs pair_ef
//     only on listed pairs. Pooling STAGE clusters per round evens out the
//     lanes' counts, so the warps run nearly full.
//
// Each lane sums its row's F and E in registers, in list order, and writes
// them once: no float atomics, so the result is deterministic. Rows and
// columns round the image shift and r^2 unfused (__fmul_rn / __fadd_rn) as
// PyTorch does, so a pair within a rounding of the cutoff is in or out on
// both sides alike.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_math.cuh"

namespace cluster_pairs {

using namespace pair_math;

constexpr int CL = 32;          // atoms per cluster = lanes per warp
constexpr int STAGE = 4;        // column clusters staged per round
constexpr int WARPS = 2;        // row clusters (warps) per block
constexpr int MIN_BLOCKS = 12;  // resident blocks asked of ptxas
constexpr int UNROLL = 4;       // unrolling of the distance loop
constexpr int N_NBR = 27;       // K3: neighbour cells per home cell

// How a pair's displacement gets its image.
constexpr int IMG_NONE = 0;   // K2, non-periodic
constexpr int IMG_MIN = 1;    // K2, periodic: per-pair minimum image
constexpr int IMG_SHIFT = 2;  // K3: the entry's static shift, at staging
constexpr int IMG_DIV = 3;    // K1, periodic: d - L rint(d / L), the IEEE
                              // division of the plain version, for any box

// per-atom feature slots, shared with clusters.py
constexpr int F_QSTD = 0, F_QALCH = 1, F_SIG = 2, F_EPS = 3, F_ALCH = 4,
              F_INROWS = 5;

struct Args {
  const float* xr;         // (R, cr * 32, 3) row slot positions
  const int64_t* idr;      // (R, cr * 32) row slot atom ids, -1 when empty
  const float* xc;         // (R, cc * 32, 3) column slot positions
  const int64_t* idc;      // (R, cc * 32)
  const float* feat;       // (n, 8) per-atom features
  const int* list;         // (R, cr, width) packed entries per row cluster
  const int* count;        // (R, cr) entries kept; above width - 1 the list
                           // overflowed (K2), and every column cluster is
                           // walked
  const int64_t* cl_cell;  // K3: (R, cr) home cell of each row cluster
  const float* shifts;     // K3: (nc + 1, 27, 3) image shifts, box lengths
  const float* params;     // lam_s, f_na, f_aa, then Lx, Ly, Lz of each
                           // replica: (3 + 3R,)
  float* out;              // (R, n, 4): F, E per atom
  int n, cr, cc, width, mask_rows;
};

// a warp's staged columns of one round (at most 256: the lists hold bytes)
template <int kCols>
struct Stage {
  float4 pos[kCols];  // x, y, z and the atom id's bits
  float4 q[kCols];    // q_std, q_alch, sigma, epsilon
  float2 ai[kCols];   // alch, in_rows
  uint8_t idx[kCols][CL];  // lane-private lists: idx[t][lane]
};
using WarpStage = Stage<STAGE * CL>;  // K2, K3

// --- the prune kernels' pieces (pair_kernel.cu, cells_kernel.cu) ---------
//
// The plain version of a prune is clusters.py's torch code (box_gap2 and
// compact); these round op for op as it does (no fused multiply-adds), so
// both keep exactly the same entries, in the same order.

// max(|d| - ha - hb, 0) of one dimension
__device__ __forceinline__ float box_gap1(float d, float ha, float hb) {
  return fmaxf(__fsub_rn(__fsub_rn(fabsf(d), ha), hb), 0.0f);
}

__device__ __forceinline__ float sum_sq(float g0, float g1, float g2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(g0, g0), __fmul_rn(g1, g1)),
                   __fmul_rn(g2, g2));
}

// Appends the lanes' kept values to out[n ...] in lane order (a warp ballot
// and prefix count), so the list keeps the candidates' order. Entries past
// ``limit`` are counted but not stored: the list overflowed.
__device__ __forceinline__ void append(bool keep, int value, int lane,
                                       int* out, int& n, int limit) {
  const unsigned b = __ballot_sync(0xffffffffu, keep);
  const int pos = n + __popc(b & ((1u << lane) - 1u));
  if (keep && pos < limit) out[pos] = value;
  n += __popc(b);
}

// K2's minimum image multiplies by 1/L where PyTorch divides by L
// (torch.round(d / L) in the plain version). For a pair that the plain
// version puts inside the cutoff, |d - L k| < rc < L/2 - margin, so d / L
// lies at least margin / L from every half-integer; d * (1/L) differs from
// d / L by at most 2 ulp of a number below a few units, far less than that,
// so rintf picks the same k and dx = d - L k is bit-identical. The two
// roundings can differ only where d / L is within a few ulp of a
// half-integer, where both images lie about L/2 > rc + margin away (the
// wrapper refuses boxes with L <= 2 (rc + margin)): the pair is out on both
// sides.
template <int kImage>
__device__ __forceinline__ void displacement(float xi, float yi, float zi,
                                             const float4& p, const float* L,
                                             const float* iL, float& dx,
                                             float& dy, float& dz) {
  dx = xi - p.x;
  dy = yi - p.y;
  dz = zi - p.z;
  if (kImage == IMG_MIN) {
    dx = __fsub_rn(dx, __fmul_rn(L[0], rintf(__fmul_rn(dx, iL[0]))));
    dy = __fsub_rn(dy, __fmul_rn(L[1], rintf(__fmul_rn(dy, iL[1]))));
    dz = __fsub_rn(dz, __fmul_rn(L[2], rintf(__fmul_rn(dz, iL[2]))));
  }
  if (kImage == IMG_DIV) {
    dx = wrap1(dx, L[0], 1);
    dy = wrap1(dy, L[1], 1);
    dz = wrap1(dz, L[2], 1);
  }
}

// a lane's row atom
struct Row {
  float x, y, z, qs, qa, sig, eps, al, in;
  int id;  // atom id; negative: an empty slot, which lists nothing
};

// One round over the m (a multiple of UNROLL) staged columns of ``s``: the
// distance phase, then the math phase, adding the row's F and E to fx, fy,
// fz, en. Shared by K2 and K3 (row_cluster below) and K1's rows kernel
// (sweep_kernel.cu), whose instances (kSweep) also drop the pairs of the
// lane's exclusion ``bit`` in the staged words ``ex`` and honour
// c.use_cutoff (K2 and K3 always cut).
template <int kImage, bool kSweep, int kCols>
__device__ __forceinline__ void staged_pairs(
    const Row& r, int m, Stage<kCols>& s, const uint32_t* ex, uint32_t bit,
    const float* L, const float* iL, float lam_s, float f_na, float f_aa,
    const PairConsts& c, float& fx, float& fy, float& fz, float& en) {
  const int lane = threadIdx.x & (CL - 1);

  // distance phase: this lane's columns inside the cutoff, in order
  int n_i = 0;
  if (r.id >= 0) {
    for (int j0 = 0; j0 < m; j0 += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u;
        const float4 p = s.pos[j];
        float dx, dy, dz;
        displacement<kImage>(r.x, r.y, r.z, p, L, iL, dx, dy, dz);
        const int id_j = __float_as_int(p.w);
        bool in = dist2(dx, dy, dz) < c.cutoff2;
        if (kSweep) in = (in || !c.use_cutoff) && !(ex[j] & bit);
        in = in && id_j >= 0 && id_j != r.id;
        s.idx[n_i][lane] = (uint8_t)j;  // kept only when n_i moves on
        n_i += in;
      }
    }
  }

  // math phase: pair_ef on the listed pairs only
  const int n_max = __reduce_max_sync(0xffffffffu, n_i);
  for (int t = 0; t < n_max; ++t) {
    if (t < n_i) {
      const int j = s.idx[t][lane];
      const float4 p = s.pos[j];
      float dx, dy, dz;
      displacement<kImage>(r.x, r.y, r.z, p, L, iL, dx, dy, dz);
      const float r2 = fmaxf(dist2(dx, dy, dz), 1e-6f);
      const float4 q = s.q[j];
      const float2 ai = s.ai[j];
      const float qs_j = q.x, qa_j = q.y, sig_j = q.z, eps_j = q.w,
                  al_j = ai.x, in_j = ai.y;
      const float aa = r.al * al_j;
      const float na = r.al + al_j - 2.0f * aa;
      float e, gg;
      pair_ef(r2, 0.5f * (r.sig + sig_j), sqrtf(r.eps * eps_j), r.qs * qs_j,
              r.qs * qa_j + r.qa * qs_j, r.qa * qa_j, na + c.ann * aa, lam_s,
              f_na, f_aa, c, e, gg);
      const float w = 1.0f - 0.5f * r.in * in_j;
      fx -= gg * dx;
      fy -= gg * dy;
      fz -= gg * dz;
      en += w * e;
    }
  }
}

template <int kImage>
__device__ __forceinline__ void row_cluster(const Args& a, const PairConsts& c,
                                            WarpStage& s) {
  const int lane = threadIdx.x & (CL - 1);
  const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int rep = blockIdx.y;
  if (g >= a.cr) return;  // the whole warp: g is warp-uniform
  const float lam_s = a.params[0], f_na = a.params[1], f_aa = a.params[2];
  const float* Lr = a.params + 3 + 3 * rep;  // this replica's box
  const float L[3] = {Lr[0], Lr[1], Lr[2]};
  const float iL[3] = {1.0f / L[0], 1.0f / L[1], 1.0f / L[2]};

  const size_t rs = ((size_t)rep * a.cr + g) * CL + lane;
  Row r = {a.xr[rs * 3 + 0], a.xr[rs * 3 + 1], a.xr[rs * 3 + 2],
           0.f, 0.f, 0.f, 0.f, 0.f, 0.f, (int)a.idr[rs]};
  const bool live = r.id >= 0;
  if (live) {
    const float* f = a.feat + (size_t)r.id * 8;
    r.qs = f[F_QSTD];
    r.qa = f[F_QALCH];
    r.sig = f[F_SIG];
    r.eps = f[F_EPS];
    r.al = f[F_ALCH];
    r.in = f[F_INROWS];
  }
  float fx = 0.f, fy = 0.f, fz = 0.f, en = 0.f;

  const size_t rc_ = (size_t)rep * a.cr + g;
  const int n_ent = a.count[rc_];
  const int* ent = a.list + rc_ * a.width;
  const int cell = (kImage == IMG_SHIFT && n_ent > 0) ? (int)a.cl_cell[rc_] : 0;
  // K2's list holds width - 1 entries; a row cluster with more kept column
  // clusters walks all of them instead (exact, only slower). K3's list
  // always holds every candidate.
  const bool all = kImage != IMG_SHIFT && n_ent >= a.width;
  const int n_walk = all ? a.cc : n_ent;

  for (int e0 = 0; e0 < n_walk; e0 += STAGE) {
    const int ns = min(STAGE, n_walk - e0);
    __syncwarp();  // the previous round is consumed
    for (int k = 0; k < ns; ++k) {
      const int e = all ? e0 + k : ent[e0 + k];
      const int ccl = kImage == IMG_SHIFT ? (e >> 5) : e;
      const size_t cs = ((size_t)rep * a.cc + ccl) * CL + lane;
      const int id_j = (int)a.idc[cs];
      float x = a.xc[cs * 3 + 0], y = a.xc[cs * 3 + 1], z = a.xc[cs * 3 + 2];
      if (kImage == IMG_SHIFT) {
        // unfused, as the plain version rounds them
        const float* sh = a.shifts + ((size_t)cell * N_NBR + (e & 31)) * 3;
        x = __fadd_rn(x, __fmul_rn(sh[0], L[0]));
        y = __fadd_rn(y, __fmul_rn(sh[1], L[1]));
        z = __fadd_rn(z, __fmul_rn(sh[2], L[2]));
      }
      const int j = k * CL + lane;
      s.pos[j] = make_float4(x, y, z, __int_as_float(id_j));
      const float* f = a.feat + (size_t)max(id_j, 0) * 8;
      const bool ok = id_j >= 0;
      s.q[j] = ok ? make_float4(f[F_QSTD], f[F_QALCH], f[F_SIG], f[F_EPS])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      s.ai[j] = ok ? make_float2(f[F_ALCH], f[F_INROWS]) : make_float2(0.f, 0.f);
    }
    __syncwarp();
    staged_pairs<kImage, false>(r, ns * CL, s, nullptr, 0u, L, iL, lam_s, f_na,
                                f_aa, c, fx, fy, fz, en);
  }

  if (live) {
    const float keep = a.mask_rows ? r.in : 1.0f;
    float* o = a.out + ((size_t)rep * a.n + r.id) * 4;
    o[0] = fx * keep;
    o[1] = fy * keep;
    o[2] = fz * keep;
    o[3] = en * keep;
  }
}

}  // namespace cluster_pairs
