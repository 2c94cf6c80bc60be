// The per-call cluster layout of the pair kernels K2 (pair_kernel.cu) and K3
// (cells_kernel.cu) on the card, NVIDIA Hopper, sm_90a.
//
// A call orders the atoms into clusters of 32 in three steps:
//
//   1. a key kernel of each source gives every atom an int64 sort key,
//      (bin << SUBKEY_BITS) | in-bin key: K3 bins by cell and sorts along a
//      snake over the cell's xy quarters, K2 bins by xy column and sorts by z;
//   2. a stable per-replica torch.sort of the keys (the wrapper);
//   3. layout_kernel below packs each bin's atoms, in sorted order, into
//      ceil(count / 32) consecutive clusters and takes every cluster's
//      bounding box.
//
// Their plain versions are the torch ops of blues_tpu_torch/potentials/
// clusters.py (layout_plain, column_key_plain) and pcells.py (key_plain).
// Every float operation here is rounded as PyTorch rounds it (explicit
// __f*_rn, no contraction into fused multiply-adds, rintf for torch.round),
// so kernel and plain version give the same bits: the same clusters, the
// same boxes, and so the same pruned lists.
//
// The layout kernel runs one 1024-thread block per replica: its steps (bin
// bounds, counts, a scan over the bins, the scatter, the boxes) each need
// the previous one finished for the whole replica, and __syncthreads is the
// cheapest such barrier. A replica of 22k atoms is a few passes of 22
// elements per thread. What it replaces is ~50 small torch launches.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cluster_layout {

constexpr int CL = 32;
constexpr int SUBKEY_BITS = 20;   // clusters.py SUBKEY_BITS
constexpr int THREADS = 1024;     // one block per replica
constexpr unsigned FULL = 0xffffffffu;

// How the layout places and bounds positions (clusters.py LAY_*).
constexpr int LAY_RAW = 0;   // K2, non-periodic: raw positions, plain boxes
constexpr int LAY_MIN = 1;   // K2, periodic: raw positions, boxes in each
                             // cluster's minimum-image frame
constexpr int LAY_WRAP = 2;  // K3: positions wrapped into the box

// x - L floor(x / L), as torch rounds it
__device__ __forceinline__ float wrap1(float x, float L) {
  return __fsub_rn(x, __fmul_rn(L, floorf(__fdiv_rn(x, L))));
}

__device__ __forceinline__ long long warp_max_ll(long long v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The block's max of v (every thread gets it); all threads must call it.
__device__ long long block_max_ll(long long v) {
  __shared__ long long part[THREADS / CL];
  v = warp_max_ll(v);
  const int lane = threadIdx.x & (CL - 1), w = threadIdx.x / CL;
  if (lane == 0) part[w] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x / CL) ? part[lane] : LLONG_MIN;
  v = warp_max_ll(v);
  __syncthreads();  // part is reused by the next call
  return v;
}

// out[i] = in[0] + ... + in[i - 1] for i < n, by the whole block, in chunks
// of blockDim.x (exact: integers).
__device__ void block_exclusive_scan(const int64_t* in, int64_t* out, int n) {
  __shared__ long long warp_sum[THREADS / CL];
  __shared__ long long carry;
  const int tid = threadIdx.x, lane = tid & (CL - 1), w = tid / CL;
  const int nw = blockDim.x / CL;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + tid;
    const long long v = i < n ? in[i] : 0;
    long long s = v;  // inclusive within the warp
    for (int o = 1; o < CL; o <<= 1) {
      const long long t = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += t;
    }
    if (lane == CL - 1) warp_sum[w] = s;
    __syncthreads();
    if (w == 0) {
      long long t = lane < nw ? warp_sum[lane] : 0;
      for (int o = 1; o < CL; o <<= 1) {
        const long long u = __shfl_up_sync(FULL, t, o);
        if (lane >= o) t += u;
      }
      if (lane < nw) warp_sum[lane] = t;  // inclusive over the warps
    }
    __syncthreads();
    const long long before = carry + (w > 0 ? warp_sum[w - 1] : 0);
    if (i < n) out[i] = before + s - v;
    __syncthreads();
    if (tid == blockDim.x - 1) carry = before + s;
    __syncthreads();
  }
}

struct LayoutArgs {
  const int64_t* skey;   // (R, m) keys, sorted per replica
  const int64_t* order;  // (R, m) the sort's permutation
  const float* x;        // (R, n, 3) positions
  const int64_t* ids_t;  // (m,) atom id of each laid-out atom
  const float* L;        // (R, 3) box lengths per replica (ones when not
                         // periodic)
  int64_t* ids;          // (R, C*32) atom id per slot, -1 when empty
  float* xo;             // (R, C*32, 3) slot positions
  int64_t* cl_bin;       // (R, C) bin of each cluster, n_bins when unused
  int64_t* counts;       // (R, n_bins) atoms per bin
  int64_t* lo;           // (R, n_bins) scratch: first sorted index per bin
  int64_t* ncl;          // (R, n_bins + 1) clusters per bin
  int64_t* start;        // (R, n_bins + 1) first cluster of each bin
  float* centre;         // (R, C, 3) bounding-box centres
  float* half;           // (R, C, 3) bounding-box half extents
  bool* live;            // (R, C) the cluster holds an atom
  bool* invalid;         // (R,) the poison: K3, a bin over cap or a box
                         // shrunk below cutoff-wide cells; K2 (LAY_MIN), a
                         // box too small for the pair kernel's minimum image
  int n, m, n_bins, C, mode, cap;  // cap < 0: no bin poison (K2)
  int nc[3];             // K3: cells per dimension
  float bound;           // K3: the cutoff, the least cell edge; K2: the
                         // length every box edge must exceed, 2 (rc + margin)
};

__global__ void __launch_bounds__(THREADS) layout_kernel(LayoutArgs a) {
  const int rep = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int m = a.m, nb = a.n_bins, C = a.C;
  const size_t P = (size_t)C * CL;
  const int64_t* sk = a.skey + (size_t)rep * m;
  const int64_t* od = a.order + (size_t)rep * m;
  int64_t* cnt = a.counts + (size_t)rep * nb;
  int64_t* lo = a.lo + (size_t)rep * nb;
  int64_t* ncl = a.ncl + (size_t)rep * (nb + 1);
  int64_t* st = a.start + (size_t)rep * (nb + 1);
  int64_t* ids = a.ids + (size_t)rep * P;
  float* xo = a.xo + (size_t)rep * P * 3;
  int64_t* clb = a.cl_bin + (size_t)rep * C;
  const float L[3] = {a.L[3 * rep + 0], a.L[3 * rep + 1], a.L[3 * rep + 2]};

  for (int b = tid; b < nb; b += nt) cnt[b] = 0;
  for (size_t p = tid; p < P; p += nt) {
    ids[p] = -1;
    xo[p * 3 + 0] = xo[p * 3 + 1] = xo[p * 3 + 2] = 0.0f;
  }
  for (int c = tid; c < C; c += nt) clb[c] = nb;
  __syncthreads();

  // each bin's run in sorted order: its first index, and one past its last
  for (int s = tid; s < m; s += nt) {
    const int64_t b = sk[s] >> SUBKEY_BITS;
    if (s == 0 || (sk[s - 1] >> SUBKEY_BITS) != b) lo[b] = s;
    if (s == m - 1 || (sk[s + 1] >> SUBKEY_BITS) != b) cnt[b] = s + 1;
  }
  __syncthreads();
  for (int b = tid; b <= nb; b += nt) {
    int64_t c = 0;
    if (b < nb) {
      c = cnt[b];
      if (c > 0) cnt[b] = c = c - lo[b];
    }
    ncl[b] = (c + CL - 1) / CL;
  }
  __syncthreads();
  block_exclusive_scan(ncl, st, nb + 1);
  __syncthreads();

  // the atom at sorted index s is the (s - lo[b])-th of its bin b
  for (int s = tid; s < m; s += nt) {
    const int64_t b = sk[s] >> SUBKEY_BITS;
    const int64_t k = s - lo[b];
    const int64_t slot = st[b] * CL + k;
    const int64_t gid = a.ids_t[od[s]];
    ids[slot] = gid;
    const float* p = a.x + ((size_t)rep * a.n + gid) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      xo[slot * 3 + d] = a.mode == LAY_WRAP ? wrap1(p[d], L[d]) : p[d];
    if (k % CL == 0) clb[slot / CL] = b;
  }
  __syncthreads();

  // bounding boxes, a warp per cluster: the offsets of its atoms from its
  // first atom (wrapped with LAY_MIN), their min and max
  const int lane = tid & (CL - 1), w = tid / CL, nw = nt / CL;
  for (int c = w; c < C; c += nw) {
    const size_t p = (size_t)c * CL + lane;
    const bool ok = ids[p] >= 0;
    const bool lv = __shfl_sync(FULL, (int)ok, 0) != 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float ref = xo[(size_t)c * CL * 3 + d];
      float off = __fsub_rn(xo[p * 3 + d], ref);
      if (a.mode == LAY_MIN)
        off = __fsub_rn(off, __fmul_rn(L[d], rintf(__fdiv_rn(off, L[d]))));
      const float mn = warp_min(ok ? off : INFINITY);
      const float mx = warp_max(ok ? off : -INFINITY);
      if (lane == 0) {
        const size_t q = ((size_t)rep * C + c) * 3 + d;
        a.centre[q] = lv ? __fadd_rn(ref, __fmul_rn(0.5f, __fadd_rn(mn, mx))) : 0.0f;
        a.half[q] = lv ? __fmul_rn(0.5f, __fsub_rn(mx, mn)) : 0.0f;
      }
    }
    if (lane == 0) a.live[(size_t)rep * C + c] = lv;
  }

  if (a.cap >= 0) {
    long long most = 0;
    for (int b = tid; b < nb; b += nt) most = max(most, (long long)cnt[b]);
    most = block_max_ll(most);
    if (tid == 0) {
      bool bad = most > a.cap;
      for (int d = 0; d < 3; ++d)
        bad = bad || __fdiv_rn(L[d], (float)a.nc[d]) < a.bound;
      a.invalid[rep] = bad;
    }
  } else if (a.mode == LAY_MIN && tid == 0) {
    a.invalid[rep] = L[0] <= a.bound || L[1] <= a.bound || L[2] <= a.bound;
  }
}

inline int launch_layout(const LayoutArgs& a, int R, cudaStream_t s) {
  if (R <= 0 || a.n <= 0 || a.m <= 0 || a.n_bins <= 0 || a.C <= 0)
    return (int)cudaErrorInvalidValue;
  layout_kernel<<<R, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace cluster_layout

// The C interface of a source's layout kernel (identical in both sources).
#define CLUSTER_LAYOUT_ENTRY(name)                                            \
  extern "C" int name(                                                        \
      const int64_t* skey, const int64_t* order, const float* x,              \
      const int64_t* ids_t, const float* L, int64_t* ids, float* xo,          \
      int64_t* cl_bin, int64_t* counts, int64_t* lo, int64_t* ncl,            \
      int64_t* start, float* centre, float* half, bool* live, bool* invalid,  \
      int R, int n, int m, int n_bins, int C, int mode, int cap, int nc0,     \
      int nc1, int nc2, float bound, void* stream) {                          \
    const cluster_layout::LayoutArgs a{                                       \
        skey,  order,  x,    ids_t,   L,   ids,    xo,    cl_bin,  counts,    \
        lo,    ncl,    start, centre, half, live,  invalid, n,     m,         \
        n_bins, C,     mode, cap,     {nc0, nc1, nc2},     bound};            \
    return cluster_layout::launch_layout(a, R, (cudaStream_t)stream);         \
  }
