// Row x column pair sweep (softcore LJ + Ewald-erfc / reaction-field /
// plain Coulomb) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel K1, blues_tpu/potentials/pallas/
// sweep_kernel.py (_make_kernel, launched by make_sweep_pair_sum): the
// culled frozen sweep, on the host-built layout of
// blues_tpu_torch/potentials/sweep.py. Rows are packed in blocks of 32 row
// slots (one warp's width); each block reads the range [c0, c1) of the
// column storage, cut on the host into chunks of at most ROW_CHUNK columns
// (COL_CHUNK for an EA instance). Columns are static: their features are packed once into two
// 16-byte vectors per column, their positions are constants, except a
// mobile column's, which is read from the positions ``x`` of this call
// through a per-column index (-1 for a frozen column). Row positions are
// gathered from ``x`` too, so a call needs no tensor op before the launch.
// (K2, the all-pairs sum, and K3, the cell list, have their own kernels.)
//
// What bounds it: fp32 ALU and SFU work, and before that the launch itself.
// A frozen sweep keeps about 5 % of the slots it visits (MAIN: 53,835 of
// 1.02 M per replica), a visited slot costs a distance test and a kept one
// ~90 fp32 operations (pair_math.cuh), in all a few microseconds of work
// for 132 SMs; device memory traffic is a few MB. So the design fills the
// card with small blocks, spends the pair math only inside the cutoff, and
// makes a whole call two launches:
//
//   * sweep_rows_kernel (MAIN and E0 instances): grid (chunk, replica). A
//     lane owns a row of the chunk's block and keeps its F and E in
//     registers. Each of the block's 16 warps stages its 32 columns of the
//     chunk (at most 512) in its shared memory with 16-byte loads and runs
//     cluster_pairs.cuh's round over them: the lane lists its columns that
//     pass self / exclusion bit / cutoff, and a warp-uniform loop runs
//     pair_ef on listed pairs only. The warps add their sums through shared
//     memory in warp order and write one partial per (chunk, row slot). A
//     launch lasts as long as its slowest warp, and a warp's round is one
//     serial chain (the listed pairs one after another), so the host deals
//     the columns out over the rounds (sweep.py, deal_order) and the round
//     is short (rounds of 64 or 128 columns on fewer warps were never
//     faster on the card). A warp has one round, so there is no next tile
//     to prefetch, and the resident warps of an SM overlap each other's
//     loads.
//   * sweep_cols_kernel (EA instance, <= 128 alchemical rows with column
//     reaction forces): grid (chunk of <= 256 columns, replica), 8 warps.
//     The chunk's columns and the rows sit in shared memory; a lane owns a
//     column of a group of 32, and warp w takes the rows w, w + 8, ... of
//     every group, so the few groups near the alchemical atoms, where all
//     the pair math is, are spread over all warps (one thread per column
//     with a loop over the rows left that math to a handful of warps, one
//     long serial chain each). A warp whose 32 columns are all outside a
//     row's cutoff (most are) skips the row after one vote; otherwise the
//     lanes inside run pair_ef and the warp adds the row's sum to the
//     row's accumulator, which it alone owns. Each warp keeps its share of
//     a column's force in registers over its rows; the block adds the
//     warps' shares in warp order and writes the force once, to the
//     compact array of kept columns, and one partial per (chunk, row).
//   * sweep_reduce_kernel, one block per replica: sums each row slot's
//     partials over its block's chunks in chunk order, writes the row's
//     force at its atom in the (R, N, 3) force array, adds the kept column
//     forces at theirs (in one block, after a barrier: an atom that is both
//     a row and a kept column gets both, row first), and sums the (R,)
//     energy in a fixed tree.
//
// The force array is zeroed by the pair kernel's own threads (it writes
// nothing else there; the reduce kernel follows it on the stream), so no
// fill is launched. No float atomics anywhere: every sum has a fixed order
// and a call is deterministic.
//
// Each replica may have its own box (NPT): the box operand is (R, 3, 3) and
// replica rep reads its lengths at box + box_stride * rep (box_stride 9; 0
// when every replica shares one (3, 3) box). The chunk table, the culled
// columns and the minimum-image skip are built once from the first box, as
// in the JAX package.
//
// Numerics: pair_math.cuh. The minimum image, where it is on, is the plain
// version's IEEE division (IMG_DIV): K2's cheaper reciprocal needs a box
// known at build time to refuse L <= 2 (rc + margin), which a sweep is not
// given; the frozen path runs without it (skip_min_image).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_pairs.cuh"

using namespace cluster_pairs;

namespace {

constexpr int ROW_WARPS = 16;   // warps per block of the rows kernel
constexpr int ROW_CHUNK = ROW_WARPS * CL;  // columns per block, at most: a
                                           // warp's round is CL columns
constexpr int COL_WARPS = 8;    // warps per block of the EA kernel
constexpr int COL_CHUNK = 256;  // columns per block of the EA kernel, at most
constexpr int MAX_EA_ROWS = 128;
constexpr int MAX_EA_WORDS = MAX_EA_ROWS / 32;
constexpr int REDUCE_THREADS = 256;

}  // namespace

extern "C" {

// What an instance stages once: device pointers, sizes and the pair
// constants. sweep.py fills it through ctypes (_Instance, field for field).
struct SweepInstance {
  const float4* col_pos;   // (S) a frozen column's constant x, y, z
  const float4* col_q;     // (S) q_std, q_alch, sigma, epsilon
  const float4* col_a;     // (S) alch, in_rows, bits of the atom id, bits of
                           // the atom whose position in x a mobile column
                           // takes (-1: frozen, col_pos holds it)
  const uint32_t* excl;    // (S, W) exclusion bits per row slot, or null
  const float4* row_feat;  // (n_slots, 2) q_std, q_alch, sigma, epsilon |
                           // alch, in_rows, -, -
  const int* slot_gid;     // (n_slots) atom id of a row slot, -1 when empty
  const int* chunks;       // (n_chunks, 3) row block, c0, c1
  const int* block_chunks;  // (n_blocks + 1) a block's chunks, as a prefix
  const int* keep_pos;     // EA: (S) place in the kept list, -1 when dropped
  const int* keep_gid;     // EA: (n_keep) atom id of a kept column
  int N, n_slots, n_chunks, tr, W, n_keep, col_forces;
  int method;
  float cutoff;
  int use_cutoff;
  float alpha_ewald, k_rf, c_rf, ann, softcore_alpha;
  int wrap, has_switch;
  float switch_distance;
  int alch_coulomb;
  float ke;
};

}  // extern "C"

namespace {

// What the pair kernels of a call read and write.
struct Sweep {
  SweepInstance s;
  const float* x;      // (R, N, 3) positions of this call
  const float* lam_s;  // scalars on the device
  const float* f_na;
  const float* f_aa;
  const float* box;    // (R, 3, 3) read at box_stride * rep, or null
                       // (lengths 1)
  int box_stride;      // 9, or 0 where the replicas share one (3, 3) box
  float4* partial;     // (R, n_chunks, tr) F, E per chunk and row slot
  float4* outc;        // EA: (R, n_keep) kept column forces
  float* f;            // (R, N, 3), zeroed here
};

__device__ __forceinline__ void zero_fill(float* f, size_t count) {
  const size_t n_threads = (size_t)gridDim.x * gridDim.y * blockDim.x;
  const size_t tid =
      ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
  float4* f4 = reinterpret_cast<float4*>(f);  // the wrapper's own allocation
  const size_t n4 = count / 4;
  for (size_t i = tid; i < n4; i += n_threads)
    f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = n4 * 4 + tid; i < count; i += n_threads) f[i] = 0.f;
}

// replica rep's box lengths, and their reciprocals
__device__ __forceinline__ void box_lengths(const Sweep& a, int rep, float* L,
                                            float* iL) {
  const float* box = a.box ? a.box + (size_t)a.box_stride * rep : nullptr;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    L[d] = box ? box[4 * d] : 1.0f;
    iL[d] = 1.0f / L[d];
  }
}

// position and atom id of storage column p: from x when the column moves
__device__ __forceinline__ float4 column_position(const SweepInstance& s,
                                                  const float* x_rep, int p,
                                                  const float4& ca) {
  const int mob = __float_as_int(ca.w);
  float4 pos;
  if (mob >= 0) {
    const float* xp = x_rep + (size_t)mob * 3;
    pos = make_float4(xp[0], xp[1], xp[2], 0.f);
  } else {
    pos = s.col_pos[p];
  }
  pos.w = ca.z;
  return pos;
}

// row slot ``slot``: its atom's position from x, its features
__device__ __forceinline__ Row load_row(const SweepInstance& s,
                                        const float* x_rep, int slot) {
  Row r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, s.slot_gid[slot]};
  if (r.id >= 0) {
    const float* xp = x_rep + (size_t)r.id * 3;
    r.x = xp[0];
    r.y = xp[1];
    r.z = xp[2];
    const float4 q = s.row_feat[2 * slot], ai = s.row_feat[2 * slot + 1];
    r.qs = q.x;
    r.qa = q.y;
    r.sig = q.z;
    r.eps = q.w;
    r.al = ai.x;
    r.in = ai.y;
  }
  return r;
}

__device__ __forceinline__ void add4(float4& t, const float4& u) {
  t.x += u.x;
  t.y += u.y;
  t.z += u.z;
  t.w += u.w;
}

// a chunk of <= ROW_CHUNK columns: warp w takes the columns
// [c0 + w CL, c0 + (w + 1) CL) of it, one round
template <int kImage>
__global__ void __launch_bounds__(ROW_WARPS * CL)
    sweep_rows_kernel(Sweep a, PairConsts c) {
  __shared__ Stage<CL> stage[ROW_WARPS];
  __shared__ uint32_t s_ex[ROW_WARPS][CL];
  __shared__ float4 s_sum[ROW_WARPS][CL];

  const SweepInstance& in = a.s;
  zero_fill(a.f, (size_t)gridDim.y * in.N * 3);
  const int chunk = blockIdx.x;
  const int rep = blockIdx.y;
  if (chunk >= in.n_chunks) return;  // the whole block: a sweep with no chunk
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & (CL - 1);
  const int block = in.chunks[3 * chunk];
  const int c0 = in.chunks[3 * chunk + 1], c1 = in.chunks[3 * chunk + 2];
  const float* x_rep = a.x + (size_t)rep * in.N * 3;
  const float lam_s = *a.lam_s, f_na = *a.f_na, f_aa = *a.f_aa;
  float L[3], iL[3];
  box_lengths(a, rep, L, iL);

  const Row r = load_row(in, x_rep, block * CL + lane);
  float fx = 0.f, fy = 0.f, fz = 0.f, en = 0.f;
  Stage<CL>& s = stage[warp];
  uint32_t* ex = s_ex[warp];

  const int p = c0 + warp * CL + lane;
  if (p - lane < c1) {  // warp-uniform: the chunk reaches this warp
    if (p < c1) {
      const float4 ca = in.col_a[p];
      s.pos[lane] = column_position(in, x_rep, p, ca);
      s.q[lane] = in.col_q[p];
      s.ai[lane] = make_float2(ca.x, ca.y);
      ex[lane] = in.excl ? in.excl[p] : 0u;
    } else {  // past the chunk's end: an empty column, never listed
      s.pos[lane] = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
      ex[lane] = 0u;
    }
    __syncwarp();
    staged_pairs<kImage, true>(r, CL, s, ex, 1u << lane, L, iL, lam_s, f_na,
                               f_aa, c, fx, fy, fz, en);
  }

  s_sum[warp][lane] = make_float4(fx, fy, fz, en);
  __syncthreads();
  if (warp == 0) {
    float4 t = s_sum[0][lane];
#pragma unroll
    for (int w = 1; w < ROW_WARPS; ++w) add4(t, s_sum[w][lane]);
    a.partial[((size_t)rep * in.n_chunks + chunk) * CL + lane] = t;
  }
}

// EA instance: a chunk of <= COL_CHUNK columns and the rows (tr <= 128
// slots) in shared memory; lane = a column of a group of 32, warp w = the
// rows w, w + COL_WARPS, ...
template <int kImage>
__global__ void __launch_bounds__(COL_WARPS * CL)
    sweep_cols_kernel(Sweep a, PairConsts c) {
  __shared__ float4 s_rpos[MAX_EA_ROWS];  // x, y, z, bits of the atom id
  __shared__ float4 s_rq[MAX_EA_ROWS];
  __shared__ float2 s_ra[MAX_EA_ROWS];
  __shared__ float4 s_acc[MAX_EA_ROWS];  // a row's F, E over this chunk
  __shared__ float4 s_cpos[COL_CHUNK];
  __shared__ float4 s_cq[COL_CHUNK];
  __shared__ float2 s_ca[COL_CHUNK];
  __shared__ uint32_t s_cex[MAX_EA_WORDS][COL_CHUNK];
  __shared__ float s_fc[COL_WARPS][3][COL_CHUNK];  // the warps' column forces

  const SweepInstance& in = a.s;
  zero_fill(a.f, (size_t)gridDim.y * in.N * 3);
  const int chunk = blockIdx.x;
  const int rep = blockIdx.y;
  if (chunk >= in.n_chunks) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & (CL - 1);
  const int nr = in.tr;
  const int c0 = in.chunks[3 * chunk + 1];
  const int n = in.chunks[3 * chunk + 2] - c0;  // <= COL_CHUNK
  const float* x_rep = a.x + (size_t)rep * in.N * 3;
  const float lam_s = *a.lam_s, f_na = *a.f_na, f_aa = *a.f_aa;
  float L[3], iL[3];
  box_lengths(a, rep, L, iL);

  for (int r = threadIdx.x; r < nr; r += COL_WARPS * CL) {
    const Row row = load_row(in, x_rep, r);
    s_rpos[r] = make_float4(row.x, row.y, row.z, __int_as_float(row.id));
    s_rq[r] = make_float4(row.qs, row.qa, row.sig, row.eps);
    s_ra[r] = make_float2(row.al, row.in);
    s_acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j = threadIdx.x; j < COL_CHUNK; j += COL_WARPS * CL) {
    if (j < n) {
      const int p = c0 + j;
      const float4 ca = in.col_a[p];
      s_cpos[j] = column_position(in, x_rep, p, ca);
      s_cq[j] = in.col_q[p];
      s_ca[j] = make_float2(ca.x, ca.y);
      for (int w = 0; w < in.W; ++w)
        s_cex[w][j] = in.excl ? in.excl[(size_t)p * in.W + w] : 0u;
    } else {  // past the chunk's end: an empty column
      s_cpos[j] = make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
    }
  }
  __syncthreads();

  const int n_groups = (n + CL - 1) / CL;
  for (int g = 0; g < n_groups; ++g) {
    const int j = g * CL + lane;
    const float4 pos = s_cpos[j];
    const int id_j = __float_as_int(pos.w);
    float fcx = 0.f, fcy = 0.f, fcz = 0.f;
    for (int r = warp; r < nr; r += COL_WARPS) {  // warp-uniform
      const float4 rp = s_rpos[r];
      const int id_i = __float_as_int(rp.w);
      if (id_i < 0) continue;  // an empty row slot
      float dx, dy, dz;
      displacement<kImage>(rp.x, rp.y, rp.z, pos, L, iL, dx, dy, dz);
      float r2 = dist2(dx, dy, dz);
      const bool in_cut = (r2 < c.cutoff2 || !c.use_cutoff) && id_j >= 0 &&
                          id_i != id_j &&
                          !(s_cex[r >> 5][j] & (1u << (r & 31)));
      if (!__any_sync(0xffffffffu, in_cut)) continue;  // the whole warp
      float4 pr = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in_cut) {
        r2 = fmaxf(r2, 1e-6f);
        const float4 rq = s_rq[r], q = s_cq[j];
        const float2 ra = s_ra[r], ca = s_ca[j];
        const float aa = ra.x * ca.x;
        const float na = ra.x + ca.x - 2.0f * aa;
        float e, gg;
        pair_ef(r2, 0.5f * (rq.z + q.z), sqrtf(rq.w * q.w), rq.x * q.x,
                rq.x * q.y + rq.y * q.x, rq.y * q.y, na + c.ann * aa, lam_s,
                f_na, f_aa, c, e, gg);
        pr = make_float4(-gg * dx, -gg * dy, -gg * dz,
                         (1.0f - 0.5f * ra.y * ca.y) * e);
        fcx += gg * dx;
        fcy += gg * dy;
        fcz += gg * dz;
      }
      pr.x = warp_sum(pr.x);
      pr.y = warp_sum(pr.y);
      pr.z = warp_sum(pr.z);
      pr.w = warp_sum(pr.w);
      if (lane == 0) add4(s_acc[r], pr);  // this warp alone owns row r
    }
    s_fc[warp][0][j] = fcx;
    s_fc[warp][1][j] = fcy;
    s_fc[warp][2][j] = fcz;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n; j += COL_WARPS * CL) {
    const int k = in.keep_pos[c0 + j];
    if (k < 0) continue;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < COL_WARPS; ++w) {
      t.x += s_fc[w][0][j];
      t.y += s_fc[w][1][j];
      t.z += s_fc[w][2][j];
    }
    a.outc[(size_t)rep * in.n_keep + k] = t;
  }
  for (int r = threadIdx.x; r < nr; r += COL_WARPS * CL)
    a.partial[((size_t)rep * in.n_chunks + chunk) * nr + r] = s_acc[r];
}

// The second launch of a call, one block per replica: the row partials to
// forces and energy. Owners in f are unique without atomics: a live row slot
// owns its atom; the kept columns (distinct atoms) are added after the
// block's barrier, so an atom that is both gets row + column. In the NCMC
// path the two never meet: EA's rows are the alchemical atoms and its
// columns, hence the kept ones, the non-alchemical atoms (nonbonded.py,
// _build_sweep: cols_na leaves out alch_set).
__global__ void __launch_bounds__(REDUCE_THREADS)
    sweep_reduce_kernel(SweepInstance in,
                        const float4* __restrict__ partial,  // (R, n_chunks, tr)
                        const float4* __restrict__ outc,     // (R, n_keep)
                        float* __restrict__ f,               // (R, N, 3)
                        float* __restrict__ e) {             // (R)
  __shared__ float s_e[REDUCE_THREADS];
  const int rep = blockIdx.x;
  const int n_parts = max(in.n_chunks, 1);  // the scratch holds one at least
  float en = 0.f;
  for (int slot = threadIdx.x; slot < in.n_slots; slot += REDUCE_THREADS) {
    const int gid = in.slot_gid[slot];
    if (gid < 0) continue;
    const int b = slot / in.tr, l = slot - b * in.tr;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ch = in.block_chunks[b]; ch < in.block_chunks[b + 1]; ++ch)
      add4(t, partial[((size_t)rep * n_parts + ch) * in.tr + l]);
    float* o = f + ((size_t)rep * in.N + gid) * 3;
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    en += t.w;
  }
  __syncthreads();  // the rows' forces are in f
  for (int k = threadIdx.x; k < in.n_keep; k += REDUCE_THREADS) {
    const float4 u = outc[(size_t)rep * in.n_keep + k];
    float* o = f + ((size_t)rep * in.N + in.keep_gid[k]) * 3;
    o[0] += u.x;
    o[1] += u.y;
    o[2] += u.z;
  }
  s_e[threadIdx.x] = en;
  __syncthreads();
  for (int o = REDUCE_THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s_e[threadIdx.x] += s_e[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) e[rep] = s_e[0];
}

// does nothing: the card's floor for one launch
__global__ void sweep_empty_kernel() {}

}  // namespace

extern "C" {

int sweep_empty_launch(void* stream) {
  sweep_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// the most columns a chunk may hold: of a rows instance, of an EA instance
int sweep_row_chunk() { return ROW_CHUNK; }
int sweep_col_chunk() { return COL_CHUNK; }

// The reduce kernel: partials (and kept column forces) to f and e.
int sweep_reduce_launch(const SweepInstance* s, const void* partial,
                        const void* outc, float* f, float* e, int R,
                        void* stream) {
  sweep_reduce_kernel<<<R, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      *s, (const float4*)partial, (const float4*)outc, f, e);
  return (int)cudaGetLastError();
}

// A call: the pair kernel of the instance (the columns kernel when
// col_forces, else the rows kernel) over its chunk table, which writes the
// row partials ((R, max(n_chunks, 1), tr) float4), the kept column forces
// ((R, n_keep) float4) and the zeroed force array; then, unless e is null,
// the reduce kernel. Returns the first cudaGetLastError() that is not 0.
int sweep_launch(const SweepInstance* s, const float* x, const float* lam_s,
                 const float* f_na, const float* f_aa, const float* box,
                 int box_stride, void* partial, void* outc, float* f, float* e,
                 int R, void* stream) {
  if (R <= 0 || (s->col_forces ? s->tr > MAX_EA_ROWS : s->tr != CL) ||
      (box_stride != 0 && box_stride != 9))
    return (int)cudaErrorInvalidValue;
  const PairConsts c = make_consts(
      s->method, s->cutoff, s->use_cutoff, s->alpha_ewald, s->k_rf, s->c_rf,
      s->ann, s->softcore_alpha, s->wrap, s->has_switch, s->switch_distance,
      s->alch_coulomb, s->ke);
  const Sweep a = {*s,   x,          lam_s,           f_na,          f_aa,
                   box,  box_stride, (float4*)partial, (float4*)outc, f};
  cudaStream_t st = (cudaStream_t)stream;
  // the fill needs a block even where a sweep has no chunk
  const dim3 grid(s->n_chunks > 0 ? s->n_chunks : 1, R);
  if (s->col_forces) {
    if (s->wrap)
      sweep_cols_kernel<IMG_DIV><<<grid, COL_WARPS * CL, 0, st>>>(a, c);
    else
      sweep_cols_kernel<IMG_NONE><<<grid, COL_WARPS * CL, 0, st>>>(a, c);
  } else {
    if (s->wrap)
      sweep_rows_kernel<IMG_DIV><<<grid, ROW_WARPS * CL, 0, st>>>(a, c);
    else
      sweep_rows_kernel<IMG_NONE><<<grid, ROW_WARPS * CL, 0, st>>>(a, c);
  }
  const int err = (int)cudaGetLastError();
  if (err || !e) return err;
  return sweep_reduce_launch(s, partial, outc, f, e, R, stream);
}

}  // extern "C"
