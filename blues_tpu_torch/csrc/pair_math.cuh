// Per-pair nonbonded math shared by the port's pair kernels (sweep_kernel.cu,
// cells_kernel.cu): softcore LJ with an optional switch, Ewald-erfc /
// reaction-field / plain Coulomb, and the alchemical charge decomposition of
// blues_tpu_torch/potentials/pairs.py (pair_energy_force), f32 branch.
//
// Numerics: rsqrtf and __expf carry a few ulp of error, and the erfc is the
// Abramowitz & Stegun 7.1.26 form (|err| <= 1.5e-7) shared with the TPU
// kernels; both sit inside the stated tolerances (energy 5e-5*|E| + 1e-2,
// forces 2e-5*max|F|) that the plain PyTorch versions are held to.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pair_math {

enum Method { M_PME = 0, M_RF = 1, M_PLAIN = 2 };

struct PairConsts {
  int method;
  float cutoff2;
  int use_cutoff;
  float alpha_ewald;
  float k_rf;
  float c_rf;
  float ann;
  float softcore_alpha;
  int wrap;
  int has_switch;
  float switch_distance;
  float cutoff;
  int alch_coulomb;
  float ke;
};

inline PairConsts make_consts(int method, float cutoff, int use_cutoff,
                              float alpha_ewald, float k_rf, float c_rf,
                              float ann, float softcore_alpha, int wrap,
                              int has_switch, float switch_distance,
                              int alch_coulomb, float ke) {
  PairConsts c;
  c.method = method;
  c.cutoff = cutoff;
  c.cutoff2 = cutoff * cutoff;
  c.use_cutoff = use_cutoff;
  c.alpha_ewald = alpha_ewald;
  c.k_rf = k_rf;
  c.c_rf = c_rf;
  c.ann = ann;
  c.softcore_alpha = softcore_alpha;
  c.wrap = wrap;
  c.has_switch = has_switch;
  c.switch_distance = switch_distance;
  c.alch_coulomb = alch_coulomb;
  c.ke = ke;
  return c;
}

__device__ __forceinline__ void coulomb_erfc(float r2, float qq, float alpha,
                                             float ke, float& e, float& g) {
  const float inv_r = rsqrtf(r2);
  const float r = r2 * inv_r;
  const float x = alpha * r;
  const float gauss = __expf(-x * x);
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  e = ke * qq * (poly * gauss) * inv_r;
  g = -(e + ke * qq * (2.0f * alpha * 0.5641895835477563f) * gauss) * inv_r *
      inv_r;
}

__device__ __forceinline__ void coulomb_plain(float r2, float qq, float ke,
                                              float& e, float& g) {
  const float inv_r = rsqrtf(r2);
  e = ke * qq * inv_r;
  g = -e * inv_r * inv_r;
}

__device__ __forceinline__ void lj_switch(float r2, const PairConsts& c,
                                          float& s, float& ds, float& inv_r) {
  inv_r = rsqrtf(r2);
  const float r = r2 * inv_r;
  const float width = c.cutoff - c.switch_distance;
  float t = (r - c.switch_distance) / width;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  s = 1.0f + t * t * t * (-10.0f + t * (15.0f - 6.0f * t));
  ds = t * t * (-30.0f + t * (60.0f - 30.0f * t)) / width;
}

// potentials/pairs.py pair_energy_force, f32 branch: e and g = (dU/dr)/r
__device__ __forceinline__ void pair_ef(float r2, float sig, float eps,
                                        float qq_std, float qq_na, float qq_aa,
                                        float scale_ster, float lam_s,
                                        float f_na, float f_aa,
                                        const PairConsts& c, float& e,
                                        float& g) {
  const float lam_eff = scale_ster * lam_s + (1.0f - scale_ster);
  const float s2 = sig * sig;
  const float s6 = s2 * s2 * s2;
  const float r6 = r2 * r2 * r2;
  const float reff6 = c.softcore_alpha * (1.0f - lam_eff) * s6 + r6;
  const float inv6 = 1.0f / reff6;
  const float x = s6 * inv6;
  float e_lj = 4.0f * eps * lam_eff * (x * x - x);
  float g_lj = -24.0f * eps * lam_eff * (2.0f * x - 1.0f) * x * inv6 * r2 * r2;
  float sw = 1.0f, dsw = 0.0f, sw_inv_r = 0.0f;
  if (c.has_switch) {
    lj_switch(r2, c, sw, dsw, sw_inv_r);
    g_lj = sw * g_lj + dsw * e_lj * sw_inv_r;
    e_lj = sw * e_lj;
  }
  float e_el, g_el;
  if (c.alch_coulomb && c.method == M_PME) {
    coulomb_erfc(r2, qq_std, c.alpha_ewald, c.ke, e_el, g_el);
    float e_a, g_a;
    coulomb_plain(r2, f_na * qq_na + f_aa * qq_aa, c.ke, e_a, g_a);
    if (c.has_switch) {
      g_a = sw * g_a + dsw * e_a * sw_inv_r;
      e_a = sw * e_a;
    }
    e_el += e_a;
    g_el += g_a;
  } else {
    const float qq = qq_std + f_na * qq_na + f_aa * qq_aa;
    if (c.method == M_PME) {
      coulomb_erfc(r2, qq, c.alpha_ewald, c.ke, e_el, g_el);
    } else if (c.method == M_RF) {
      const float inv_r = rsqrtf(r2);
      e_el = c.ke * qq * (inv_r + c.k_rf * r2 - c.c_rf);
      g_el = c.ke * qq * (-inv_r * inv_r * inv_r + 2.0f * c.k_rf);
    } else {
      coulomb_plain(r2, qq, c.ke, e_el, g_el);
    }
  }
  e = e_lj + e_el;
  g = g_lj + g_el;
}

// The minimum image and r^2 round exactly as the plain PyTorch versions do
// (each product and sum rounded on its own, never fused into an FMA), so a
// pair within a rounding of the cutoff is in or out on both sides alike: at
// 22k atoms a few pairs per call lie there, and each one moves a force by a
// few kJ/mol/nm (the Ewald force at the cutoff).
__device__ __forceinline__ float wrap1(float d, float L, int wrap) {
  return wrap ? __fsub_rn(d, __fmul_rn(L, rintf(__fdiv_rn(d, L)))) : d;
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace pair_math
