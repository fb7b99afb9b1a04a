// B-grid EVP subcycles for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel cice_tpu/kernels/evp_pallas.py
// (`evp_solve_fused` -> `_chunk_call`, pallas_call at line 184): the ndte
// subcycle loop of the elastic-viscous-plastic solver, each subcycle one
// `stress_update` (4-corner bilinear strain rates, viscosities and
// replacement pressure, elastic relaxation, 8 stress-divergence terms per
// T cell) and one `stepu_dense` (implicit Coriolis / water-drag momentum
// solve at U points). The arithmetic mirrors
// cice_tpu_torch/dynamics/evp.py expression by expression, so the plain
// PyTorch `evp_solve` is its reference.
//
// What bounds it on the H100: per subcycle the two kernels touch 26
// constant, 14 state and 8 scratch planes (~24 MB at gx1) for ~470 flops
// per cell, ~1.5 flop per byte: memory-bound if those planes came from HBM
// every subcycle (~0.95 ms per 120-subcycle solve). The working set fits
// the 50 MB L2, so the floor for the whole solve is its arithmetic
// (~6.9 GFLOP, ~0.10 ms at the f32 peak) plus the latency of 240 launches.
//
// Design (simple first): per subcycle one T-cell kernel (stress update,
// writes the 12 corner stresses in place and the 8 str* terms to scratch)
// and one U-cell kernel (4-cell gather of the str* terms, stepu, updates
// u/v in place). In-place updates are safe: each T cell reads/writes only
// its own stresses and each U cell only its own velocity; neighbours are
// read only in the other kernel. Both launches go on the caller's stream;
// nothing is allocated here. Fusing k subcycles per launch in shared
// memory (the TPU kernel's wide-halo trade) is later work.
//
// Boundaries: east-west cyclic or zero ghost; north-south zero ghost
// (open/closed). Tripole and y-cyclic grids are rejected by the wrapper.

#include <cuda_runtime.h>

namespace {

// constant planes, in cice_tpu_torch/kernels/evp.py CONST_PLANES order
enum {
  C_DXT, C_DYT, C_CXM, C_CXP, C_CYM, C_CYP, C_DXHY, C_DYHX, C_UAREAR,
  C_ICETMASK, C_ICEUMASK, C_AIU, C_UMASSDTI, C_FM, C_WATERX, C_WATERY,
  C_FORCEX, C_FORCEY, C_UVEL_INIT, C_VVEL_INIT, C_CW, C_TBU, C_STRENGTH,
  C_DMINTAREA, C_UOCN, C_VOCN, N_CONST
};
// state planes: u, v, stressp[4], stressm[4], stress12[4]
enum { S_U = 0, S_V = 1, S_SP = 2, S_SM = 6, S_S12 = 10, N_STATE = 14 };

// scalar parameters, in cice_tpu_torch/kernels/evp.py PARAMS order
struct Params {
  float e_factor, capping, one_p_ktens, one_m_ktens, epp2i;
  float c1m, arlx1i, denom1, brlx_p_revp, brlx, revp;
  float rhow, u0, cosw, sinw;
};

constexpr float P5 = 0.5f, P25 = 0.25f;
constexpr float P333 = (float)(1.0 / 3.0);
constexpr float P166 = (float)(1.0 / 6.0);
constexpr float P222 = (float)(2.0 / 9.0);
constexpr float P111 = (float)(1.0 / 9.0);
constexpr float P055 = (float)(1.0 / 18.0);
constexpr float P027 = (float)(1.0 / 36.0);
constexpr float RHEO_AREA_MIN = 1.0e-3f;

__device__ __forceinline__ float ld(const float* __restrict__ a, int j, int i,
                                    int ny, int nx, int xcyc) {
  if (i < 0) {
    if (!xcyc) return 0.f;
    i += nx;
  } else if (i >= nx) {
    if (!xcyc) return 0.f;
    i -= nx;
  }
  if (j < 0 || j >= ny) return 0.f;
  return a[(size_t)j * nx + i];
}

__device__ __forceinline__ void visc(const Params& p, float strength,
                                     float dmin, float Delta, float& zetax2,
                                     float& etax2, float& rep_prs) {
  float tmp;
  if (p.capping == 1.0f) {
    tmp = strength / fmaxf(fmaxf(Delta, dmin), 1e-30f);
  } else if (p.capping == 0.0f) {
    tmp = strength / fmaxf(Delta + dmin, 1e-30f);
  } else {
    tmp = p.capping * (strength / fmaxf(fmaxf(Delta, dmin), 1e-30f)) +
          (1.0f - p.capping) * (strength / fmaxf(Delta + dmin, 1e-30f));
  }
  zetax2 = p.one_p_ktens * tmp;
  rep_prs = p.one_m_ktens * tmp * Delta;
  etax2 = p.epp2i * zetax2;
}

// T-cell kernel: stress update at the 4 corners + the 8 str* terms.
__global__ void evp_stress_kernel(const float* __restrict__ cst,
                                  float* __restrict__ st,
                                  float* __restrict__ strb, int ny, int nx,
                                  int xcyc, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t P = (size_t)ny * nx;
  const size_t k = (size_t)j * nx + i;
  const float* cu = st + S_U * P;
  const float* cv = st + S_V * P;

  const float u = cu[k], v = cv[k];
  const float uw = ld(cu, j, i - 1, ny, nx, xcyc);
  const float vw = ld(cv, j, i - 1, ny, nx, xcyc);
  const float us = ld(cu, j - 1, i, ny, nx, xcyc);
  const float vs = ld(cv, j - 1, i, ny, nx, xcyc);
  const float usw = ld(cu, j - 1, i - 1, ny, nx, xcyc);
  const float vsw = ld(cv, j - 1, i - 1, ny, nx, xcyc);

  const float cyp = cst[C_CYP * P + k], cxp = cst[C_CXP * P + k];
  const float cym = cst[C_CYM * P + k], cxm = cst[C_CXM * P + k];
  const float dxT = cst[C_DXT * P + k], dyT = cst[C_DYT * P + k];
  const float dxhy = cst[C_DXHY * P + k], dyhx = cst[C_DYHX * P + k];

  const float divune = cyp * u - dyT * uw + cxp * v - dxT * vs;
  const float divunw = cym * uw + dyT * u + cxp * vw - dxT * vsw;
  const float divusw = cym * usw + dyT * us + cxm * vsw + dxT * vw;
  const float divuse = cyp * us - dyT * usw + cxm * vs + dxT * v;

  const float tensionne = -cym * u - dyT * uw + cxm * v + dxT * vs;
  const float tensionnw = -cyp * uw + dyT * u + cxm * vw + dxT * vsw;
  const float tensionsw = -cyp * usw + dyT * us + cxp * vsw - dxT * vw;
  const float tensionse = -cym * us - dyT * usw + cxp * vs - dxT * v;

  const float shearne = -cym * v - dyT * vw - cxm * u - dxT * us;
  const float shearnw = -cyp * vw + dyT * v - cxm * uw - dxT * usw;
  const float shearsw = -cyp * vsw + dyT * vs - cxp * usw + dxT * uw;
  const float shearse = -cym * vs - dyT * vsw - cxp * us + dxT * u;

  const float ef = p.e_factor;
  const float Deltane = sqrtf(divune * divune +
                              ef * (tensionne * tensionne + shearne * shearne));
  const float Deltanw = sqrtf(divunw * divunw +
                              ef * (tensionnw * tensionnw + shearnw * shearnw));
  const float Deltasw = sqrtf(divusw * divusw +
                              ef * (tensionsw * tensionsw + shearsw * shearsw));
  const float Deltase = sqrtf(divuse * divuse +
                              ef * (tensionse * tensionse + shearse * shearse));

  const float strength = cst[C_STRENGTH * P + k];
  const float dmin = cst[C_DMINTAREA * P + k];
  float zne, ene, rne, znw, enw, rnw, zsw, esw, rsw, zse, ese, rse;
  visc(p, strength, dmin, Deltane, zne, ene, rne);
  visc(p, strength, dmin, Deltanw, znw, enw, rnw);
  visc(p, strength, dmin, Deltasw, zsw, esw, rsw);
  visc(p, strength, dmin, Deltase, zse, ese, rse);

  const bool icet = cst[C_ICETMASK * P + k] > 0.5f;
  float* sp = st + S_SP * P;
  float* sm = st + S_SM * P;
  float* s12 = st + S_S12 * P;
#define RELAX(old, target) \
  (icet ? ((old) * p.c1m + p.arlx1i * (target)) * p.denom1 : (old))
  const float sp1 = RELAX(sp[0 * P + k], zne * divune - rne);
  const float sp2 = RELAX(sp[1 * P + k], znw * divunw - rnw);
  const float sp3 = RELAX(sp[2 * P + k], zsw * divusw - rsw);
  const float sp4 = RELAX(sp[3 * P + k], zse * divuse - rse);
  const float sm1 = RELAX(sm[0 * P + k], ene * tensionne);
  const float sm2 = RELAX(sm[1 * P + k], enw * tensionnw);
  const float sm3 = RELAX(sm[2 * P + k], esw * tensionsw);
  const float sm4 = RELAX(sm[3 * P + k], ese * tensionse);
  const float s121 = RELAX(s12[0 * P + k], P5 * ene * shearne);
  const float s122 = RELAX(s12[1 * P + k], P5 * enw * shearnw);
  const float s123 = RELAX(s12[2 * P + k], P5 * esw * shearsw);
  const float s124 = RELAX(s12[3 * P + k], P5 * ese * shearse);
#undef RELAX
  sp[0 * P + k] = sp1; sp[1 * P + k] = sp2;
  sp[2 * P + k] = sp3; sp[3 * P + k] = sp4;
  sm[0 * P + k] = sm1; sm[1 * P + k] = sm2;
  sm[2 * P + k] = sm3; sm[3 * P + k] = sm4;
  s12[0 * P + k] = s121; s12[1 * P + k] = s122;
  s12[2 * P + k] = s123; s12[3 * P + k] = s124;

  // stress_terms (dynamics/evp.py), verbatim order of operations
  const float ssigpn = sp1 + sp2;
  const float ssigps = sp3 + sp4;
  const float ssigpe = sp1 + sp4;
  const float ssigpw = sp2 + sp3;
  const float ssigp1 = (sp1 + sp3) * P055;
  const float ssigp2 = (sp2 + sp4) * P055;

  const float ssigmn = sm1 + sm2;
  const float ssigms = sm3 + sm4;
  const float ssigme = sm1 + sm4;
  const float ssigmw = sm2 + sm3;
  const float ssigm1 = (sm1 + sm3) * P055;
  const float ssigm2 = (sm2 + sm4) * P055;

  const float ssig12n = s121 + s122;
  const float ssig12s = s123 + s124;
  const float ssig12e = s121 + s124;
  const float ssig12w = s122 + s123;
  const float ssig121 = (s121 + s123) * P111;
  const float ssig122 = (s122 + s124) * P111;

  const float csigpne = P111 * sp1 + ssigp2 + P027 * sp3;
  const float csigpnw = P111 * sp2 + ssigp1 + P027 * sp4;
  const float csigpsw = P111 * sp3 + ssigp2 + P027 * sp1;
  const float csigpse = P111 * sp4 + ssigp1 + P027 * sp2;

  const float csigmne = P111 * sm1 + ssigm2 + P027 * sm3;
  const float csigmnw = P111 * sm2 + ssigm1 + P027 * sm4;
  const float csigmsw = P111 * sm3 + ssigm2 + P027 * sm1;
  const float csigmse = P111 * sm4 + ssigm1 + P027 * sm2;

  const float csig12ne = P222 * s121 + ssig122 + P055 * s123;
  const float csig12nw = P222 * s122 + ssig121 + P055 * s124;
  const float csig12sw = P222 * s123 + ssig122 + P055 * s121;
  const float csig12se = P222 * s124 + ssig121 + P055 * s122;

  const float str12ew = P5 * dxT * (P333 * ssig12e + P166 * ssig12w);
  const float str12we = P5 * dxT * (P333 * ssig12w + P166 * ssig12e);
  const float str12ns = P5 * dyT * (P333 * ssig12n + P166 * ssig12s);
  const float str12sn = P5 * dyT * (P333 * ssig12s + P166 * ssig12n);

  float strp = P25 * dyT * (P333 * ssigpn + P166 * ssigps);
  float strm = P25 * dyT * (P333 * ssigmn + P166 * ssigms);
  strb[0 * P + k] = -strp - strm - str12ew + dxhy * (-csigpne + csigmne) +
                    dyhx * csig12ne;
  strb[1 * P + k] = strp + strm - str12we + dxhy * (-csigpnw + csigmnw) +
                    dyhx * csig12nw;
  strp = P25 * dyT * (P333 * ssigps + P166 * ssigpn);
  strm = P25 * dyT * (P333 * ssigms + P166 * ssigmn);
  strb[2 * P + k] = -strp - strm + str12ew + dxhy * (-csigpse + csigmse) +
                    dyhx * csig12se;
  strb[3 * P + k] = strp + strm + str12we + dxhy * (-csigpsw + csigmsw) +
                    dyhx * csig12sw;

  strp = P25 * dxT * (P333 * ssigpe + P166 * ssigpw);
  strm = P25 * dxT * (P333 * ssigme + P166 * ssigmw);
  strb[4 * P + k] = -strp + strm - str12ns - dyhx * (csigpne + csigmne) +
                    dxhy * csig12ne;
  strb[5 * P + k] = strp - strm - str12sn - dyhx * (csigpse + csigmse) +
                    dxhy * csig12se;
  strp = P25 * dxT * (P333 * ssigpw + P166 * ssigpe);
  strm = P25 * dxT * (P333 * ssigmw + P166 * ssigme);
  strb[6 * P + k] = -strp + strm + str12ns - dyhx * (csigpnw + csigmnw) +
                    dxhy * csig12nw;
  strb[7 * P + k] = strp - strm + str12sn - dyhx * (csigpsw + csigmsw) +
                    dxhy * csig12sw;
}

// U-cell kernel: gather the str* terms of the 4 T cells sharing U(i,j)
// (this, east, north, northeast) and take the momentum step.
__global__ void evp_stepu_kernel(const float* __restrict__ cst,
                                 float* __restrict__ st,
                                 const float* __restrict__ strb, int ny,
                                 int nx, int xcyc, Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t P = (size_t)ny * nx;
  const size_t k = (size_t)j * nx + i;

  const float uarear = cst[C_UAREAR * P + k];
  const float strintx =
      uarear * (strb[0 * P + k] + ld(strb + 1 * P, j, i + 1, ny, nx, xcyc) +
                ld(strb + 2 * P, j + 1, i, ny, nx, xcyc) +
                ld(strb + 3 * P, j + 1, i + 1, ny, nx, xcyc));
  const float strinty =
      uarear * (strb[4 * P + k] + ld(strb + 5 * P, j + 1, i, ny, nx, xcyc) +
                ld(strb + 6 * P, j, i + 1, ny, nx, xcyc) +
                ld(strb + 7 * P, j + 1, i + 1, ny, nx, xcyc));

  float* cu = st + S_U * P;
  float* cv = st + S_V * P;
  const float uold = cu[k], vold = cv[k];
  const float aiU = cst[C_AIU * P + k];
  const float Cw = cst[C_CW * P + k];
  const float uocn = cst[C_UOCN * P + k], vocn = cst[C_VOCN * P + k];
  const float umassdti = cst[C_UMASSDTI * P + k];
  const float fm = cst[C_FM * P + k];
  const bool iceu = cst[C_ICEUMASK * P + k] > 0.5f;

  const float du = uocn - uold, dv = vocn - vold;
  const float vrel = aiU * p.rhow * Cw * sqrtf(du * du + dv * dv);
  const float taux = vrel * cst[C_WATERX * P + k];
  const float tauy = vrel * cst[C_WATERY * P + k];
  const float Cb = cst[C_TBU * P + k] / (sqrtf(uold * uold + vold * vold) + p.u0);
  const float cca = p.brlx_p_revp * umassdti + vrel * p.cosw + Cb;
  const float fmn = (fm == 0.0f) ? 1.0f : fm;
  const float sgn = (fmn > 0.0f) ? 1.0f : ((fmn < 0.0f) ? -1.0f : 0.0f);
  const float ccb = fm + sgn * vrel * p.sinw;
  float ab2 = cca * cca + ccb * ccb;
  const float rf = (aiU > RHEO_AREA_MIN) ? 1.0f : 0.0f;
  const float cc1 = rf * strintx + cst[C_FORCEX * P + k] + taux +
                    umassdti * (p.brlx * uold + p.revp * cst[C_UVEL_INIT * P + k]);
  const float cc2 = rf * strinty + cst[C_FORCEY * P + k] + tauy +
                    umassdti * (p.brlx * vold + p.revp * cst[C_VVEL_INIT * P + k]);
  ab2 = iceu ? ab2 : 1.0f;
  const float rab2 = 1.0f / ab2;
  cu[k] = iceu ? (cca * cc1 + ccb * cc2) * rab2 : 0.0f;
  cv[k] = iceu ? (cca * cc2 - ccb * cc1) * rab2 : 0.0f;
}

}  // namespace

// Run `ndte` EVP subcycles in place on `state` (14 planes). `cst` holds
// the 26 constant planes, `strbuf` 8 scratch planes, all (ny, nx) f32
// contiguous on the device; `params` points to host memory holding the
// 15 floats of Params. Returns the first CUDA error (0 = success).
extern "C" int evp_subcycles(const float* cst, float* state, float* strbuf,
                             int ny, int nx, int xcyc, int ndte,
                             const float* params, void* stream) {
  Params p;
  const float* q = params;
  p.e_factor = q[0]; p.capping = q[1]; p.one_p_ktens = q[2];
  p.one_m_ktens = q[3]; p.epp2i = q[4]; p.c1m = q[5]; p.arlx1i = q[6];
  p.denom1 = q[7]; p.brlx_p_revp = q[8]; p.brlx = q[9]; p.revp = q[10];
  p.rhow = q[11]; p.u0 = q[12]; p.cosw = q[13]; p.sinw = q[14];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  for (int it = 0; it < ndte; ++it) {
    evp_stress_kernel<<<grid, block, 0, s>>>(cst, state, strbuf, ny, nx,
                                             xcyc, p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    evp_stepu_kernel<<<grid, block, 0, s>>>(cst, state, strbuf, ny, nx,
                                            xcyc, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
