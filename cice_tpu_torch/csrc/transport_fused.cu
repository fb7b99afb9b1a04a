// One-pass exact incremental-remapping transport for NVIDIA Hopper
// (sm_90a), f32.
//
// Replaces the TPU kernel cice_tpu/kernels/remap_pallas.py
// (`transport_fused`, pallas_call at line 653, helpers _lim_grad_win,
// _mass_recon, _construct_win, _fluxes_win, _update_win): for each
// category, the limited-gradient reconstruction of mass and tracers, the
// edge fluxes over 6 donor candidates x 2 edge families from the 10
// pentagon moments, the type-1/2/3 tracer dependency chains of the flat
// tracer table, and the flux-divergence update with puny chain floors and
// the lo/hi rails. It emits the mass BEFORE the negative-mass floor (open
// water row included) and the new tracers. The arithmetic mirrors the
// plain PyTorch path in cice_tpu_torch/dynamics/remap_exact.py
// (construct_fields -> fluxes_from_moments -> update_pre_floor).
//
// What bounds it on the H100: one call must read the tracer stack
// (ncat*NT planes), the mass (ncat+1 planes), the 120 moment planes and 4
// grid planes, and write ncat*NT + ncat + 1 planes: ~190 MB at gx1 with
// NT=25, 57 us at 3.35 TB/s. Its arithmetic (reconstruction, 2 edges x 6
// candidates x the chain sums per tracer, the update) is ~5.7 GFLOP, 85 us
// at the f32 peak: the two bounds are close, arithmetic slightly ahead, so
// the design reads each input once per tile and keeps intermediates in
// shared memory rather than saving arithmetic.
//
// Design: one thread block per (2-D tile, category). Phase 1 reconstructs
// mass and tracers on the tile plus a one-cell ring into shared memory
// (reading the raw 3x3 neighbourhoods from global memory, which L1/L2
// serve); phase 2 gives each thread one cell, which computes the fluxes
// across its 4 edges from the shared reconstructions (each interior edge
// is computed by both cells that share it: 2x flux arithmetic, no second
// pass), accumulates the divergence per tracer in shared memory and
// solves the new-value chains in place. The flat table (type, parent,
// grandparent, rails) arrives as small device arrays, so any NT works
// while it fits the wrapper's shared-memory tile choice. Nothing is
// allocated here; the launch goes on the caller's stream.
//
// Boundaries: east-west cyclic or zero ghost; north-south zero ghost
// (open/closed), matching the zero-ghost `shift` of the plain path.

#include <cuda_runtime.h>

namespace {

constexpr float PUNY = 1.0e-11f;
constexpr float XXAV = (float)(1.0 / 12.0);
constexpr int NMOM = 10;
// donor offsets (dj, di) per candidate, in remap_exact.CANDS order
__constant__ int OFF_N[6][2] = {{1, -1}, {1, 0}, {1, 1},
                                {0, -1}, {0, 0}, {0, 1}};
__constant__ int OFF_E[6][2] = {{-1, 1}, {0, 1}, {1, 1},
                                {-1, 0}, {0, 0}, {1, 0}};

struct Dom {
  int ny, nx, xcyc;
  // wrap / validate (j, i); returns -1 outside the domain
  __device__ __forceinline__ long idx(int j, int i) const {
    if (i < 0) {
      if (!xcyc) return -1;
      i += nx;
    } else if (i >= nx) {
      if (!xcyc) return -1;
      i -= nx;
    }
    if (j < 0 || j >= ny) return -1;
    return (long)j * nx + i;
  }
};

__device__ __forceinline__ float ldz(const float* __restrict__ a, long k) {
  return k < 0 ? 0.0f : a[k];
}

// limited_gradient of remap_exact.py at one cell: phi[9] / pm[9] are the
// 3x3 neighbourhood values (index (dj+1)*3 + (di+1), zero outside the
// domain); pm[4] is the home mask value.
__device__ __forceinline__ void lim_grad(const float* phi, const float* pm,
                                         float cnx, float cny, float& gxo,
                                         float& gyo) {
  const float ph = phi[4];
  float pmn = ph, pmx = ph;
  float ax_e = 0.f, ax_w = 0.f, ax_n = 0.f, ax_s = 0.f;
  const int order[8][2] = {{1, -1}, {1, 0}, {1, 1}, {0, -1},
                           {0, 1},  {-1, -1}, {-1, 0}, {-1, 1}};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int dj = order[q][0], di = order[q][1];
    const int n = (dj + 1) * 3 + (di + 1);
    const float m = pm[n];
    const float v = m * phi[n] + (1.0f - m) * ph;
    if (dj == 0 && di == 1) ax_e = v;
    if (dj == 0 && di == -1) ax_w = v;
    if (dj == 1 && di == 0) ax_n = v;
    if (dj == -1 && di == 0) ax_s = v;
    pmn = fminf(pmn, v);
    pmx = fmaxf(pmx, v);
  }
  const float gx = (ax_e - ax_w) * 0.5f;
  const float gy = (ax_n - ax_s) * 0.5f;
  pmn = pmn - ph;
  pmx = pmx - ph;
  const float w1 = (0.5f - cnx) * gx + (0.5f - cny) * gy;
  const float w2 = (0.5f - cnx) * gx - (0.5f + cny) * gy;
  const float w3 = -(0.5f + cnx) * gx - (0.5f + cny) * gy;
  const float w4 = (0.5f - cny) * gy - (0.5f + cnx) * gx;
  const float qmn = fminf(fminf(w1, w2), fminf(w3, w4));
  const float qmx = fmaxf(fmaxf(w1, w2), fmaxf(w3, w4));
  const float lim1 = fabsf(qmn) > fabsf(pmn)
                         ? fmaxf(pmn / (qmn != 0.0f ? qmn : 1.0f), 0.0f)
                         : 1.0f;
  const float lim2 = fabsf(qmx) > fabsf(pmx)
                         ? fmaxf(pmx / (qmx != 0.0f ? qmx : 1.0f), 0.0f)
                         : 1.0f;
  const float lim = fminf(lim1, lim2) * pm[4];
  gxo = lim * gx;
  gyo = lim * gy;
}

__device__ __forceinline__ void load9(const float* __restrict__ a,
                                      const long* nb, float* out) {
#pragma unroll
  for (int q = 0; q < 9; ++q) out[q] = ldz(a, nb[q]);
}

// mass reconstruction (construct_fields mass part) at one cell
__device__ __forceinline__ void mass_recon(const float* __restrict__ a,
                                           const float* hm9, const long* nb,
                                           float& mc, float& mx, float& my) {
  float phi[9];
  load9(a, nb, phi);
  lim_grad(phi, hm9, 0.0f, 0.0f, mx, my);
  mc = phi[4];
}

__global__ void transport_kernel(
    const float* __restrict__ trm, const float* __restrict__ am,
    const float* __restrict__ mom_n, const float* __restrict__ mom_e,
    const float* __restrict__ afn, const float* __restrict__ afe,
    const float* __restrict__ tarear, const float* __restrict__ hm,
    const int* __restrict__ ttype, const int* __restrict__ par,
    const int* __restrict__ gpar, const float* __restrict__ lo,
    const float* __restrict__ hi, float* __restrict__ trm_new,
    float* __restrict__ am_pre, int ny, int nx, int xcyc, int NT) {
  extern __shared__ float smem[];
  const int TX = blockDim.x, TY = blockDim.y;
  const int RX = TX + 2, R = RX * (TY + 2);
  const int T = TX * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int c = blockIdx.z;
  const Dom dom{ny, nx, xcyc};
  const long P = (long)ny * nx;

  // shared layout: 6 mass planes, 3*NT tracer planes (tc|tx|ty), R each;
  // then NT*T divergence / unclipped-solution slots
  float* s_mc = smem;
  float* s_mx = smem + R;
  float* s_my = smem + 2 * R;
  float* s_m0c = smem + 3 * R;
  float* s_m0x = smem + 4 * R;
  float* s_m0y = smem + 5 * R;
  float* s_tc = smem + 6 * R;
  float* s_tx = s_tc + (long)NT * R;
  float* s_ty = s_tx + (long)NT * R;
  float* s_div = s_ty + (long)NT * R;

  const float* amc = am + (long)(c + 1) * P;
  const float* am0 = am;
  const float* trc = trm + (long)c * NT * P;

  // ---- phase 1: reconstruction on the tile + 1 ring ------------------
  for (int r = tid; r < R; r += T) {
    const int rj = r / RX, ri = r - rj * RX;
    const int j = j0 - 1 + rj, i = i0 - 1 + ri;
    const long home = dom.idx(j, i);
    if (home < 0) {
      s_mc[r] = s_mx[r] = s_my[r] = 0.f;
      s_m0c[r] = s_m0x[r] = s_m0y[r] = 0.f;
      for (int n = 0; n < NT; ++n)
        s_tc[n * R + r] = s_tx[n * R + r] = s_ty[n * R + r] = 0.f;
      continue;
    }
    long nb[9];
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj)
#pragma unroll
      for (int di = -1; di <= 1; ++di)
        nb[(dj + 1) * 3 + (di + 1)] = dom.idx(j + dj, i + di);
    float hm9[9];
    load9(hm, nb, hm9);

    float mc, mx, my;
    mass_recon(amc, hm9, nb, mc, mx, my);
    s_mc[r] = mc; s_mx[r] = mx; s_my[r] = my;
    if (c == 0) {
      float m0c, m0x, m0y;
      mass_recon(am0, hm9, nb, m0c, m0x, m0y);
      s_m0c[r] = m0c; s_m0x[r] = m0x; s_m0y[r] = m0y;
    }
    const float minv = mc > PUNY ? 1.0f / fmaxf(mc, PUNY) : 0.0f;
    const float mxav = mx * XXAV * minv;
    const float myav = my * XXAV * minv;
    float mm9[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) mm9[q] = ldz(amc, nb[q]) > PUNY ? 1.f : 0.f;

    for (int n = 0; n < NT; ++n) {
      const int tt = ttype[n];
      const float* tn = trc + (long)n * P;
      float phi[9];
      load9(tn, nb, phi);
      if (tt == 1) {
        float gx, gy;
        lim_grad(phi, mm9, mxav, myav, gx, gy);
        s_tc[n * R + r] = phi[4] - gx * mxav - gy * myav;
        s_tx[n * R + r] = gx;
        s_ty[n * R + r] = gy;
      } else if (tt == 2) {
        // centre of (mass*parent tracer): the parent's type-1
        // reconstruction at this cell was written above by this thread
        const int p = par[n];
        const float tcp = s_tc[p * R + r];
        const float w2 = mc * s_tx[p * R + r] + mx * tcp;
        const float w3 = mc * s_ty[p * R + r] + my * tcp;
        const float* tp = trc + (long)p * P;
        const float denom = mc * tp[home];
        const float dinv = fabsf(denom) > PUNY
                               ? 1.0f / (denom != 0.0f ? denom : 1.0f)
                               : 0.0f;
        const float cnx = w2 * XXAV * dinv;
        const float cny = w3 * XXAV * dinv;
        float pm9[9];
#pragma unroll
        for (int q = 0; q < 9; ++q)
          pm9[q] = mm9[q] * (fabsf(ldz(tp, nb[q])) > PUNY ? 1.f : 0.f);
        float gx, gy;
        lim_grad(phi, pm9, cnx, cny, gx, gy);
        s_tc[n * R + r] = phi[4] - gx * cnx - gy * cny;
        s_tx[n * R + r] = gx;
        s_ty[n * R + r] = gy;
      } else {
        s_tc[n * R + r] = phi[4];
        s_tx[n * R + r] = 0.f;
        s_ty[n * R + r] = 0.f;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: fluxes across the 4 edges of this thread's cell ------
  const int j = j0 + threadIdx.y, i = i0 + threadIdx.x;
  if (j >= ny || i >= nx) return;
  const long home = (long)j * nx + i;
  float* dv = s_div + tid;           // slot n at dv[n * T]

  float dm = 0.f, dm0 = 0.f;
  // edges in divergence order: E(j,i) +, E(j,i-1) -, N(j,i) +, N(j-1,i) -
  for (int e = 0; e < 4; ++e) {
    const bool fam_n = e >= 2;
    const int ej = (e == 3) ? j - 1 : j;
    const int ei = (e == 1) ? i - 1 : i;
    const float sgn = (e & 1) ? -1.0f : 1.0f;
    const long ke = dom.idx(ej, ei);
    // region coordinates of the edge's home cell (unwrapped)
    const int rje = ej - j0 + 1, rie = ei - i0 + 1;
    float af = 0.f;
    float C[6][6];
    int dr[6];
    float macc = 0.f, macc0 = 0.f;
    if (ke >= 0) {
      af = fam_n ? afn[ke] : afe[ke];
      const float* mom = fam_n ? mom_n : mom_e;
#pragma unroll
      for (int ci = 0; ci < 6; ++ci) {
        const int dj = fam_n ? OFF_N[ci][0] : OFF_E[ci][0];
        const int di = fam_n ? OFF_N[ci][1] : OFF_E[ci][1];
        const int d = (rje + dj) * RX + (rie + di);
        dr[ci] = d;
        float m[NMOM];
#pragma unroll
        for (int q = 0; q < NMOM; ++q)
          m[q] = mom[((long)ci * NMOM + q) * P + ke];
        // MONO order: 00,10,01,20,11,02,30,21,12,03
        const float mi = s_mc[d], mxi = s_mx[d], myi = s_my[d];
        C[ci][0] = mi * m[0] + mxi * m[1] + myi * m[2];
        C[ci][1] = mi * m[1] + mxi * m[3] + myi * m[4];
        C[ci][2] = mi * m[2] + mxi * m[4] + myi * m[5];
        C[ci][3] = mi * m[3] + mxi * m[6] + myi * m[7];
        C[ci][4] = mi * m[4] + mxi * m[7] + myi * m[8];
        C[ci][5] = mi * m[5] + mxi * m[8] + myi * m[9];
        macc = macc + C[ci][0];
        if (c == 0)
          macc0 = macc0 +
                  (s_m0c[d] * m[0] + s_m0x[d] * m[1] + s_m0y[d] * m[2]);
      }
    }
    const float mfl = (-macc) * af;
    dm = (e == 0) ? mfl : dm + sgn * mfl;
    const float mfl0 = (-macc0) * af;
    dm0 = (e == 0) ? mfl0 : dm0 + sgn * mfl0;

    for (int n = 0; n < NT; ++n) {
      float acc = 0.f;
      if (ke >= 0) {
        const int tt = ttype[n];
        const int p = par[n], g = gpar[n];
#pragma unroll
        for (int ci = 0; ci < 6; ++ci) {
          const int d = dr[ci];
          const float tc = s_tc[n * R + d], tx = s_tx[n * R + d],
                      ty = s_ty[n * R + d];
          float mts;
          if (tt == 1) {
            mts = C[ci][0] * tc + C[ci][1] * tx + C[ci][2] * ty;
          } else {
            const float tcp = s_tc[p * R + d], txp = s_tx[p * R + d],
                        typ = s_ty[p * R + d];
            if (tt == 2) {
              const float s1 = C[ci][0] * tcp + C[ci][1] * txp +
                               C[ci][2] * typ;
              const float s2 = C[ci][1] * tcp + C[ci][3] * txp +
                               C[ci][4] * typ;
              const float s3 = C[ci][2] * tcp + C[ci][4] * txp +
                               C[ci][5] * typ;
              mts = s1 * tc + s2 * tx + s3 * ty;
            } else {
              const float tcg = s_tc[g * R + d], txg = s_tx[g * R + d],
                          tyg = s_ty[g * R + d];
              const float g1 = C[ci][0] * tcg + C[ci][1] * txg +
                               C[ci][2] * tyg;
              const float g2 = C[ci][1] * tcg + C[ci][3] * txg +
                               C[ci][4] * tyg;
              const float g3 = C[ci][2] * tcg + C[ci][4] * txg +
                               C[ci][5] * tyg;
              mts = (g1 * tcp + g2 * txp + g3 * typ) * tc;
            }
          }
          acc = acc + mts;
        }
      }
      const float fl = (-acc) * af;
      dv[n * T] = (e == 0) ? fl : dv[n * T] + sgn * fl;
    }
  }

  // ---- update: mass before the floor, then the new-value chains -------
  const float tar = tarear[home];
  const float am_old = amc[home];
  const float ampre = am_old - dm * tar;
  am_pre[(long)(c + 1) * P + home] = ampre;
  if (c == 0) am_pre[home] = am0[home] - dm0 * tar;
  const bool tmask = hm[home] > 0.5f;
  const float mm = tmask ? fmaxf(ampre, 0.0f) : 0.0f;
  const bool mm_pos = mm > PUNY;

  float* outc = trm_new + (long)c * NT * P;
  for (int n = 0; n < NT; ++n) {
    const int tt = ttype[n];
    const float tn = trc[(long)n * P + home];
    float prod, den;
    bool ok = mm_pos;
    if (tt == 1) {
      prod = am_old * tn;
      den = mm;
    } else if (tt == 2) {
      const int p = par[n];
      prod = am_old * (tn * trc[(long)p * P + home]);
      const float tp = dv[p * T];          // unclipped parent solution
      den = mm * tp;
      ok = ok && fabsf(tp) > PUNY;
    } else {
      const int p = par[n], g = gpar[n];
      prod = am_old * (tn * (trc[(long)p * P + home] *
                             trc[(long)g * P + home]));
      const float tp2 = dv[p * T], gp = dv[g * T];
      den = mm * tp2 * gp;
      ok = ok && fabsf(tp2) > PUNY && fabsf(gp) > PUNY;
    }
    const float num = prod - dv[n * T] * tar;
    const float val = ok ? num / (den != 0.0f ? den : 1.0f) : 0.0f;
    dv[n * T] = val;                       // parents read it unclipped
    outc[(long)n * P + home] = fminf(fmaxf(val, lo[n]), hi[n]);
  }
}

}  // namespace

// Shared-memory bytes one block of (tx, ty) threads needs for NT tracers.
extern "C" long transport_smem_bytes(int tx, int ty, int NT) {
  const long R = (long)(tx + 2) * (ty + 2);
  return 4L * ((6L + 3L * NT) * R + (long)NT * tx * ty);
}

// One fused transport pass. Shapes (all f32 / int32 contiguous on the
// device): trm (ncat, NT, ny, nx); am (ncat+1, ny, nx); mom_n, mom_e
// (6, 10, ny, nx); afn, afe, tarear, hm (ny, nx); ttype, par, gpar (NT)
// int32; lo, hi (NT) f32. Outputs trm_new (ncat, NT, ny, nx) and am_pre
// (ncat+1, ny, nx). Returns the launch's CUDA error (0 = success).
extern "C" int transport_fused(const float* trm, const float* am,
                               const float* mom_n, const float* mom_e,
                               const float* afn, const float* afe,
                               const float* tarear, const float* hm,
                               const int* ttype, const int* par,
                               const int* gpar, const float* lo,
                               const float* hi, float* trm_new, float* am_pre,
                               int ncat, int NT, int ny, int nx, int xcyc,
                               int tx, int ty, void* stream) {
  const long smem = transport_smem_bytes(tx, ty, NT);
  cudaError_t e = cudaFuncSetAttribute(
      transport_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(tx, ty);
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty, ncat);
  transport_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      trm, am, mom_n, mom_e, afn, afe, tarear, hm, ttype, par, gpar, lo, hi,
      trm_new, am_pre, ny, nx, xcyc, NT);
  return (int)cudaGetLastError();
}
