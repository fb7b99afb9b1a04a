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
// (construct_fields -> fluxes_from_moments -> update_pre_floor), built with
// -fmad=false, so that path is its reference bit for bit.
//
// What bounds it on the H100: one call must read the tracer stack
// (ncat*NT planes), the mass (ncat+1 planes), the 120 moment planes and 4
// grid planes, and write ncat*NT + ncat + 1 planes: ~190 MB at gx1 with
// NT=25, 57 us at 3.35 TB/s. Its arithmetic (reconstruction, 2 edges x 6
// candidates x the chain sums per tracer, the update) is ~5.7 GFLOP where
// every candidate of every edge counts, 85 us at the f32 peak (which
// counts a fused multiply-add as two while this kernel issues multiplies
// and adds apart). Most candidates do not count: the swept region of an
// edge touches one or two of its 6 donor cells, none where the ice stands
// still, and then bytes bound the call. So the design does each operation
// once, does none that adds an exact zero, and asks the memory early.
//
// Design: one block per (2-D tile, category), one THREAD PER EDGE the tile
// owns: the east and north edge of every cell, plus the west edges of the
// first column and the south edges of the first row, so that every flux of
// the tile is computed once by the block (32x8 cells: 264 E + 288 N edges,
// 18 warps). An edge's 36 mass-moment sums C[6][6] do not depend on the
// tracer: its thread computes them once and keeps them in registers while
// the tracers go by. A candidate whose 10 moments are all zero adds exact
// zeros to every sum (for finite fields) and is left out, and only cells
// that donate through a candidate that counts get their tracers
// reconstructed (a list in shared memory). Tracers go by in CHUNKS that
// follow the dependency chains of the flat table: a chunk holds up to B
// reconstructions, its own tracers plus the parents and grandparents they
// need, so shared memory holds one chunk and not all NT. The schedule and
// the table come as one small int array that each block copies to shared
// memory. Per chunk: (a) all threads reconstruct (needed cell, tracer)
// pairs on the tile plus a one-cell ring into shared memory, type-2
// tracers after their parents; (b) every edge thread writes its flux of
// each tracer of the chunk to shared memory; (c) groups of TX*TY threads,
// one per cell, form the divergence E(j,i) - E(j,i-1) + N(j,i) - N(j-1,i)
// in that order and solve the new-value chains, one chain type after the
// other; a tracer with dependents leaves its unclipped new value in a slot
// of shared memory for them. The block first asks the L2 for the rows of
// moments and tracers that phases 1 and (c) will wait for. Any NT runs
// without code generation. Nothing is allocated here; the launch goes on
// the caller's stream.
//
// Boundaries: east-west cyclic or zero ghost; north-south zero ghost
// (open/closed), matching the zero-ghost `shift` of the plain path.

#include <cuda_runtime.h>

namespace {

constexpr float PUNY = 1.0e-11f;
constexpr float XXAV = (float)(1.0 / 12.0);
constexpr int NMOM = 10;
constexpr int MAX_THREADS = 576;      // the 32x8 tile's edges, warp-padded
// donor offsets (dj, di) per candidate, in remap_exact.CANDS order
__constant__ int OFF_N[6][2] = {{1, -1}, {1, 0}, {1, 1},
                                {0, -1}, {0, 0}, {0, 1}};
__constant__ int OFF_E[6][2] = {{-1, 1}, {0, 1}, {1, 1},
                                {-1, 0}, {0, 0}, {1, 0}};

// The chunk schedule and the flat table, packed by kernels/remap.py
// `pack_schedule` into one int array that every block copies to shared
// memory first (the loops below read it at every turn):
//   [0, 4*nent)          per entry: tracer, own | type << 1, the slots of
//                        its parent's and grandparent's reconstructions in
//                        the same chunk (-1: none)
//   [o_upd, ...)         per chunk the slots of the entries it fluxes and
//                        updates, sorted by chain type
//   [o_chk, +8*nch)      per chunk: first entry, entries, entries of type 1
//                        or 3 (they come first), and the 4 bounds of its
//                        types 1, 2, 3 in the list above
//   [o_trc, +4*NT)       per tracer: type, parent, grandparent, the slot
//                        that keeps its unclipped new value (-1: none)
//   [o_lohi, +2*NT)      per tracer: the lo and hi rails (float bits)
struct Sched {
  const int* packed;
  int n, o_upd, o_chk, o_trc, o_lohi, nch, B, nslots;
};

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
  __device__ __forceinline__ void nbrs(int j, int i, long* nb) const {
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj)
#pragma unroll
      for (int di = -1; di <= 1; ++di)
        nb[(dj + 1) * 3 + (di + 1)] = idx(j + dj, i + di);
  }
};

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

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

__global__ void __launch_bounds__(MAX_THREADS) transport_kernel(
    const float* __restrict__ trm, const float* __restrict__ am,
    const float* __restrict__ mom_n, const float* __restrict__ mom_e,
    const float* __restrict__ afn, const float* __restrict__ afe,
    const float* __restrict__ tarear, const float* __restrict__ hm,
    Sched sc, float* __restrict__ trm_new, float* __restrict__ am_pre, int ny,
    int nx, int xcyc, int NT, int TX, int TY) {
  extern __shared__ __align__(16) float smem_all[];
  const int RX = TX + 2, R = RX * (TY + 2);
  const int T = TX * TY;
  const int NE = TY * (TX + 1), NEP = (NE + 31) & ~31;
  const int NN = (TY + 1) * TX;
  const int NEDGE = blockDim.x;        // NEP + NN padded to a warp
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int c = blockIdx.z;
  const Dom dom{ny, nx, xcyc};
  const long P = (long)ny * nx;

  // shared layout: the packed schedule; 6 mass planes on the ring tile (R
  // cells); the chunk's
  // B reconstructions, 3 planes each (tc, tx, ty); the chunk's B fluxes per
  // edge (first the two mass fluxes); the unclipped new values kept for
  // dependents, T each; 3 per-cell values; the list of ring cells whose
  // reconstruction some flux needs
  int* s_sch = reinterpret_cast<int*>(smem_all);
  const int4* s_ent = reinterpret_cast<const int4*>(s_sch);
  const int4* s_trc = reinterpret_cast<const int4*>(s_sch + sc.o_trc);
  float* smem = smem_all + sc.n;
  float* s_mc = smem;
  float* s_mx = smem + R;
  float* s_my = smem + 2 * R;
  float* s_m0c = smem + 3 * R;
  float* s_m0x = smem + 4 * R;
  float* s_m0y = smem + 5 * R;
  float* s_rec = smem + 6 * R;
  float* s_fl = s_rec + (long)3 * sc.B * R;
  float* s_val = s_fl + (long)sc.B * NEDGE;
  float* s_tar = s_val + (long)sc.nslots * T;    // per cell: tarear,
  float* s_old = s_tar + T;                       // the old mass,
  float* s_mm = s_old + T;                        // the new floored mass
  int* s_list = reinterpret_cast<int*>(s_mm + T); // the needed ring cells
  int* s_need = s_list + R;                       // ... and their flags
  __shared__ int s_nneed;

  const float* amc = am + (long)(c + 1) * P;
  const float* am0 = am;
  const float* trc = trm + (long)c * NT * P;

  // ---- this thread's edge: E family first, then N, each warp-padded ----
  const bool fam_n = tid >= NEP;
  const int e = fam_n ? tid - NEP : tid;
  const bool edge_on = e < (fam_n ? NN : NE);
  // tile coordinates of the edge's home cell: -1 is the ring
  const int elj = fam_n ? e / TX - 1 : e / (TX + 1);
  const int eli = fam_n ? e - (elj + 1) * TX : e - elj * (TX + 1) - 1;
  const long ke = edge_on ? dom.idx(j0 + elj, i0 + eli) : -1;
  const int rbase = (elj + 1) * RX + (eli + 1);
  int doff[6];
#pragma unroll
  for (int ci = 0; ci < 6; ++ci)
    doff[ci] = fam_n ? OFF_N[ci][0] * RX + OFF_N[ci][1]
                     : OFF_E[ci][0] * RX + OFF_E[ci][1];

  if (tid == 0) s_nneed = 0;
  for (int q = tid; q < sc.n; q += NEDGE) s_sch[q] = sc.packed[q];
  // ask the L2 now for the rows that the later phases wait for: the
  // moments of the tile's edges (phase 1) and its tracers (phase c); both
  // ends of a row, which may lie in two lines
  if (i0 < nx) {
    const int last = min(TX, nx - i0) - 1;
    for (int q = tid; q < 2 * 6 * NMOM * (TY + 1); q += NEDGE) {
      const int row = q % (TY + 1), pl = q / (TY + 1);
      const long k = dom.idx(j0 - 1 + row, i0);
      if (k < 0) continue;
      const float* a = (pl < 6 * NMOM ? mom_n + (long)pl * P
                                      : mom_e + (long)(pl - 6 * NMOM) * P) + k;
      prefetch_l2(a);
      prefetch_l2(a + last);
    }
    for (int q = tid; q < NT * TY; q += NEDGE) {
      const int row = q % TY, n = q / TY;
      if (j0 + row >= ny) continue;
      const float* a = trc + (long)n * P + (long)(j0 + row) * nx + i0;
      prefetch_l2(a);
      prefetch_l2(a + last);
    }
  }

  // ---- phase 0: mass reconstruction on the tile + 1 ring ---------------
  for (int r = tid; r < R; r += NEDGE) {
    const int rj = r / RX, ri = r - rj * RX;
    const int jr = j0 - 1 + rj, ir = i0 - 1 + ri;
    s_need[r] = 0;
    if (dom.idx(jr, ir) < 0) {
      s_mc[r] = s_mx[r] = s_my[r] = 0.f;
      s_m0c[r] = s_m0x[r] = s_m0y[r] = 0.f;
      continue;
    }
    long nb[9];
    dom.nbrs(jr, ir, nb);
    float hm9[9];
    load9(hm, nb, hm9);
    float mc, mx, my;
    mass_recon(amc, hm9, nb, mc, mx, my);
    s_mc[r] = mc; s_mx[r] = mx; s_my[r] = my;
    if (c == 0) {
      mass_recon(am0, hm9, nb, mc, mx, my);
      s_m0c[r] = mc; s_m0x[r] = mx; s_m0y[r] = my;
    }
  }
  __syncthreads();

  // ---- phase 1: the edge's moment sums, kept; the mass fluxes ----------
  // A candidate all of whose 10 moments are zero (the swept region does not
  // touch that donor cell: most candidates of most edges) adds exact zeros
  // to every sum, so it is left out: `active` has a bit per candidate that
  // counts, and only the donors of those need their reconstruction.
  float af = 0.f;
  float C[6][6];
  unsigned active = 0;
  {
    float macc = 0.f, macc0 = 0.f;
    const float* mom = (fam_n ? mom_n : mom_e) + (ke >= 0 ? ke : 0);
    if (ke >= 0) {
      af = fam_n ? afn[ke] : afe[ke];
      // first only which candidates count: 60 loads in flight at once
#pragma unroll
      for (int ci = 0; ci < 6; ++ci) {
        bool act = false;
#pragma unroll
        for (int q = 0; q < NMOM; ++q)
          act |= mom[((long)ci * NMOM + q) * P] != 0.0f;
        active |= (act ? 1u : 0u) << ci;
      }
    }
#pragma unroll
    for (int ci = 0; ci < 6; ++ci) {
      if (active >> ci & 1) {
        const int d = rbase + doff[ci];
        s_need[d] = 1;
        float m[NMOM];
#pragma unroll
        for (int q = 0; q < NMOM; ++q) m[q] = mom[((long)ci * NMOM + q) * P];
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
      } else {
#pragma unroll
        for (int q = 0; q < 6; ++q) C[ci][q] = 0.f;
      }
    }
    s_fl[tid] = (-macc) * af;
    s_fl[NEDGE + tid] = (-macc0) * af;
  }
  __syncthreads();

  // ---- phase 2: mass before the floor, one thread per cell; the list of
  // the ring cells to reconstruct --------------------------------------
  if (tid < T) {
    const int clj = tid / TX, cli = tid - clj * TX;
    const int j = j0 + clj, i = i0 + cli;
    float tar = 0.f, am_old = 0.f, mm = 0.f;
    if (j < ny && i < nx) {
      const long home = (long)j * nx + i;
      const int fe = clj * (TX + 1) + cli + 1, fw = fe - 1;
      const int fn = NEP + (clj + 1) * TX + cli, fs = fn - TX;
      tar = tarear[home];
      am_old = amc[home];
      const float dm = s_fl[fe] - s_fl[fw] + s_fl[fn] - s_fl[fs];
      const float ampre = am_old - dm * tar;
      am_pre[(long)(c + 1) * P + home] = ampre;
      if (c == 0) {
        const float* f0 = s_fl + NEDGE;
        const float dm0 = f0[fe] - f0[fw] + f0[fn] - f0[fs];
        am_pre[home] = am0[home] - dm0 * tar;
      }
      mm = hm[home] > 0.5f ? fmaxf(ampre, 0.0f) : 0.0f;
    }
    s_tar[tid] = tar;
    s_old[tid] = am_old;
    s_mm[tid] = mm;
  }
  for (int r = tid; r < R; r += NEDGE)
    if (s_need[r]) s_list[atomicAdd(&s_nneed, 1)] = r;
  float* outc = trm_new + (long)c * NT * P;
  __syncthreads();
  const int nneed = s_nneed;

  // for phase (c) the threads form groups of T, a thread per cell in each;
  // a group takes every ngrp-th tracer, so a warp works on one tracer and
  // a thread keeps its cell's numbers: its 4 flux slots (E own, E of the
  // west cell, N own, N of the south cell), old and new mass
  const int ngrp = NEDGE / T, grp = tid / T;
  const int cell = tid - grp * T;
  const int clj = cell / TX, cli = cell - clj * TX;
  const bool cell_on = grp < ngrp && j0 + clj < ny && i0 + cli < nx;
  const long home = (long)(j0 + clj) * nx + (i0 + cli);
  const int fe = clj * (TX + 1) + cli + 1, fw = fe - 1;
  const int fn = NEP + (clj + 1) * TX + cli, fs = fn - TX;
  const float tar = s_tar[cell], am_old = s_old[cell], mm = s_mm[cell];

  for (int ch = 0; ch < sc.nch; ++ch) {
    const int* ck = s_sch + sc.o_chk + 8 * ch;
    const int e0 = ck[0], ne = ck[1], nw1 = ck[2];
    const int* upd = s_sch + sc.o_upd;

    // ---- (a) reconstruction of (needed ring cell, entry) pairs: first
    // the entries of type 1 and 3, then those of type 2, whose parents'
    // are then in place --------------------------------------------------
    for (int wave = 0; wave < 2; ++wave) {
      const int s0 = wave ? nw1 : 0, ns = wave ? ne - nw1 : nw1;
      for (int it = tid; it < ns * nneed; it += NEDGE) {
        const int s = s0 + it / nneed, r = s_list[it - (it / nneed) * nneed];
        float* rc = s_rec + (long)3 * s * R + r;     // tc; tx, ty at +R, +2R
        const int rj = r / RX, ri = r - rj * RX;
        const int jr = j0 - 1 + rj, ir = i0 - 1 + ri;
        const long hr = dom.idx(jr, ir);
        if (hr < 0) {                  // an active candidate off the domain
          rc[0] = rc[R] = rc[2 * R] = 0.f;
          continue;
        }
        const int4 en = s_ent[e0 + s];
        const int n = en.x, tt = en.y >> 1;
        const float* tn = trc + (long)n * P;
        if (tt == 3) {
          rc[0] = tn[hr];
          rc[R] = rc[2 * R] = 0.f;
          continue;
        }
        long nb[9];
        dom.nbrs(jr, ir, nb);
        float mm9[9];
#pragma unroll
        for (int q = 0; q < 9; ++q)
          mm9[q] = ldz(amc, nb[q]) > PUNY ? 1.f : 0.f;
        float phi[9];
        load9(tn, nb, phi);
        const float mc = s_mc[r], mx = s_mx[r], my = s_my[r];
        float gx, gy;
        if (tt == 1) {
          const float minv = mc > PUNY ? 1.0f / fmaxf(mc, PUNY) : 0.0f;
          const float mxav = mx * XXAV * minv;
          const float myav = my * XXAV * minv;
          lim_grad(phi, mm9, mxav, myav, gx, gy);
          rc[0] = phi[4] - gx * mxav - gy * myav;
        } else {
          // centre of (mass * parent tracer), from the parent's type-1
          // reconstruction at this cell
          const float* rp = s_rec + (long)3 * en.z * R + r;
          const float tcp = rp[0];
          const float w2 = mc * rp[R] + mx * tcp;
          const float w3 = mc * rp[2 * R] + my * tcp;
          const float* tp = trc + (long)s_trc[n].y * P;
          const float denom = mc * tp[hr];
          const float dinv = fabsf(denom) > PUNY
                                 ? 1.0f / (denom != 0.0f ? denom : 1.0f)
                                 : 0.0f;
          const float cnx = w2 * XXAV * dinv;
          const float cny = w3 * XXAV * dinv;
#pragma unroll
          for (int q = 0; q < 9; ++q)
            mm9[q] = mm9[q] * (fabsf(ldz(tp, nb[q])) > PUNY ? 1.f : 0.f);
          lim_grad(phi, mm9, cnx, cny, gx, gy);
          rc[0] = phi[4] - gx * cnx - gy * cny;
        }
        rc[R] = gx;
        rc[2 * R] = gy;
      }
      __syncthreads();
    }

    // ---- (b) this edge's flux of every tracer the chunk owns -----------
    if (!active) {
      // no candidate counts (still ice, open water, land): the flux of
      // every tracer is the same signed zero
      const float fl0 = (-0.f) * af;
#pragma unroll 4
      for (int k = ck[3]; k < ck[6]; ++k)
        s_fl[(long)upd[k] * NEDGE + tid] = fl0;
    } else {
      for (int k = ck[3]; k < ck[6]; ++k) {
        const int s = upd[k];
        const int4 en = s_ent[e0 + s];
        const int tt = en.y >> 1;
        const float* rt = s_rec + (long)3 * s * R + rbase;
        const float* rp = s_rec + (long)3 * max(en.z, 0) * R + rbase;
        const float* rg = s_rec + (long)3 * max(en.w, 0) * R + rbase;
        float acc = 0.f;
#pragma unroll
        for (int ci = 0; ci < 6; ++ci) {
          if (!(active >> ci & 1)) continue;
          const int d = doff[ci];
          const float tc = rt[d], tx = rt[R + d], ty = rt[2 * R + d];
          float mts;
          if (tt == 1) {
            mts = C[ci][0] * tc + C[ci][1] * tx + C[ci][2] * ty;
          } else {
            const float tcp = rp[d], txp = rp[R + d], typ = rp[2 * R + d];
            if (tt == 2) {
              const float s1 = C[ci][0] * tcp + C[ci][1] * txp +
                               C[ci][2] * typ;
              const float s2 = C[ci][1] * tcp + C[ci][3] * txp +
                               C[ci][4] * typ;
              const float s3 = C[ci][2] * tcp + C[ci][4] * txp +
                               C[ci][5] * typ;
              mts = s1 * tc + s2 * tx + s3 * ty;
            } else {
              const float tcg = rg[d], txg = rg[R + d], tyg = rg[2 * R + d];
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
        s_fl[(long)s * NEDGE + tid] = (-acc) * af;
      }
    }
    __syncthreads();

    // ---- (c) divergence and the new-value chains of (cell, entry)
    // pairs, one chain type after the other: a parent's unclipped value is
    // in its slot before a dependent reads it ----------------------------
    for (int wave = 1; wave <= 3; ++wave) {
      const int u0 = ck[2 + wave], nu = ck[3 + wave] - u0;
      if (nu == 0) continue;
      if (cell_on) {
#pragma unroll 2
        for (int k = grp; k < nu; k += ngrp) {
          const int s = upd[u0 + k];
          const int n = s_ent[e0 + s].x;
          const int4 ti = s_trc[n];    // type, parent, grandparent, slot
          const float* f = s_fl + (long)s * NEDGE;
          const float dv = f[fe] - f[fw] + f[fn] - f[fs];
          const float tn = trc[(long)n * P + home];
          float prod, den;
          bool ok = mm > PUNY;
          if (wave == 1) {
            prod = am_old * tn;
            den = mm;
          } else if (wave == 2) {
            prod = am_old * (tn * trc[(long)ti.y * P + home]);
            const float tp = s_val[s_trc[ti.y].w * T + cell];
            den = mm * tp;
            ok = ok && fabsf(tp) > PUNY;
          } else {
            prod = am_old * (tn * (trc[(long)ti.y * P + home] *
                                   trc[(long)ti.z * P + home]));
            const float tp2 = s_val[s_trc[ti.y].w * T + cell];
            const float gp = s_val[s_trc[ti.z].w * T + cell];
            den = mm * tp2 * gp;
            ok = ok && fabsf(tp2) > PUNY && fabsf(gp) > PUNY;
          }
          const float num = prod - dv * tar;
          const float val = ok ? num / (den != 0.0f ? den : 1.0f) : 0.0f;
          if (ti.w >= 0) s_val[ti.w * T + cell] = val;
          const float lo = __int_as_float(s_sch[sc.o_lohi + 2 * n]);
          const float hi = __int_as_float(s_sch[sc.o_lohi + 2 * n + 1]);
          // fminf / fmaxf drop a NaN operand: a NaN stays one, as it does
          // through the plain version's clamp
          outc[(long)n * P + home] =
              val != val ? val : fminf(fmaxf(val, lo), hi);
        }
      }
      __syncthreads();
    }
  }
}

// Threads of one block with a (tx, ty) tile: one per owned edge, each
// family padded to whole warps.
__host__ int transport_threads(int tx, int ty) {
  const int nep = (ty * (tx + 1) + 31) & ~31;
  const int nnp = ((ty + 1) * tx + 31) & ~31;
  return nep + nnp;
}

}  // namespace

// Shared-memory bytes one block of a (tx, ty) tile needs for chunks of B
// reconstructions, nslots kept values and a packed schedule of nsched ints.
extern "C" long transport_smem_bytes(int tx, int ty, int B, int nslots,
                                     int nsched) {
  const long R = (long)(tx + 2) * (ty + 2);
  return 4L * (nsched + 6L * R + 3L * B * R +
               (long)B * transport_threads(tx, ty) +
               (long)(nslots + 3) * tx * ty + 2L * R);
}

// info[0] registers per thread of the kernel, info[1] its static shared
// memory, info[2] the most threads a block of it may have, info[3] blocks
// of (tx, ty) tiles resident per SM with the given dynamic shared memory.
extern "C" int transport_info(int tx, int ty, long smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncSetAttribute(
      transport_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncGetAttributes(&attr, transport_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, transport_kernel, transport_threads(tx, ty), (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = attr.maxThreadsPerBlock;
  info[3] = per_sm;
  return 0;
}

// One fused transport pass. Shapes (all f32 contiguous on the device): trm
// (ncat, NT, ny, nx); am (ncat+1, ny, nx); mom_n, mom_e (6, 10, ny, nx);
// afn, afe, tarear, hm (ny, nx); sched the packed schedule (int32, on the
// device) and layout its 8 numbers in Sched order (n, o_upd, o_chk, o_trc,
// o_lohi, nch, B, nslots; B >= 2) in host memory. Outputs trm_new (ncat,
// NT, ny, nx) and am_pre (ncat+1, ny, nx). Returns the launch's CUDA error
// (0 = success).
extern "C" int transport_fused(const float* trm, const float* am,
                               const float* mom_n, const float* mom_e,
                               const float* afn, const float* afe,
                               const float* tarear, const float* hm,
                               const int* sched, const int* layout,
                               float* trm_new, float* am_pre, int ncat, int NT,
                               int ny, int nx, int xcyc, int tx, int ty,
                               void* stream) {
  const Sched sc{sched,     layout[0], layout[1], layout[2], layout[3],
                 layout[4], layout[5], layout[6], layout[7]};
  const long smem = transport_smem_bytes(tx, ty, sc.B, sc.nslots, sc.n);
  cudaError_t e = cudaFuncSetAttribute(
      transport_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(transport_threads(tx, ty));
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty, ncat);
  transport_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      trm, am, mom_n, mom_e, afn, afe, tarear, hm, sc, trm_new, am_pre, ny,
      nx, xcyc, NT, tx, ty);
  return (int)cudaGetLastError();
}
