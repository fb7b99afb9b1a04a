// B-grid EVP solve for NVIDIA Hopper (sm_90a), f32: the ndte subcycles, the
// masking of the incoming stresses and the final force diagnostics.
//
// Replaces the TPU kernel cice_tpu/kernels/evp_pallas.py
// (`evp_solve_fused` -> `_chunk_call`, pallas_call at line 184). Each
// subcycle is one `stress_update` (4-corner bilinear strain rates,
// viscosities and replacement pressure, elastic relaxation, 8
// stress-divergence terms per T cell) and one `stepu_dense` (implicit
// Coriolis / water-drag momentum solve at U points); after the last one the
// tail takes one more stress pass at the final velocity, without keeping its
// stresses, for (strintx, strinty), and the seabed stress. The arithmetic
// mirrors cice_tpu_torch/dynamics/evp.py expression by expression (built
// with -fmad=false), so the plain PyTorch `evp_solve` is its reference, bit
// for bit.
//
// What bounds it on the H100: a solve reads 26 constant and 14 state planes
// and writes 18, a few MB, for ~470 flops per cell and subcycle (7.0 GFLOP
// at gx1 with ndte=120): it is bound by operations, ~0.10 ms at the f32
// peak. That peak counts a fused multiply-add as two; this kernel issues
// multiplies and adds apart, and with the IEEE square roots and divides,
// the shared-memory traffic and the address arithmetic a T cell costs ~770
// instructions and a U cell ~200 per subcycle, so the card's issue rate
// puts the floor of a gx1 subcycle near 4.5 us. Above that lie latencies:
// of launches, of memory, of the barrier between subcycles.
//
// Route `persistent` (the design for grids that fit the card): one
// cooperative launch, one block of 1024 threads per tile, all blocks
// resident, one thread per T cell. A block keeps in shared memory, for all
// ndte subcycles, the 12 stresses, the 8 stress-divergence terms and the
// 10 T-cell constants on its tile plus one row north and one column east,
// the 14 U-cell constants on its tile, and u, v on its tile plus a one-cell
// ring. The dependency cone of a subcycle is T(j,i) <- u,v(j-1..j, i-1..i)
// and U(j,i) <- str(j..j+1, i..i+1), so with the extra row and column of
// stresses (the same arithmetic as their owner's, hence the same bits) a
// block needs from its 8 neighbours only the ring of u, v, once per
// subcycle. After the U step a block writes its perimeter u, v to a global
// buffer (two copies, taken in turn by subcycle parity, so one barrier per
// subcycle is enough) and all blocks meet at a barrier on a global counter
// (one release-add and acquire-loads by one thread, between two block
// barriers). In the next T pass the cells on the tile's rim, which the
// first warps hold, read their ring corners from that buffer past the L1
// while the other warps compute. What only one thread touches lies in
// shared memory at its thread index with a constant stride, so the loop
// has no index arithmetic and no division. Planes are read where they lie
// (a struct of pointers, bool masks as bytes); only the owner of a cell
// writes it out.
//
// Route `stream` (grids too large to be resident): the same cell functions
// in one T-cell and one U-cell kernel per subcycle, state in global memory,
// plus one kernel that loads and masks and the two tail kernels. Its
// launches alone take most of its time.
//
// Boundaries: east-west cyclic or zero ghost; north-south zero ghost
// (open/closed). Tripole and y-cyclic grids are rejected by the wrapper.

#include <cuda_runtime.h>

namespace {

// input planes, in cice_tpu_torch/kernels/evp.py CONST_PLANES order
enum {
  C_DXT, C_DYT, C_CXM, C_CXP, C_CYM, C_CYP, C_DXHY, C_DYHX, C_UAREAR,
  C_ICETMASK, C_ICEUMASK, C_AIU, C_UMASSDTI, C_FM, C_WATERX, C_WATERY,
  C_FORCEX, C_FORCEY, C_UVEL_INIT, C_VVEL_INIT, C_CW, C_TBU, C_STRENGTH,
  C_DMINTAREA, C_UOCN, C_VOCN, N_CONST
};
// output planes: u, v, stressp[4], stressm[4], stress12[4], then the tail
enum { S_U = 0, S_V = 1, S_SP = 2, S_STRINTX = 14, S_STRINTY = 15,
       S_TAUBX = 16, S_TAUBY = 17, N_OUT = 18 };

// every plane of one solve where it lies: f32 (ny, nx) contiguous, the two
// masks one byte per cell; u0/v0 the incoming velocity, s_in the incoming
// stressp, stressm, stress12 as (4, ny, nx) each
struct Planes {
  const void* c[N_CONST];
  const float* u0;
  const float* v0;
  const float* s_in[3];
};

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

// the T-cell constants of stress_cell, in this order in shared memory
enum { TC_DXT, TC_DYT, TC_CXM, TC_CXP, TC_CYM, TC_CYP, TC_DXHY, TC_DYHX,
       TC_STRENGTH, TC_DMIN, N_TC };
__host__ __device__ constexpr int t_const(int q) {
  constexpr int T[N_TC] = {C_DXT, C_DYT, C_CXM, C_CXP, C_CYM, C_CYP,
                           C_DXHY, C_DYHX, C_STRENGTH, C_DMINTAREA};
  return T[q];
}
// the U-cell constants of stepu_cell
enum { UC_UAREAR, UC_AIU, UC_UMASSDTI, UC_FM, UC_WATERX, UC_WATERY,
       UC_FORCEX, UC_FORCEY, UC_UINIT, UC_VINIT, UC_CW, UC_TBU, UC_UOCN,
       UC_VOCN, N_UC };
__host__ __device__ constexpr int u_const(int q) {
  constexpr int U[N_UC] = {C_UAREAR, C_AIU, C_UMASSDTI, C_FM, C_WATERX,
                           C_WATERY, C_FORCEX, C_FORCEY, C_UVEL_INIT,
                           C_VVEL_INIT, C_CW, C_TBU, C_UOCN, C_VOCN};
  return U[q];
}

__device__ __forceinline__ const float* fplane(const Planes& pl, int c) {
  return static_cast<const float*>(pl.c[c]);
}
__device__ __forceinline__ const unsigned char* bplane(const Planes& pl,
                                                       int c) {
  return static_cast<const unsigned char*>(pl.c[c]);
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

// One T cell of `stress_update`: tc its 10 constants (TC_* order), icet its
// mask, (u, v) at its NE corner and the W, S, SW corners; s the 12 corner
// stresses (stressp, stressm, stress12 x NE, NW, SW, SE), relaxed in
// place; str the 8 stress-divergence terms of the relaxed stresses.
__device__ __forceinline__ void stress_cell(
    const Params& p, const float (&tc)[N_TC], bool icet, float u, float v,
    float uw, float vw, float us, float vs, float usw, float vsw,
    float (&s)[12], float (&str)[8]) {
  const float dxT = tc[TC_DXT], dyT = tc[TC_DYT];
  const float cxm = tc[TC_CXM], cxp = tc[TC_CXP];
  const float cym = tc[TC_CYM], cyp = tc[TC_CYP];
  const float dxhy = tc[TC_DXHY], dyhx = tc[TC_DYHX];

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

  const float strength = tc[TC_STRENGTH], dmin = tc[TC_DMIN];
  float zne, ene, rne, znw, enw, rnw, zsw, esw, rsw, zse, ese, rse;
  visc(p, strength, dmin, Deltane, zne, ene, rne);
  visc(p, strength, dmin, Deltanw, znw, enw, rnw);
  visc(p, strength, dmin, Deltasw, zsw, esw, rsw);
  visc(p, strength, dmin, Deltase, zse, ese, rse);

#define RELAX(old, target) \
  (icet ? ((old) * p.c1m + p.arlx1i * (target)) * p.denom1 : (old))
  const float sp1 = RELAX(s[0], zne * divune - rne);
  const float sp2 = RELAX(s[1], znw * divunw - rnw);
  const float sp3 = RELAX(s[2], zsw * divusw - rsw);
  const float sp4 = RELAX(s[3], zse * divuse - rse);
  const float sm1 = RELAX(s[4], ene * tensionne);
  const float sm2 = RELAX(s[5], enw * tensionnw);
  const float sm3 = RELAX(s[6], esw * tensionsw);
  const float sm4 = RELAX(s[7], ese * tensionse);
  const float s121 = RELAX(s[8], P5 * ene * shearne);
  const float s122 = RELAX(s[9], P5 * enw * shearnw);
  const float s123 = RELAX(s[10], P5 * esw * shearsw);
  const float s124 = RELAX(s[11], P5 * ese * shearse);
#undef RELAX
  s[0] = sp1; s[1] = sp2; s[2] = sp3; s[3] = sp4;
  s[4] = sm1; s[5] = sm2; s[6] = sm3; s[7] = sm4;
  s[8] = s121; s[9] = s122; s[10] = s123; s[11] = s124;

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
  str[0] = -strp - strm - str12ew + dxhy * (-csigpne + csigmne) +
           dyhx * csig12ne;
  str[1] = strp + strm - str12we + dxhy * (-csigpnw + csigmnw) +
           dyhx * csig12nw;
  strp = P25 * dyT * (P333 * ssigps + P166 * ssigpn);
  strm = P25 * dyT * (P333 * ssigms + P166 * ssigmn);
  str[2] = -strp - strm + str12ew + dxhy * (-csigpse + csigmse) +
           dyhx * csig12se;
  str[3] = strp + strm + str12we + dxhy * (-csigpsw + csigmsw) +
           dyhx * csig12sw;

  strp = P25 * dxT * (P333 * ssigpe + P166 * ssigpw);
  strm = P25 * dxT * (P333 * ssigme + P166 * ssigmw);
  str[4] = -strp + strm - str12ns - dyhx * (csigpne + csigmne) +
           dxhy * csig12ne;
  str[5] = strp - strm - str12sn - dyhx * (csigpse + csigmse) +
           dxhy * csig12se;
  strp = P25 * dxT * (P333 * ssigpw + P166 * ssigpe);
  strm = P25 * dxT * (P333 * ssigmw + P166 * ssigme);
  str[6] = -strp + strm + str12ns - dyhx * (csigpnw + csigmnw) +
           dxhy * csig12nw;
  str[7] = strp - strm + str12sn - dyhx * (csigpsw + csigmsw) +
           dxhy * csig12sw;
}

// One U cell of `stepu_dense`: uc its 14 constants (UC_* order), iceu its
// mask, (sx, sy) the gathered stress-divergence sums of the 4 T cells that
// share it; (u, v) stepped in place.
__device__ __forceinline__ void stepu_cell(const Params& p,
                                           const float (&uc)[N_UC], bool iceu,
                                           float sx, float sy, float& u,
                                           float& v) {
  const float strintx = uc[UC_UAREAR] * sx;
  const float strinty = uc[UC_UAREAR] * sy;
  const float uold = u, vold = v;
  const float aiU = uc[UC_AIU], umassdti = uc[UC_UMASSDTI];
  const float fm = uc[UC_FM];
  const float du = uc[UC_UOCN] - uold, dv = uc[UC_VOCN] - vold;
  const float vrel = aiU * p.rhow * uc[UC_CW] * sqrtf(du * du + dv * dv);
  const float taux = vrel * uc[UC_WATERX];
  const float tauy = vrel * uc[UC_WATERY];
  const float Cb = uc[UC_TBU] / (sqrtf(uold * uold + vold * vold) + p.u0);
  const float cca = p.brlx_p_revp * umassdti + vrel * p.cosw + Cb;
  const float fmn = (fm == 0.0f) ? 1.0f : fm;
  const float sgn = (fmn > 0.0f) ? 1.0f : ((fmn < 0.0f) ? -1.0f : 0.0f);
  const float ccb = fm + sgn * vrel * p.sinw;
  float ab2 = cca * cca + ccb * ccb;
  const float rf = (aiU > RHEO_AREA_MIN) ? 1.0f : 0.0f;
  const float cc1 = rf * strintx + uc[UC_FORCEX] + taux +
                    umassdti * (p.brlx * uold + p.revp * uc[UC_UINIT]);
  const float cc2 = rf * strinty + uc[UC_FORCEY] + tauy +
                    umassdti * (p.brlx * vold + p.revp * uc[UC_VINIT]);
  ab2 = iceu ? ab2 : 1.0f;
  const float rab2 = 1.0f / ab2;
  u = iceu ? (cca * cc1 + ccb * cc2) * rab2 : 0.0f;
  v = iceu ? (cca * cc2 - ccb * cc1) * rab2 : 0.0f;
}

// The tail at one U cell: the force diagnostics and the seabed stress.
__device__ __forceinline__ void tail_cell(const Params& p, float uarear,
                                          float tbu, float sx, float sy,
                                          float u, float v, float* out,
                                          size_t P, size_t k) {
  out[S_STRINTX * P + k] = uarear * sx;
  out[S_STRINTY * P + k] = uarear * sy;
  const float Cb = tbu / (sqrtf(u * u + v * v) + p.u0);
  out[S_TAUBX * P + k] = -u * Cb;
  out[S_TAUBY * P + k] = -v * Cb;
}

// ---------------------------------------------------------------------
// route `persistent`
// ---------------------------------------------------------------------

// threads of a persistent block, and the most T cells its tile may have
constexpr int PERSIST_THREADS = 1024;
constexpr unsigned SPIN_LIMIT = 1u << 22;   // a few seconds, then trap

// All blocks of the grid meet: `counter` counts arrivals since the solve
// began, `target` is the count that ends this meeting. Thread 0 arrives
// with a release and waits with acquires, between two block barriers, so
// what any thread of any block wrote to global memory before the meeting
// is visible to every thread after it (when read past L1, as the ring is).
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter)
                 : "memory");
    unsigned seen, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (++spins > SPIN_LIMIT) __trap();
    } while ((int)(seen - target) < 0);
  }
  __syncthreads();
}

// Wrapped global index of (j, i), or -1 outside the domain.
__device__ __forceinline__ long gidx(int j, int i, int ny, int nx, int xcyc) {
  if (i < 0) {
    if (!xcyc) return -1;
    i += nx;
  } else if (i >= nx) {
    if (!xcyc) return -1;
    i -= nx;
  }
  if (j < 0 || j >= ny || i < 0 || i >= nx) return -1;
  return (long)j * nx + i;
}

// Shared-memory bytes of one block with a (TH, TW) tile: per thread its T
// cell's 12 stresses and N_TC constants and its U cell's N_UC constants,
// the 8 stress-divergence terms per T cell, u and v on the ring tile.
inline long persist_smem_bytes(int TH, int TW) {
  return 4L * ((12 + N_TC + N_UC + 8) * PERSIST_THREADS +
               2L * (TH + 2) * (TW + 2));
}

// One thread per T cell of the tile (the tile plus one row north and one
// column east: at most PERSIST_THREADS cells) and, for the first th*tw
// threads, per U cell. What only that thread touches (its T cell's
// stresses and constants, its U cell's constants) lies in shared memory at
// its thread index; what neighbours read (the stress-divergence terms, u
// and v) lies there by position.
__global__ void __launch_bounds__(PERSIST_THREADS, 1)
evp_persistent_kernel(Planes pl, float* __restrict__ out,
                      float* __restrict__ halo, unsigned* counter, int ny,
                      int nx, int xcyc, int ndte, int TH, int TW, int nbx,
                      Params p) {
  extern __shared__ float smem[];
  constexpr int S = PERSIST_THREADS;
  const int tid = threadIdx.x;
  const int bj = blockIdx.x / nbx, bi = blockIdx.x - bj * nbx;
  const int j0 = bj * TH, i0 = bi * TW;
  const int th = min(TH, ny - j0), tw = min(TW, nx - i0);
  const int PT = tw + 1, NT = (th + 1) * PT;      // T cells: tile + N, E
  const int NU = th * tw;                         // U cells: the tile
  const int PV = tw + 2, NV = (th + 2) * PV;      // u, v: tile + ring
  const size_t P = (size_t)ny * nx;

  float* s_st = smem + tid;            // [q * S]: 12 stresses, this thread's
  float* s_tc = s_st + 12 * S;         // [q * S]: N_TC constants, likewise
  float* s_uc = s_tc + N_TC * S;       // [q * S]: N_UC constants, likewise
  float* s_str = smem + (12 + N_TC + N_UC) * S;       // [q * S + T cell]
  float* s_u = s_str + 8 * S;          // [frame cell]
  float* s_v = s_u + NV;

  // ---- this thread's T cell: boundary first (rows 0 and th, columns 0
  // and tw: the cells that read the ring), then the interior row by row,
  // so that the few warps that fetch the neighbours' values leave the
  // others to compute ----------------------------------------------------
  const int nbnd = NT - (th - 1) * (tw - 1);
  int lj = 0, li = 0;
  if (tid >= nbnd) {
    const int q = tid - nbnd;
    lj = 1 + q / max(tw - 1, 1);
    li = 1 + q - (lj - 1) * (tw - 1);
  } else if (tid < PT) {
    li = tid;
  } else if (tid < 2 * PT) {
    lj = th; li = tid - PT;
  } else {
    lj = 1 + ((tid - 2 * PT) >> 1);
    li = ((tid - 2 * PT) & 1) ? tw : 0;
  }
  const long kt = tid < NT ? gidx(j0 + lj, i0 + li, ny, nx, xcyc) : -1;
  const bool t_on = kt >= 0;           // else off the domain: its str stay 0
  const bool t_own = t_on && lj < th && li < tw;   // it writes the stresses
  const int tsp = lj * PT + li;        // its place among the T cells
  const int tb = (lj + 1) * PV + (li + 1);         // its NE corner's u, v
  // where its 4 corners' u, v come from once the neighbours have stepped:
  // a global index for those on the ring, -1 for its own tile's
  int kr[4] = {-1, -1, -1, -1};
  bool icet = false;
  if (tid < NT) {
#pragma unroll
    for (int q = 0; q < 8; ++q) s_str[q * S + tsp] = 0.0f;
  }
  if (t_on) {
    icet = bplane(pl, C_ICETMASK)[kt] != 0;
#pragma unroll
    for (int q = 0; q < N_TC; ++q) s_tc[q * S] = fplane(pl, t_const(q))[kt];
#pragma unroll
    for (int q = 0; q < 12; ++q)
      s_st[q * S] = icet ? pl.s_in[q >> 2][(q & 3) * P + kt] : 0.0f;
    if (tid < nbnd) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = lj + 1 - (q >> 1), col = li + 1 - (q & 1);
        if (row == 0 || row == th + 1 || col == 0 || col == tw + 1)
          kr[q] = (int)gidx(j0 - 1 + row, i0 - 1 + col, ny, nx, xcyc);
      }
    }
  }

  // ---- this thread's U cell --------------------------------------------
  const bool u_on = tid < NU;
  const int ulj = u_on ? tid / tw : 0, uli = u_on ? tid - ulj * tw : 0;
  const size_t ku = (size_t)(j0 + ulj) * nx + (i0 + uli);
  const int usp = ulj * PT + uli;      // T cell of the same place
  const int ub = (ulj + 1) * PV + (uli + 1);
  const bool u_out = ulj == 0 || ulj == th - 1 || uli == 0 || uli == tw - 1;
  bool iceu = false;
  if (u_on) {
#pragma unroll
    for (int q = 0; q < N_UC; ++q) s_uc[q * S] = fplane(pl, u_const(q))[ku];
    iceu = bplane(pl, C_ICEUMASK)[ku] != 0;
  }
  for (int c = tid; c < NV; c += S) {
    const int fj = c / PV, fi = c - fj * PV;
    const long k = gidx(j0 - 1 + fj, i0 - 1 + fi, ny, nx, xcyc);
    s_u[c] = k >= 0 ? pl.u0[k] : 0.0f;
    s_v[c] = k >= 0 ? pl.v0[k] : 0.0f;
  }
  __syncthreads();

  for (int it = 0; it <= ndte; ++it) {
    const bool tail = it == ndte;
    // ---- T pass: stresses and their divergence terms -------------------
    if (t_on) {
      // (u, v) at this cell's NE corner, then its W, S and SW corners; in
      // shared memory the ring holds the incoming velocity (or zero off
      // the domain); after a subcycle the neighbours' values lie in the
      // copy of that subcycle's parity
      float uv[8] = {s_u[tb], s_v[tb], s_u[tb - 1], s_v[tb - 1],
                     s_u[tb - PV], s_v[tb - PV], s_u[tb - PV - 1],
                     s_v[tb - PV - 1]};
      if (it > 0) {
        const float* ru = halo + (size_t)((it + 1) & 1) * 2 * P;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (kr[q] >= 0) {
            uv[2 * q] = __ldcg(ru + kr[q]);
            uv[2 * q + 1] = __ldcg(ru + P + kr[q]);
          }
      }
      float tc[N_TC], s[12], str[8];
#pragma unroll
      for (int q = 0; q < N_TC; ++q) tc[q] = s_tc[q * S];
#pragma unroll
      for (int q = 0; q < 12; ++q) s[q] = s_st[q * S];
      if (tail && t_own) {
#pragma unroll
        for (int q = 0; q < 12; ++q) out[(S_SP + q) * P + kt] = s[q];
      }
      stress_cell(p, tc, icet, uv[0], uv[1], uv[2], uv[3], uv[4], uv[5],
                  uv[6], uv[7], s, str);
      if (!tail) {
#pragma unroll
        for (int q = 0; q < 12; ++q) s_st[q * S] = s[q];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) s_str[q * S + tsp] = str[q];
    }
    __syncthreads();

    // ---- U pass: gather, then the momentum step or the tail ------------
    if (u_on) {
      const float sx = s_str[0 * S + usp] + s_str[1 * S + usp + 1] +
                       s_str[2 * S + usp + PT] + s_str[3 * S + usp + PT + 1];
      const float sy = s_str[4 * S + usp] + s_str[5 * S + usp + PT] +
                       s_str[6 * S + usp + 1] + s_str[7 * S + usp + PT + 1];
      float u = s_u[ub], v = s_v[ub];
      if (tail) {
        tail_cell(p, s_uc[UC_UAREAR * S], s_uc[UC_TBU * S], sx, sy, u, v,
                  out, P, ku);
        out[S_U * P + ku] = u;
        out[S_V * P + ku] = v;
      } else {
        float uc[N_UC];
#pragma unroll
        for (int q = 0; q < N_UC; ++q) uc[q] = s_uc[q * S];
        stepu_cell(p, uc, iceu, sx, sy, u, v);
        s_u[ub] = u;
        s_v[ub] = v;
        if (u_out) {                   // the perimeter goes to the neighbours
          float* hu = halo + (size_t)(it & 1) * 2 * P;
          __stcg(hu + ku, u);
          __stcg(hu + P + ku, v);
        }
      }
    }
    if (tail) break;

    // ---- exchange: once every block's perimeter is out, the next T pass
    // may read its ring ---------------------------------------------------
    grid_barrier(counter, (unsigned)(it + 1) * gridDim.x);
  }
}

// ---------------------------------------------------------------------
// route `stream`
// ---------------------------------------------------------------------

__device__ __forceinline__ float ld(const float* __restrict__ a, int j, int i,
                                    int ny, int nx, int xcyc) {
  const long k = gidx(j, i, ny, nx, xcyc);
  return k < 0 ? 0.f : a[k];
}

// Copies the incoming velocity and the masked incoming stresses into out.
__global__ void evp_stream_load_kernel(Planes pl, float* __restrict__ out,
                                       int ny, int nx) {
  const size_t P = (size_t)ny * nx;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= P) return;
  out[S_U * P + k] = pl.u0[k];
  out[S_V * P + k] = pl.v0[k];
  const bool icet = bplane(pl, C_ICETMASK)[k] != 0;
#pragma unroll
  for (int q = 0; q < 12; ++q)
    out[(S_SP + q) * P + k] = icet ? pl.s_in[q >> 2][(q & 3) * P + k] : 0.0f;
}

// T-cell kernel: stress update at the 4 corners (kept when `store`) and
// the 8 str* terms.
__global__ void evp_stream_stress_kernel(Planes pl, float* __restrict__ out,
                                         float* __restrict__ strb, int ny,
                                         int nx, int xcyc, int store,
                                         Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t P = (size_t)ny * nx;
  const size_t k = (size_t)j * nx + i;
  const float* cu = out + S_U * P;
  const float* cv = out + S_V * P;
  float tc[N_TC], s[12], str[8];
#pragma unroll
  for (int q = 0; q < N_TC; ++q) tc[q] = fplane(pl, t_const(q))[k];
#pragma unroll
  for (int q = 0; q < 12; ++q) s[q] = out[(S_SP + q) * P + k];
  stress_cell(p, tc, bplane(pl, C_ICETMASK)[k] != 0, cu[k], cv[k],
              ld(cu, j, i - 1, ny, nx, xcyc), ld(cv, j, i - 1, ny, nx, xcyc),
              ld(cu, j - 1, i, ny, nx, xcyc), ld(cv, j - 1, i, ny, nx, xcyc),
              ld(cu, j - 1, i - 1, ny, nx, xcyc),
              ld(cv, j - 1, i - 1, ny, nx, xcyc), s, str);
  if (store) {
#pragma unroll
    for (int q = 0; q < 12; ++q) out[(S_SP + q) * P + k] = s[q];
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) strb[q * P + k] = str[q];
}

// U-cell kernel: gather the str* terms of the 4 T cells sharing U(i,j)
// (this, east, north, northeast) and take the momentum step, or the tail.
__global__ void evp_stream_stepu_kernel(Planes pl, float* __restrict__ out,
                                        const float* __restrict__ strb,
                                        int ny, int nx, int xcyc, int tail,
                                        Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t P = (size_t)ny * nx;
  const size_t k = (size_t)j * nx + i;
  const float sx = strb[0 * P + k] + ld(strb + 1 * P, j, i + 1, ny, nx, xcyc) +
                   ld(strb + 2 * P, j + 1, i, ny, nx, xcyc) +
                   ld(strb + 3 * P, j + 1, i + 1, ny, nx, xcyc);
  const float sy = strb[4 * P + k] + ld(strb + 5 * P, j + 1, i, ny, nx, xcyc) +
                   ld(strb + 6 * P, j, i + 1, ny, nx, xcyc) +
                   ld(strb + 7 * P, j + 1, i + 1, ny, nx, xcyc);
  float u = out[S_U * P + k], v = out[S_V * P + k];
  if (tail) {
    tail_cell(p, fplane(pl, C_UAREAR)[k], fplane(pl, C_TBU)[k], sx, sy, u, v,
              out, P, k);
    return;
  }
  float uc[N_UC];
#pragma unroll
  for (int q = 0; q < N_UC; ++q) uc[q] = fplane(pl, u_const(q))[k];
  stepu_cell(p, uc, bplane(pl, C_ICEUMASK)[k] != 0, sx, sy, u, v);
  out[S_U * P + k] = u;
  out[S_V * P + k] = v;
}

Params make_params(const float* q) {
  Params p;
  p.e_factor = q[0]; p.capping = q[1]; p.one_p_ktens = q[2];
  p.one_m_ktens = q[3]; p.epp2i = q[4]; p.c1m = q[5]; p.arlx1i = q[6];
  p.denom1 = q[7]; p.brlx_p_revp = q[8]; p.brlx = q[9]; p.revp = q[10];
  p.rhow = q[11]; p.u0 = q[12]; p.cosw = q[13]; p.sinw = q[14];
  return p;
}

// `ptrs`: the 26 CONST_PLANES pointers, then u0, v0, stressp, stressm,
// stress12 (31 device pointers in host memory).
Planes make_planes(const void* const* ptrs) {
  Planes pl;
  for (int q = 0; q < N_CONST; ++q) pl.c[q] = ptrs[q];
  pl.u0 = static_cast<const float*>(ptrs[N_CONST]);
  pl.v0 = static_cast<const float*>(ptrs[N_CONST + 1]);
  for (int q = 0; q < 3; ++q)
    pl.s_in[q] = static_cast<const float*>(ptrs[N_CONST + 2 + q]);
  return pl;
}

const dim3 STREAM_BLOCK(32, 8);

dim3 stream_grid(int ny, int nx) {
  return dim3((nx + STREAM_BLOCK.x - 1) / STREAM_BLOCK.x,
              (ny + STREAM_BLOCK.y - 1) / STREAM_BLOCK.y);
}

}  // namespace

// What the card offers the persistent kernel. info[0] SMs, info[1] bytes
// of shared memory a block may use, info[2] blocks of the persistent
// kernel resident per SM at that shared-memory size, info[3] its registers
// per thread, info[4] its threads per block, info[5] whether the device
// takes cooperative launches. Returns the first CUDA error (0 = success).
extern "C" int evp_persistent_info(int* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceProp prop;
  e = cudaGetDeviceProperties(&prop, dev);
  if (e != cudaSuccess) return (int)e;
  const int smem = (int)prop.sharedMemPerBlockOptin;
  e = cudaFuncSetAttribute(evp_persistent_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, evp_persistent_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, evp_persistent_kernel, PERSIST_THREADS,
      (size_t)smem - attr.sharedSizeBytes);
  if (e != cudaSuccess) return (int)e;
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  info[0] = prop.multiProcessorCount;
  info[1] = smem - (int)attr.sharedSizeBytes;
  info[2] = per_sm;
  info[3] = attr.numRegs;
  info[4] = PERSIST_THREADS;
  info[5] = coop;
  return 0;
}

// One whole solve on route `persistent`: a cooperative launch of one block
// per (th, tw) tile. `ptrs` as for make_planes; `out` 18 planes; `halo` 4
// planes of scratch; `counter` one zeroed unsigned; `params` 15 floats in
// host memory. The launch is refused (an error is returned, nothing runs)
// when the blocks cannot all be resident.
extern "C" int evp_solve_persistent(const void* const* ptrs, float* out,
                                    float* halo, unsigned* counter, int ny,
                                    int nx, int xcyc, int ndte, int th,
                                    int tw, const float* params,
                                    void* stream) {
  Planes pl = make_planes(ptrs);
  Params p = make_params(params);
  int nbx = (nx + tw - 1) / tw;
  const int nby = (ny + th - 1) / th;
  const long smem = persist_smem_bytes(th, tw);
  cudaError_t e = cudaFuncSetAttribute(
      evp_persistent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&pl, &out, &halo, &counter, &ny, &nx, &xcyc, &ndte,
                  &th, &tw, &nbx, &p};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(evp_persistent_kernel), dim3(nbx * nby),
      dim3(PERSIST_THREADS), args, (size_t)smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One whole solve on route `stream`: a load kernel, two kernels per
// subcycle, two for the tail. `strbuf`: 8 planes of scratch.
extern "C" int evp_solve_stream(const void* const* ptrs, float* out,
                                float* strbuf, int ny, int nx, int xcyc,
                                int ndte, const float* params, void* stream) {
  const Planes pl = make_planes(ptrs);
  const Params p = make_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = stream_grid(ny, nx);
  const long P = (long)ny * nx;
  evp_stream_load_kernel<<<(unsigned)((P + 255) / 256), 256, 0, s>>>(pl, out,
                                                                    ny, nx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int it = 0; it <= ndte; ++it) {
    const int tail = it == ndte;
    evp_stream_stress_kernel<<<grid, STREAM_BLOCK, 0, s>>>(
        pl, out, strbuf, ny, nx, xcyc, !tail, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    evp_stream_stepu_kernel<<<grid, STREAM_BLOCK, 0, s>>>(
        pl, out, strbuf, ny, nx, xcyc, tail, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
