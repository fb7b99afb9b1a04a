// BL99 temperature solve of therm1 (ktherm=1) for NVIDIA Hopper (sm_90a),
// float32 and float64: K4.
//
// The JAX package has no TPU kernel for it (cice_tpu/columns/
// thermo_vertical.py `temperature_changes` is plain XLA). The plain PyTorch
// version, cice_tpu_torch/columns/thermo_vertical.py
// `temperature_changes_plain`, runs each Picard pass as ~460 elementwise
// launches over the (category, cell) columns, one layer at a time, and
// reads the pass's largest temperature change on the host to decide the
// exit. Here a thread takes a column at a time: its layers, the
// tridiagonal rows and the elimination stay in registers.
//
// The arithmetic mirrors the plain version op by op as PyTorch computes it
// on the card (built with -fmad=false), so the two agree bit for bit:
// `scalar / tensor` is `reciprocal(tensor) * scalar`, `tensor / scalar`
// is `tensor * (1 / scalar)` with the reciprocal rounded in the dtype (the
// wrapper does both roundings and passes the constants in), `x ** 4` is
// pow(x, 4), `x ** 3` is x * x * x, clamps return NaN unchanged, Python
// sums start from 0 and add left to right, and constant factors that
// Python folds in double precision arrive folded.
//
// The exit rule is the plain version's: every column takes the same,
// global number of passes, the first pass whose largest change anywhere is
// not above TSF_ERRMAX, or `nit`. A pass reduces its changes per block (as
// the bits of non-negative floats, so a NaN is the largest and stops the
// solve as torch's max does) and does one atomicMax into the pass's slot.
//
// One kernel, `bl99_kernel`, serves both routes. `whole`: one cooperative
// launch does all passes; after a pass every block meets at a grid barrier
// and reads the slot, so the exit is decided on the card and the launch
// count does not depend on the pass count. The iterate lives in the output
// planes (each thread keeps the same columns in every pass, so it reads
// back only what it wrote); the epilogue (surface fluxes, conduction, new
// enthalpies, column energy) follows the last pass without another
// barrier. `per_pass`, for a state sharded across ranks, where the host
// agrees the exit across the mesh: one launch a pass, then one for the
// epilogue.
//
// What bounds it on the H100: a pass reads ~34 and writes ~9 values a
// column (f32 at nslyr 1, nilyr 7), the epilogue ~25 and ~26; at om025's
// 7.8 M columns ~1.3 GB a pass. Bytes bind: 2.1 ms for 4 passes at 3.35
// TB/s, against 3.36 ms measured (NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned SPIN_LIMIT = 1u << 22;  // a few seconds, then trap
constexpr int MAX_S = 5, MAX_L = 7;

// input planes, in cice_tpu_torch/kernels/bl99.py INPUTS order, then
// qsno[nslyr], qice[nilyr], Iswabs[nilyr]
enum {
  I_TSF, I_HILYR, I_HSLYR, I_TBOT, I_FSWSFC, I_SHCOEF, I_LHCOEF, I_POTT,
  I_QA, I_RHOA, I_FLW, I_LAYERS
};
constexpr int MAX_IN = I_LAYERS + MAX_S + 2 * MAX_L;

// output planes, in OUTPUTS order, then Tsno[nslyr], Tice[nilyr],
// qsno_new[nslyr], qice_new[nilyr]
enum {
  O_TSF, O_FSURF, O_FCONDTOP, O_FCONDBOT, O_FSENS, O_FLAT, O_FLWOUT,
  O_EINIT, O_EFINAL, O_KEFF, O_LAYERS
};

// scalar constants, in bl99.py CONSTS order (rounded to the dtype there)
enum {
  K_DT, K_NSLYR, K_HS_MIN, K_PUNY, K_RRHOS, K_LFRESH, K_RCP_ICE, K_RRHOI,
  K_R2A, K_KS2, K_KS, K_KVIRT, K_RHOS_CP, K_CP_ICE, K_CI_MIN, K_RHOI,
  K_TFFRESH, K_QQQICE, K_NEG_TTT, K_TTT, K_FLW, K_DFLW, K_EMISS,
  K_RHOA_MIN, K_TSFK_MIN, K_TIN_MIN, K_TINY, K_ERRMAX, K_NEG_RHOS,
  K_NEG_RHOI, K_KIMIN, K_KC0, K_KC1, K_KFAC, K_TS_MAX, K_TSMELT, K_TMIN,
  N_K
};
// per-layer constants, in LAYER_CONSTS order
enum { L_TM, L_TMQ, L_B1, L_C4, L_LTM, L_CPOTM, L_KSAL, N_LK };

// every input where it lies: plane elements contiguous, `cs` elements
// from one category's plane to the next (0: one plane for all)
struct Inputs {
  const void* p[MAX_IN];
  long long cs[MAX_IN];
};

template <typename T>
struct Consts {
  T k[N_K];
  T l[N_LK][MAX_L];
};

// the functions PyTorch's CUDA kernels call for float and double
__device__ __forceinline__ float fmx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmx(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float fmn(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmn(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float pow4(float x) { return powf(x, 4.0f); }
__device__ __forceinline__ double pow4(double x) { return pow(x, 4.0); }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float sq(float x) { return sqrtf(x); }
__device__ __forceinline__ double sq(double x) { return sqrt(x); }
__device__ __forceinline__ unsigned long long bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long bits(double x) {
  return (unsigned long long)__double_as_longlong(x);
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long b) {
  return __uint_as_float((unsigned)b);
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double((long long)b);
}

// torch.clamp with scalar bounds: NaN passes, then max/min
template <typename T>
__device__ __forceinline__ T clamp_lo(T v, T lo) {
  return isnan(v) ? v : fmx(v, lo);
}
template <typename T>
__device__ __forceinline__ T clamp_hi(T v, T hi) {
  return isnan(v) ? v : fmn(v, hi);
}
template <typename T>
__device__ __forceinline__ T clamp2(T v, T lo, T hi) {
  return isnan(v) ? v : fmn(fmx(v, lo), hi);
}
template <typename T>
__device__ __forceinline__ T rcp(T x) {
  return T(1) / x;
}

// one column's inputs; Tsn0/Tin0 from the enthalpies
template <typename T, int S, int L>
struct Column {
  T Tsf_in, hilyr, hslyr, hslyr_p, Tbot, fswsfc, shcoef, lhcoef, potT, Qa,
      rhoa, flw;
  bool snow;
  T qsno[S], qice[L], isw[L], Tsn0[S], Tin0[L];
};

template <typename T>
__device__ __forceinline__ T ld(const Inputs& in, int i, long long c, int q) {
  return __ldg(static_cast<const T*>(in.p[i]) + c * in.cs[i] + q);
}

// temp_from_enthalpy_snow
template <typename T>
__device__ __forceinline__ T t_snow(T q, const Consts<T>& k) {
  return clamp_hi((q * k.k[K_RRHOS] + k.k[K_LFRESH]) * k.k[K_RCP_ICE], T(0));
}

// temp_from_enthalpy_ice: the root of a T^2 + b T + c
template <typename T>
__device__ __forceinline__ T t_ice(T q, int kk, const Consts<T>& k) {
  const T b = (k.l[L_B1][kk] - q * k.k[K_RRHOI]) - k.k[K_LFRESH];
  const T disc = clamp_lo(b * b - k.l[L_C4][kk], T(0));
  return clamp_hi((-b - sq(disc)) * k.k[K_R2A], k.l[L_TM][kk]);
}

// enthalpy_snow
template <typename T>
__device__ __forceinline__ T q_snow(T t, const Consts<T>& k) {
  return (k.k[K_LFRESH] - t * k.k[K_CP_ICE]) * k.k[K_NEG_RHOS];
}

// enthalpy_ice
template <typename T>
__device__ __forceinline__ T q_ice(T t, int kk, const Consts<T>& k) {
  const T Ts = clamp_hi(t, k.l[L_TMQ][kk]);
  const T a = (k.l[L_TM][kk] - Ts) * k.k[K_CP_ICE];
  const T b = (T(1) - rcp(Ts) * k.l[L_TM][kk]) * k.k[K_LFRESH];
  return ((a + b) - k.l[L_CPOTM][kk]) * k.k[K_NEG_RHOI];
}

// conductivity_ice: bubbly (conduct 0) or MU71 (conduct 1)
template <typename T>
__device__ __forceinline__ T k_ice(T t, int kk, int conduct,
                                   const Consts<T>& k) {
  const T Ts = clamp_hi(t, k.k[K_TS_MAX]);
  T c;
  if (conduct)
    c = rcp(Ts) * k.l[L_KSAL][kk] + k.k[K_KC0];
  else
    c = ((k.k[K_KC0] - Ts * k.k[K_KC1]) + rcp(Ts) * k.l[L_KSAL][kk]) *
        k.k[K_KFAC];
  return clamp_lo(c, k.k[K_KIMIN]);
}

template <typename T>
struct Fluxes {
  T fsurf, dfsurf, fsens, flat, flwout;
};

// columns/atmo.py surface_fluxes at surface temperature Tsf
template <typename T, int S, int L>
__device__ __forceinline__ Fluxes<T> surface_fluxes(
    T Tsf, const Column<T, S, L>& c, const Consts<T>& k) {
  const T TsfK = Tsf + k.k[K_TFFRESH];
  const T qsfc = (rcp(clamp_lo(c.rhoa, k.k[K_RHOA_MIN])) * k.k[K_QQQICE]) *
                 ex(rcp(clamp_lo(TsfK, k.k[K_TSFK_MIN])) * k.k[K_NEG_TTT]);
  const T dqsfc = (qsfc * k.k[K_TTT]) / (TsfK * TsfK);
  Fluxes<T> f;
  f.fsens = c.shcoef * (c.potT - TsfK);
  f.flat = c.lhcoef * (c.Qa - qsfc);
  f.flwout = pow4(TsfK) * k.k[K_FLW];
  const T dflwout = ((TsfK * TsfK) * TsfK) * k.k[K_DFLW];
  f.fsurf = (((c.fswsfc + c.flw * k.k[K_EMISS]) + f.flwout) + f.fsens) +
            f.flat;
  f.dfsurf = (dflwout + (-c.shcoef)) + (-c.lhcoef) * dqsfc;
  return f;
}

template <typename T, int S, int L>
__device__ __forceinline__ Column<T, S, L> load(const Inputs& in,
                                                const Consts<T>& k,
                                                long long cat, int q) {
  Column<T, S, L> c;
  c.Tsf_in = ld<T>(in, I_TSF, cat, q);
  c.hilyr = ld<T>(in, I_HILYR, cat, q);
  c.hslyr = ld<T>(in, I_HSLYR, cat, q);
  c.Tbot = ld<T>(in, I_TBOT, cat, q);
  c.fswsfc = ld<T>(in, I_FSWSFC, cat, q);
  c.shcoef = ld<T>(in, I_SHCOEF, cat, q);
  c.lhcoef = ld<T>(in, I_LHCOEF, cat, q);
  c.potT = ld<T>(in, I_POTT, cat, q);
  c.Qa = ld<T>(in, I_QA, cat, q);
  c.rhoa = ld<T>(in, I_RHOA, cat, q);
  c.flw = ld<T>(in, I_FLW, cat, q);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    c.qsno[s] = ld<T>(in, I_LAYERS + s, cat, q);
    c.Tsn0[s] = t_snow(c.qsno[s], k);
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    c.qice[i] = ld<T>(in, I_LAYERS + S + i, cat, q);
    c.isw[i] = ld<T>(in, I_LAYERS + S + L + i, cat, q);
    c.Tin0[i] = t_ice(c.qice[i], i, k);
  }
  c.snow = c.hslyr * k.k[K_NSLYR] > k.k[K_HS_MIN];
  c.hslyr_p = clamp_lo(c.hslyr, k.k[K_PUNY]);
  return c;
}

// One Picard pass of one column (thermo_vertical.py `body`): the iterate
// (Tsf, Tsn, Tin) in place; returns the bits of its largest change.
template <typename T, int S, int L>
__device__ __forceinline__ unsigned long long picard_pass(
    const Column<T, S, L>& c, T& Tsf, T (&Tsn)[S], T (&Tin)[L], int conduct,
    const Consts<T>& k) {
  constexpr int NL = S + L;
  T ki[L];
#pragma unroll
  for (int i = 0; i < L; ++i) ki[i] = k_ice(Tin[i], i, conduct, k);

  // interface conductances; without snow the snow rows are massless
  // conducting nodes at kh_virt
  const T khi_sfc = (ki[0] * T(2)) / c.hilyr;
  const T kh_virt = khi_sfc * k.k[K_KVIRT];
  T kh_sfc = kh_virt, kh_snow = kh_virt, kh_si = kh_virt;
  if (c.snow) {
    const T r = rcp(c.hslyr_p);
    kh_sfc = r * k.k[K_KS2];
    kh_snow = r * k.k[K_KS];
    kh_si = (ki[0] * k.k[K_KS2]) /
            clamp_lo(c.hilyr * k.k[K_KS] + ki[0] * c.hslyr, k.k[K_PUNY]);
  }
  T kh_ii[L > 1 ? L - 1 : 1];
#pragma unroll
  for (int i = 0; i + 1 < L; ++i)
    kh_ii[i] = ((ki[i] * T(2)) * ki[i + 1]) /
               (ki[i] * c.hilyr + ki[i + 1] * c.hilyr);
  const T kh_bot = (ki[L - 1] * T(2)) / c.hilyr;

  const T etas =
      c.snow ? rcp(c.hslyr_p * k.k[K_RHOS_CP]) * k.k[K_DT] : T(0);
  const T snow_f = c.snow ? T(1) : T(0);
  T etai[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const T ci = k.k[K_CP_ICE] -
                 rcp(clamp_lo(Tin[i] * c.Tin0[i], k.k[K_TIN_MIN])) *
                     k.l[L_LTM][i];
    etai[i] = rcp((clamp_lo(ci, k.k[K_CI_MIN]) * k.k[K_RHOI]) * c.hilyr) *
              k.k[K_DT];
  }

  const Fluxes<T> f = surface_fluxes(Tsf, c, k);

  // rows 1..NL: snow layers, then ice layers; bottom Dirichlet Tbot
  T sb[NL + 1], dg[NL + 1], sp[NL + 1], rh[NL + 1];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const T up = s == 0 ? kh_sfc : kh_snow;
    const T dn = s == S - 1 ? kh_si : kh_snow;
    const int r = 1 + s;
    sb[r] = (-etas) * up - (c.snow ? T(0) : up);
    dg[r] = (snow_f + etas * (up + dn)) + (c.snow ? T(0) : up + dn);
    sp[r] = (-etas) * dn - (c.snow ? T(0) : dn);
    rh[r] = c.snow ? c.Tsn0[s] : T(0);
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const T up = i == 0 ? kh_si : kh_ii[i == 0 ? 0 : i - 1];
    const T dn = i == L - 1 ? kh_bot : kh_ii[i < L - 1 ? i : 0];
    const int r = 1 + S + i;
    sb[r] = (-etai[i]) * up;
    dg[r] = etai[i] * (up + dn) + T(1);
    sp[r] = (-etai[i]) * dn;
    rh[r] = c.Tin0[i] + etai[i] * c.isw[i];
    if (i == L - 1) rh[r] = rh[r] + (etai[i] * dn) * c.Tbot;
  }

  // bottom-up elimination: x_r = alpha_r + beta_r * x_{r-1}
  T alpha[NL + 2], beta[NL + 2];
#pragma unroll
  for (int r = NL; r >= 1; --r) {
    T den = r == NL ? dg[r] : dg[r] + sp[r] * beta[r + 1];
    den = fabs(den) < k.k[K_TINY] ? k.k[K_TINY] : den;
    const T num = r == NL ? rh[r] : rh[r] - sp[r] * alpha[r + 1];
    alpha[r] = num / den;
    beta[r] = (-sb[r]) / den;
  }
  const T dg0 = f.dfsurf - kh_sfc;
  const T rh0 = f.dfsurf * Tsf - f.fsurf;
  T den0 = dg0 + kh_sfc * beta[1];
  den0 = fabs(den0) < k.k[K_TINY] ? k.k[K_TINY] : den0;
  const T Tsf_c = (rh0 - kh_sfc * alpha[1]) / den0;

  // melting closure, the physical window
  const T Tsf_n = clamp2(Tsf_c > T(0) ? k.k[K_TSMELT] : Tsf_c, k.k[K_TMIN],
                         T(0));
  unsigned long long err = bits(fabs(Tsf_n - Tsf));
  Tsf = Tsf_n;
  T x = Tsf_n;
#pragma unroll
  for (int r = 1; r <= NL; ++r) {
    x = alpha[r] + beta[r] * x;
    if (r <= S) {
      const T t = clamp2(x, k.k[K_TMIN], T(0));
      err = max(err, bits(fabs(t - Tsn[r - 1])));
      Tsn[r - 1] = t;
    } else {
      const int i = r - 1 - S;
      const T t = clamp_hi(clamp_lo(x, k.k[K_TMIN]), k.l[L_TM][i]);
      err = max(err, bits(fabs(t - Tin[i])));
      Tin[i] = t;
    }
  }
  return err;
}

template <typename T, int S, int L>
__device__ __forceinline__ void start_iterate(const Column<T, S, L>& c,
                                              T& Tsf, T (&Tsn)[S],
                                              T (&Tin)[L],
                                              const Consts<T>& k) {
  Tsf = clamp2(c.Tsf_in, k.k[K_TMIN], T(0));
#pragma unroll
  for (int s = 0; s < S; ++s) Tsn[s] = c.Tsn0[s];
#pragma unroll
  for (int i = 0; i < L; ++i) Tin[i] = c.Tin0[i];
}

template <typename T, int S, int L>
__device__ __forceinline__ void read_iterate(const T* out, long long N,
                                             long long n, T& Tsf,
                                             T (&Tsn)[S], T (&Tin)[L]) {
  Tsf = out[O_TSF * N + n];
#pragma unroll
  for (int s = 0; s < S; ++s) Tsn[s] = out[(O_LAYERS + s) * N + n];
#pragma unroll
  for (int i = 0; i < L; ++i) Tin[i] = out[(O_LAYERS + S + i) * N + n];
}

template <typename T, int S, int L>
__device__ __forceinline__ void write_iterate(T* out, long long N,
                                              long long n, T Tsf,
                                              const T (&Tsn)[S],
                                              const T (&Tin)[L]) {
  out[O_TSF * N + n] = Tsf;
#pragma unroll
  for (int s = 0; s < S; ++s) out[(O_LAYERS + s) * N + n] = Tsn[s];
#pragma unroll
  for (int i = 0; i < L; ++i) out[(O_LAYERS + S + i) * N + n] = Tin[i];
}

// pass `first` starts from the inputs, later passes from the iterate in
// `out`; the new iterate goes to `out`. Returns the change's bits.
template <typename T, int S, int L>
__device__ __forceinline__ unsigned long long column_pass(
    const Inputs& in, T* out, const Consts<T>& k, int N, int P, int n,
    bool first, int conduct) {
  const int cat = n / P;
  const Column<T, S, L> c = load<T, S, L>(in, k, cat, n - cat * P);
  T Tsf, Tsn[S], Tin[L];
  if (first)
    start_iterate(c, Tsf, Tsn, Tin, k);
  else
    read_iterate<T, S, L>(out, N, n, Tsf, Tsn, Tin);
  const unsigned long long err = picard_pass(c, Tsf, Tsn, Tin, conduct, k);
  write_iterate<T, S, L>(out, N, n, Tsf, Tsn, Tin);
  return err;
}

// The solve's tail at the final iterate: fluxes, conduction at the top and
// bottom, the new enthalpies and the column energies.
template <typename T, int S, int L>
__device__ __forceinline__ void column_finish(const Inputs& in, T* out,
                                              const Consts<T>& k, int N,
                                              int P, int n, bool first,
                                              int conduct) {
  const int cat = n / P;
  const Column<T, S, L> c = load<T, S, L>(in, k, cat, n - cat * P);
  T Tsf, Tsn[S], Tin[L];
  if (first) {
    start_iterate(c, Tsf, Tsn, Tin, k);
    write_iterate<T, S, L>(out, N, n, Tsf, Tsn, Tin);
  } else {
    read_iterate<T, S, L>(out, N, n, Tsf, Tsn, Tin);
  }
  const Fluxes<T> f = surface_fluxes(Tsf, c, k);
  const T ki0 = k_ice(Tin[0], 0, conduct, k);
  const T kib = k_ice(Tin[L - 1], L - 1, conduct, k);
  const T kh_sfc =
      c.snow ? rcp(c.hslyr_p) * k.k[K_KS2] : (ki0 * T(2)) / c.hilyr;
  const T Ttop = c.snow ? Tsn[0] : Tin[0];
  T ei_s = T(0), ei_i = T(0), ef_s = T(0), ef_i = T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const T qn = c.snow ? q_snow(Tsn[s], k) : c.qsno[s];
    out[(O_LAYERS + S + L + s) * (long long)N + n] = qn;
    ei_s = ei_s + c.qsno[s] * c.hslyr;
    ef_s = ef_s + qn * c.hslyr;
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const T qn = q_ice(Tin[i], i, k);
    out[(O_LAYERS + 2 * S + L + i) * (long long)N + n] = qn;
    ei_i = ei_i + c.qice[i] * c.hilyr;
    ef_i = ef_i + qn * c.hilyr;
  }
  const long long NN = N;
  out[O_FSURF * NN + n] = f.fsurf;
  out[O_FCONDTOP * NN + n] = kh_sfc * (Tsf - Ttop);
  out[O_FCONDBOT * NN + n] = ((kib * T(2)) / c.hilyr) * (Tin[L - 1] - c.Tbot);
  out[O_FSENS * NN + n] = f.fsens;
  out[O_FLAT * NN + n] = f.flat;
  out[O_FLWOUT * NN + n] = f.flwout;
  out[O_EINIT * NN + n] = ei_s + ei_i;
  out[O_EFINAL * NN + n] = ef_s + ef_i;
  out[O_KEFF * NN + n] = kh_sfc;
}

// the block's largest change into `slot` (one atomic a block)
__device__ __forceinline__ void block_max_to(unsigned long long* slot,
                                             unsigned long long m) {
  __shared__ unsigned long long warp_max[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(slot, m);
  }
  __syncthreads();
}

// All blocks meet (as K1's persistent route does, csrc/evp_fused.cu):
// `counter` counts arrivals since the launch, `target` ends this meeting.
// Thread 0 arrives with a release and waits with acquires between two
// block barriers, so every block's atomics before the meeting are visible
// to every thread after it (read past L1).
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

// One kernel for every route. `ws`: [0] the barrier's counter (low word),
// [1] the pass count (low word), [2 + p] pass p's largest change; zeroed
// by the caller. From pass p0 it runs passes while p < nit. With `coop`
// (a cooperative launch) every block meets after each pass and all stop
// at the first pass whose change is not above TSF_ERRMAX; then the
// epilogue. Without it the launch runs one pass and returns (p0 < nit), or
// only the epilogue after p0 passes (p0 == nit).
template <typename T, int S, int L>
__global__ void __launch_bounds__(THREADS)
    bl99_kernel(Inputs in, T* out, Consts<T> k, int N, int P, int p0, int nit,
                int coop, int conduct, unsigned long long* ws) {
  unsigned* counter = reinterpret_cast<unsigned*>(ws);
  unsigned long long* slots = ws + 2;
  const int stride = gridDim.x * blockDim.x;
  const int n0 = blockIdx.x * blockDim.x + threadIdx.x;
  int p = p0;
  while (p < nit) {
    unsigned long long m = 0;
    for (int n = n0; n < N; n += stride)
      m = max(m, column_pass<T, S, L>(in, out, k, N, P, n, p == 0, conduct));
    block_max_to(slots + p, m);
    ++p;
    if (!coop) return;
    grid_barrier(counter, (unsigned)(p - p0) * gridDim.x);
    if (!(from_bits<T>(__ldcg(slots + p - 1)) > k.k[K_ERRMAX])) break;
  }
  if (n0 == 0) *reinterpret_cast<int*>(ws + 1) = p;
  for (int n = n0; n < N; n += stride)
    column_finish<T, S, L>(in, out, k, N, P, n, p == 0, conduct);
}

template <typename T, int S_, int L_>
struct Shape {
  using type = T;
  static constexpr int S = S_, L = L_;
};

// the (nslyr, nilyr) the library is built for: CICE's default 1 x 7, the
// snow option sets' 3 x 7 and 5 x 7, boxadv's 1 x 1
#define BL99_SHAPES(X) X(1, 7) X(3, 7) X(5, 7) X(1, 1)
constexpr int ERR_SHAPE = -1;

template <typename F>
int dispatch(int f64, int S, int L, F&& f) {
#define BL99_TRY(s, l)                                          \
  if (S == s && L == l)                                         \
    return f64 ? f(Shape<double, s, l>()) : f(Shape<float, s, l>());
  BL99_SHAPES(BL99_TRY)
#undef BL99_TRY
  return ERR_SHAPE;
}

Inputs make_inputs(const void* const* ptrs, const long long* cs, int nin) {
  Inputs in = {};
  for (int i = 0; i < nin && i < MAX_IN; ++i) {
    in.p[i] = ptrs[i];
    in.cs[i] = cs[i];
  }
  return in;
}

// `consts`: N_K scalars, then N_LK rows of L layer values, each already
// rounded to the dtype
template <typename T>
Consts<T> make_consts(const double* v, int L) {
  Consts<T> k = {};
  for (int i = 0; i < N_K; ++i) k.k[i] = (T)v[i];
  for (int j = 0; j < N_LK; ++j)
    for (int i = 0; i < L; ++i) k.l[j][i] = (T)v[N_K + j * L + i];
  return k;
}


}  // namespace

// What the card offers the kernel of one instance in a cooperative launch:
// info[0] SMs, info[1] blocks resident per SM, info[2] registers per
// thread, info[3] threads per block, info[4] whether the device takes
// cooperative launches. Returns -1 for an (nslyr, nilyr) the library is
// not built for, else the first CUDA error (0 = success).
extern "C" int bl99_info(int f64, int nslyr, int nilyr, int* info) {
  return dispatch(f64, nslyr, nilyr, [&](auto shape) -> int {
    using D = decltype(shape);
    using T = typename D::type;
    const void* fn = (const void*)bl99_kernel<T, D::S, D::L>;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    cudaDeviceProp prop;
    e = cudaGetDeviceProperties(&prop, dev);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      0);
    if (e != cudaSuccess) return (int)e;
    int coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    info[0] = prop.multiProcessorCount;
    info[1] = per_sm;
    info[2] = attr.numRegs;
    info[3] = THREADS;
    info[4] = coop;
    return 0;
  });
}

// One launch of `blocks` blocks (bl99_kernel says what it runs): `ptrs`/
// `cs` the inputs, `out` the output planes (N elements each), `consts` as
// make_consts reads them, `ws` 2 + nit zeroed 64-bit words. With `coop`
// a cooperative launch, which the card refuses (an error, nothing runs)
// when the blocks cannot all be resident.
extern "C" int bl99_solve(int f64, int nslyr, int nilyr,
                          const void* const* ptrs, const long long* cs,
                          void* out, const double* consts, int N, int P,
                          int p0, int nit, int coop, int conduct, void* ws,
                          int blocks, void* stream) {
  return dispatch(f64, nslyr, nilyr, [&](auto shape) -> int {
    using D = decltype(shape);
    using T = typename D::type;
    Inputs in = make_inputs(ptrs, cs, I_LAYERS + D::S + 2 * D::L);
    Consts<T> k = make_consts<T>(consts, D::L);
    T* o = static_cast<T*>(out);
    unsigned long long* w = static_cast<unsigned long long*>(ws);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (coop) {
      void* args[] = {&in, &o, &k, &N, &P, &p0, &nit, &coop, &conduct, &w};
      cudaError_t e = cudaLaunchCooperativeKernel(
          (const void*)bl99_kernel<T, D::S, D::L>, dim3(blocks),
          dim3(THREADS), args, 0, st);
      if (e != cudaSuccess) return (int)e;
    } else {
      bl99_kernel<T, D::S, D::L><<<blocks, THREADS, 0, st>>>(
          in, o, k, N, P, p0, nit, coop, conduct, w);
    }
    return (int)cudaGetLastError();
  });
}
