// Flux-only exact incremental-remapping kernel for NVIDIA Hopper (sm_90a),
// f32.
//
// Replaces the TPU kernel cice_tpu/kernels/remap_pallas.py
// (`tracer_fluxes_fused`, pallas_call at line 261, body `_kernel_body`):
// from the reconstructed fields of `construct_fields` it computes the mass
// transports and the mass*tracer transports across the N and E edge of
// every cell, summed over the 6 donor candidates of each edge family, with
// the type-1/2/3 tracer dependency chains of the flat tracer table. The
// arithmetic mirrors the plain PyTorch path
// (cice_tpu_torch/dynamics/remap_exact.py `_family_fluxes`): same
// expressions, candidates summed in CANDS order, sign -1, scaled by the
// masked edge area.
//
// What bounds it on the H100: it must read the reconstruction stack
// (3*NT planes per category), the mass reconstruction (3 planes per
// category and for open water), the 120 moment planes and 2 edge-area
// planes, and write 2 x (ncat*NT + ncat + 1) flux planes: ~0.38 GB at gx1
// with NT=25, 0.11 ms at 3.35 TB/s. Its arithmetic is ~3.6 GFLOP, 0.05 ms
// at the f32 peak, so bytes bind.
//
// Design: one thread per (cell, category); no shared memory. The TPU
// kernel's pre-ghosted, lane-padded window packs serve VMEM and do not
// come across: every input is read in place, and the donor of candidate
// (dj, di) is the index (j+dj, i+di), wrapped east-west when cyclic and
// zero outside the domain (the zero ghost of the plain path's `shift`).
// Per edge family a thread first forms the six moment sums C1..C6 of its
// category's mass reconstruction for each of the 6 candidates in registers
// (36 values) and the mass transport, then loops over the tracers,
// accumulating each tracer's candidate sum in one scalar. Parent and
// grandparent moment sums are recomputed per child. The open-water row is
// category-invariant: the category-0 threads compute it. The flat table
// (type, parent, grandparent) arrives as device arrays, so any NT runs
// without code generation. Nothing is allocated here; the launch goes on
// the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int NMOM = 10;
// donor offsets (dj, di) per candidate, in remap_exact.CANDS order
__constant__ int OFF_N[6][2] = {{1, -1}, {1, 0}, {1, 1},
                                {0, -1}, {0, 0}, {0, 1}};
__constant__ int OFF_E[6][2] = {{-1, 1}, {0, 1}, {1, 1},
                                {-1, 0}, {0, 0}, {1, 0}};

__device__ __forceinline__ float ldz(const float* __restrict__ a, long k) {
  return k < 0 ? 0.0f : a[k];
}

// (j, i) wrapped east-west when cyclic; -1 outside the domain
__device__ __forceinline__ long cell(int j, int i, int ny, int nx, int xcyc) {
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

__global__ void tracer_fluxes_kernel(
    const float* __restrict__ tstack, const float* __restrict__ mc,
    const float* __restrict__ mx, const float* __restrict__ my,
    const float* __restrict__ mom_n, const float* __restrict__ mom_e,
    const float* __restrict__ afn, const float* __restrict__ afe,
    const int* __restrict__ ttype, const int* __restrict__ par,
    const int* __restrict__ gpar, float* __restrict__ mflxe,
    float* __restrict__ mflxn, float* __restrict__ mtflxe,
    float* __restrict__ mtflxn, int ny, int nx, int xcyc, int NT) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (i >= nx || j >= ny) return;
  const long P = (long)ny * nx;
  const long home = (long)j * nx + i;

  const float* mcc = mc + (long)(c + 1) * P;
  const float* mxc = mx + (long)(c + 1) * P;
  const float* myc = my + (long)(c + 1) * P;
  const float* tc = tstack + (long)c * 3 * NT * P;   // plane n
  const float* tx = tc + (long)NT * P;
  const float* ty = tx + (long)NT * P;

  for (int fam = 0; fam < 2; ++fam) {
    const bool fam_n = fam == 0;
    const float* mom = fam_n ? mom_n : mom_e;
    const float af = fam_n ? afn[home] : afe[home];
    float* mflx = fam_n ? mflxn : mflxe;
    float* mtflx = (fam_n ? mtflxn : mtflxe) + (long)c * NT * P;

    float C[6][6];
    long dn[6];
    float macc = 0.f, macc0 = 0.f;
#pragma unroll
    for (int ci = 0; ci < 6; ++ci) {
      const int dj = fam_n ? OFF_N[ci][0] : OFF_E[ci][0];
      const int di = fam_n ? OFF_N[ci][1] : OFF_E[ci][1];
      const long d = cell(j + dj, i + di, ny, nx, xcyc);
      dn[ci] = d;
      float m[NMOM];
#pragma unroll
      for (int q = 0; q < NMOM; ++q)
        m[q] = mom[((long)ci * NMOM + q) * P + home];
      // MONO order: 00,10,01,20,11,02,30,21,12,03
      const float mi = ldz(mcc, d), mxi = ldz(mxc, d), myi = ldz(myc, d);
      C[ci][0] = mi * m[0] + mxi * m[1] + myi * m[2];   // msum
      C[ci][1] = mi * m[1] + mxi * m[3] + myi * m[4];   // mxsum
      C[ci][2] = mi * m[2] + mxi * m[4] + myi * m[5];   // mysum
      C[ci][3] = mi * m[3] + mxi * m[6] + myi * m[7];   // mxxsum
      C[ci][4] = mi * m[4] + mxi * m[7] + myi * m[8];   // mxysum
      C[ci][5] = mi * m[5] + mxi * m[8] + myi * m[9];   // myysum
      macc = macc + C[ci][0];
      if (c == 0)
        macc0 = macc0 +
                (ldz(mc, d) * m[0] + ldz(mx, d) * m[1] + ldz(my, d) * m[2]);
    }
    mflx[(long)(c + 1) * P + home] = (-macc) * af;
    if (c == 0) mflx[home] = (-macc0) * af;

    for (int n = 0; n < NT; ++n) {
      const int tt = ttype[n];
      const float* tcn = tc + (long)n * P;
      const float* txn = tx + (long)n * P;
      const float* tyn = ty + (long)n * P;
      float acc = 0.f;
      if (tt == 1) {
#pragma unroll
        for (int ci = 0; ci < 6; ++ci) {
          const long d = dn[ci];
          acc = acc + (C[ci][0] * ldz(tcn, d) + C[ci][1] * ldz(txn, d) +
                       C[ci][2] * ldz(tyn, d));
        }
      } else {
        const long po = (long)par[n] * P;
        const float *tcpl = tc + po, *txpl = tx + po, *typl = ty + po;
        if (tt == 2) {
#pragma unroll
          for (int ci = 0; ci < 6; ++ci) {
            const long d = dn[ci];
            const float tcp = ldz(tcpl, d), txp = ldz(txpl, d),
                        typ = ldz(typl, d);
            const float s1 = C[ci][0] * tcp + C[ci][1] * txp + C[ci][2] * typ;
            const float s2 = C[ci][1] * tcp + C[ci][3] * txp + C[ci][4] * typ;
            const float s3 = C[ci][2] * tcp + C[ci][4] * txp + C[ci][5] * typ;
            acc = acc +
                  (s1 * ldz(tcn, d) + s2 * ldz(txn, d) + s3 * ldz(tyn, d));
          }
        } else {
          const long go = (long)gpar[n] * P;
          const float *tcgl = tc + go, *txgl = tx + go, *tygl = ty + go;
#pragma unroll
          for (int ci = 0; ci < 6; ++ci) {
            const long d = dn[ci];
            const float tcg = ldz(tcgl, d), txg = ldz(txgl, d),
                        tyg = ldz(tygl, d);
            const float g1 = C[ci][0] * tcg + C[ci][1] * txg + C[ci][2] * tyg;
            const float g2 = C[ci][1] * tcg + C[ci][3] * txg + C[ci][4] * tyg;
            const float g3 = C[ci][2] * tcg + C[ci][4] * txg + C[ci][5] * tyg;
            acc = acc + (g1 * ldz(tcpl, d) + g2 * ldz(txpl, d) +
                         g3 * ldz(typl, d)) * ldz(tcn, d);
          }
        }
      }
      mtflx[(long)n * P + home] = (-acc) * af;
    }
  }
}

}  // namespace

// One flux pass. Shapes (all f32 / int32 contiguous on the device): tstack
// (ncat, 3*NT, ny, nx) = [tc | tx | ty]; mc, mx, my (ncat+1, ny, nx), row
// 0 open water; mom_n, mom_e (6, 10, ny, nx); afn, afe (ny, nx) masked
// edge areas; ttype, par, gpar (NT) int32. Outputs mflxe, mflxn
// (ncat+1, ny, nx) and mtflxe, mtflxn (ncat, NT, ny, nx). Returns the
// launch's CUDA error (0 = success).
extern "C" int tracer_fluxes(const float* tstack, const float* mc,
                             const float* mx, const float* my,
                             const float* mom_n, const float* mom_e,
                             const float* afn, const float* afe,
                             const int* ttype, const int* par,
                             const int* gpar, float* mflxe, float* mflxn,
                             float* mtflxe, float* mtflxn, int ncat, int NT,
                             int ny, int nx, int xcyc, void* stream) {
  const dim3 block(32, 4);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  ncat);
  tracer_fluxes_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tstack, mc, mx, my, mom_n, mom_e, afn, afe, ttype, par, gpar, mflxe,
      mflxn, mtflxe, mtflxn, ny, nx, xcyc, NT);
  return (int)cudaGetLastError();
}
