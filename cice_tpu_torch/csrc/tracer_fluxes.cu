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
// masked edge area; built with -fmad=false it equals that path bit for bit.
//
// What bounds it on the H100: it must read the 120 moment planes, the 3
// mass reconstruction planes per category and for open water, 2 edge-area
// planes and, for the cells some donor candidate with a moment takes from,
// the 3*NT reconstruction planes per category; and write 2 x (ncat*NT +
// ncat + 1) flux planes, zeros included: ~0.23 GB at gx1 with NT=25 where
// the ice moves in the polar caps, 0.38 GB where every candidate counts,
// 0.07-0.11 ms at 3.35 TB/s. Its arithmetic is < 1 GFLOP; bytes bind.
//
// Design: one block per 2-D tile of 32 x 2 cells that walks all categories
// itself, one THREAD PER (cell, edge family): a warp is 32 cells of one row
// of one family, so every load and store of a warp is one coalesced row.
//  - Each thread reads its edge's 60 moments once and keeps a bit per donor
//    candidate whose 10 moments are not all zero. A candidate without a
//    moment adds exact zeros to every sum (for finite fields: each sum
//    starts at +0, and adding +-0 changes no bit), so it is left out with
//    its donor loads. A block where no candidate counts (still ice, open
//    water, land: most of the globe) writes every flux plane of its tile
//    as the signed zero (-0)*area with 16-byte stores and is done.
//  - Otherwise the donor values come from shared memory: the tile plus a
//    one-cell ring ((TX+2) x (TY+2) cells; OFFS_N reaches a row north and a
//    column either side, OFFS_E a row either side and a column east).
//    Only the ring cells that a candidate with a moment reads are staged,
//    from an ordered list built once per block with their 32-bit plane
//    indices, the east-west wrap and the zero ghost (a zero-filling
//    cp.async) resolved there; a thread keeps its own list entry in
//    registers. The plane groups (the open-water mass row, then per
//    category its mass row and its tracers' (tc, tx, ty), type 3 tc alone)
//    are staged `chunk` groups at a time (8 by default) by cp.async into 3
//    buffers, one barrier per chunk: the next chunks' copies fly while this
//    one is computed, and never all NT at once, so any table fits.
//  - The moments come from DRAM once per tile: the categories are a loop
//    inside the block, so a category's re-read of a candidate's 10 moments
//    (when it forms that category's 36 moment sums C[6][6] from its mass
//    reconstruction) hits L1/L2.
//  - Tracers go by in the dependency order of the table (each parent
//    followed by its children, from kernels/remap.py `flux_order`), so the
//    chain sums are kept in registers per candidate: a type-1 tracer with
//    dependents keeps its triple (s1, s2, s3), its type-2 children use it,
//    and a type-2 tracer with dependents keeps its own term for its type-3
//    children, as the TPU kernel's `parent_sums` / `pg3` do. Two type-2
//    tracers without dependents that follow each other (hi's 16 children)
//    share one pass over the candidates, each with its own sum in CANDS
//    order: the pass's control is paid once for both (runs of four were
//    slower).
//  - What binds the time is each thread's serial instruction stream over
//    the 1 + ncat*(NT+1) groups of its tile (16 warps per SM at 128
//    registers), not bytes.
// Nothing is allocated here; the launch goes on the caller's stream.
//
// Boundaries: east-west cyclic or zero ghost; north-south zero ghost
// (open/closed), matching the zero-ghost `shift` of the plain path.

#include <cuda_runtime.h>

namespace {

constexpr int NMOM = 10;
constexpr int TX = 32;                 // tile width: a warp per tile row
constexpr int TY = 2;                  // tile rows
constexpr int THREADS = 2 * TX * TY;   // a thread per (cell, edge family)
constexpr int STAGES = 3;              // staging buffers of `chunk` groups
constexpr int RX = TX + 2, R = RX * (TY + 2);   // the ring tile's cells
// a thread keeps up to 2 entries of the list of needed ring cells
static_assert(R <= 2 * THREADS, "ring tile larger than 2 cells per thread");
// donor offsets (dj, di) per candidate, in remap_exact.CANDS order
__constant__ int OFF_N[6][2] = {{1, -1}, {1, 0}, {1, 1},
                                {0, -1}, {0, 0}, {0, 1}};
__constant__ int OFF_E[6][2] = {{-1, 1}, {0, 1}, {1, 1},
                                {-1, 0}, {0, 0}, {1, 0}};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float *tstack, *mc, *mx, *my, *mom_n, *mom_e, *afn, *afe;
  const int2* order;   // per position: tracer, type | has_dependents << 2
  float *mflxe, *mflxn, *mtflxe, *mtflxn;
  int ncat, NT, ny, nx, xcyc, chunk;
};

// Every flux plane of the tile as (-0)*area: what a sum with no term gives.
__device__ void write_zero_tile(const Args& a, int i0, int j0, int P) {
  const int tid = threadIdx.x;
  const int nplane = a.ncat + 1 + a.ncat * a.NT;      // per family
  const bool vec = (a.nx & 3) == 0;                    // rows 16-byte aligned
  const int w = vec ? 4 : 1, nq = TX / w;
  const int per_plane = 2 * TY * nq;
  for (int q = tid; q < nplane * per_plane; q += THREADS) {
    const int pl = q / per_plane;
    int rem = q - pl * per_plane;
    const int fam = rem / (TY * nq);
    rem -= fam * TY * nq;
    const int row = rem / nq;
    const int j = j0 + row, i = i0 + (rem - row * nq) * w;
    if (j >= a.ny || i >= a.nx) continue;
    const int h = j * a.nx + i;
    const float* af = fam ? a.afe : a.afn;
    float* base = pl <= a.ncat
                      ? (fam ? a.mflxe : a.mflxn) + (size_t)pl * P
                      : (fam ? a.mtflxe : a.mtflxn) +
                            (size_t)(pl - a.ncat - 1) * P;
    if (vec) {
      *reinterpret_cast<float4*>(base + h) =
          make_float4((-0.f) * af[h], (-0.f) * af[h + 1],
                      (-0.f) * af[h + 2], (-0.f) * af[h + 3]);
    } else {
      base[h] = (-0.f) * af[h];
    }
  }
}

// At most 128 registers per thread, so that 4 blocks share an SM, stated as
// a bound of 4 blocks' threads: ptxas then allocates without spills, where
// __launch_bounds__(THREADS, 4) spilled and was 2-4% slower (PERF.md).
__global__ void __launch_bounds__(4 * THREADS)
    tracer_fluxes_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_wcnt[THREADS / 32];
  const int nx = a.nx, ny = a.ny, NT = a.NT;
  const int T = TX * TY;
  const int P = ny * nx;
  const int nthr = THREADS, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;

  // shared layout: STAGES buffers of `chunk` plane groups of 3 ring planes
  // each; the ordered list of the needed ring cells (ring position, plane
  // index or -1 outside the domain); a flag per ring cell
  float* s_buf = smem;
  int* s_lr = reinterpret_cast<int*>(smem + STAGES * a.chunk * 3 * R);
  int* s_lg = s_lr + R;
  int* s_need = s_lg + R;

  // ---- this thread's edge: family N for the first T threads, then E ----
  const int fam = tid >= T;            // 0: N, 1: E
  const int cell = tid - fam * T;
  const int clj = cell / TX, cli = cell - clj * TX;
  const int j = j0 + clj, i = i0 + cli;
  const bool on = j < ny && i < nx;
  const int home = on ? j * nx + i : 0;
  const float* __restrict__ mom = (fam ? a.mom_e : a.mom_n) + home;
  const float af = on ? (fam ? a.afe : a.afn)[home] : 0.f;
  const int rb = (clj + 1) * RX + (cli + 1);
  int doff[6];
#pragma unroll
  for (int ci = 0; ci < 6; ++ci)
    doff[ci] = fam ? OFF_E[ci][0] * RX + OFF_E[ci][1]
                   : OFF_N[ci][0] * RX + OFF_N[ci][1];

  for (int r = tid; r < R; r += nthr) s_need[r] = 0;
  unsigned active = 0;
  if (on) {
    // which candidates count: 60 independent loads in flight at once
#pragma unroll
    for (int ci = 0; ci < 6; ++ci) {
      bool act = false;
#pragma unroll
      for (int q = 0; q < NMOM; ++q)
        act |= __ldg(mom + (size_t)(ci * NMOM + q) * P) != 0.0f;
      active |= (act ? 1u : 0u) << ci;
    }
  }
  __syncthreads();
#pragma unroll
  for (int ci = 0; ci < 6; ++ci)
    if (active >> ci & 1) s_need[rb + doff[ci]] = 1;
  if (!__syncthreads_or(active != 0)) {
    write_zero_tile(a, i0, j0, P);
    return;
  }

  // ---- the ordered list of needed ring cells -----------------------------
  int nneed = 0;
  for (int base = 0; base < R; base += nthr) {
    const int r = base + tid;
    const bool f = r < R && s_need[r];
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_wcnt[warp] = __popc(b);
    __syncthreads();
    int off = nneed, tot = nneed;
    for (int w = 0; w < nthr / 32; ++w) {
      off += w < warp ? s_wcnt[w] : 0;
      tot += s_wcnt[w];
    }
    if (f) {
      const int k = off + __popc(b & ((1u << lane) - 1u));
      const int rj = r / RX, ri = r - rj * RX;
      const int jr = j0 - 1 + rj;
      int ir = i0 - 1 + ri;
      if (a.xcyc) ir = ir < 0 ? ir + nx : (ir >= nx ? ir - nx : ir);
      s_lr[k] = r;
      s_lg[k] = (jr < 0 || jr >= ny || ir < 0 || ir >= nx) ? -1
                                                           : jr * nx + ir;
    }
    nneed = tot;
    __syncthreads();
  }
  // this thread's entries of the list, q = tid and tid + nthr (ring
  // position, -1: none; plane index, -1: outside the domain)
  int lr[2], lg[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int q = tid + u * nthr;
    lr[u] = q < nneed ? s_lr[q] : -1;
    lg[u] = q < nneed ? s_lg[q] : -1;
  }

  // ---- the plane groups: 0 the open-water mass row; then per category
  // its mass row and its tracers in `order`. They are staged CHUNK at a
  // time, one barrier per chunk, into STAGES chunk buffers -----------------
  const int per_cat = NT + 1;
  const int ngroup = 1 + a.ncat * per_cat;
  const int nchunk = (ngroup + a.chunk - 1) / a.chunk;
  const int gsz = 3 * R;                         // floats per group slot
  // group g -> (c, k): k = 0 the category's mass row, k > 0 tracer
  // order[k-1]; the open-water group is (-1, 0)
  auto first = [&](int g, int& c, int& k) {
    if (g == 0) {
      c = -1; k = 0;
    } else {
      c = (g - 1) / per_cat; k = (g - 1) - c * per_cat;
    }
  };
  auto next = [&](int& c, int& k) {
    if (c < 0 || ++k == per_cat) { ++c; k = 0; }
  };
  auto fetch_chunk = [&](int ch) {
    if (ch < nchunk) {
      float* buf = s_buf + (size_t)(ch % STAGES) * a.chunk * gsz;
      int c, k;
      const int g0 = ch * a.chunk, g1 = min(g0 + a.chunk, ngroup);
      first(g0, c, k);
      for (int g = g0; g < g1; ++g, next(c, k)) {
        const float* pl[3];
        int np = 3;
        if (k == 0) {
          const size_t o = (size_t)(c + 1) * P;
          pl[0] = a.mc + o; pl[1] = a.mx + o; pl[2] = a.my + o;
        } else {
          const int2 e = __ldg(a.order + k - 1);
          const float* tn = a.tstack + ((size_t)c * 3 * NT + e.x) * P;
          pl[0] = tn; pl[1] = tn + (size_t)NT * P;
          pl[2] = tn + (size_t)2 * NT * P;
          if ((e.y & 3) == 3) np = 1;
        }
        float* gb = buf + (g - g0) * gsz;
        for (int p = 0; p < np; ++p)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (lr[u] >= 0)
              cp_async4(gb + p * R + lr[u], pl[p] + (lg[u] < 0 ? 0 : lg[u]),
                        lg[u] >= 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < STAGES - 1; ++ch) fetch_chunk(ch);

  float C[6][6];
  float P1[6], P2[6], P3[6], Q[6];   // kept chain sums per candidate
#pragma unroll
  for (int ci = 0; ci < 6; ++ci) {
    P1[ci] = P2[ci] = P3[ci] = Q[ci] = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) C[ci][q] = 0.f;
  }
  float* __restrict__ mflx = fam ? a.mflxe : a.mflxn;
  float* __restrict__ mtflx = fam ? a.mtflxe : a.mtflxn;

  for (int ch = 0; ch < nchunk; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch_chunk(ch + STAGES - 1);
    const float* buf = s_buf + (size_t)(ch % STAGES) * a.chunk * gsz + rb;
    int c, k;
    const int g0 = ch * a.chunk, g1 = min(g0 + a.chunk, ngroup);
    first(g0, c, k);
    for (int g = g0; g < g1; ++g, next(c, k)) {
      const float* b0 = buf + (g - g0) * gsz;
      const float* b1 = b0 + R;
      const float* b2 = b1 + R;
      if (k == 0) {
        // a mass row: open water (c = -1) gives its msum; a category its
        // 36 moment sums per candidate and its msum
        // branch-free, so that the 60 moment loads go out together: a
        // candidate without a moment has 10 moments of +-0 and takes 0 for
        // its donor's (unstaged) values, so its sums are +-0 and add nothing
        float macc = 0.f;
#pragma unroll
        for (int ci = 0; ci < 6; ++ci) {
          const bool onc = active >> ci & 1;
          const int d = doff[ci];
          const float* mp = mom + (size_t)ci * NMOM * P;
          const float mi = onc ? b0[d] : 0.f, mxi = onc ? b1[d] : 0.f,
                      myi = onc ? b2[d] : 0.f;
          if (c < 0) {
            macc = macc + (mi * __ldg(mp) + mxi * __ldg(mp + P) +
                           myi * __ldg(mp + (size_t)2 * P));
            continue;
          }
          float m[NMOM];
#pragma unroll
          for (int q = 0; q < NMOM; ++q) m[q] = __ldg(mp + (size_t)q * P);
          // MONO order: 00,10,01,20,11,02,30,21,12,03
          C[ci][0] = mi * m[0] + mxi * m[1] + myi * m[2];   // msum
          C[ci][1] = mi * m[1] + mxi * m[3] + myi * m[4];   // mxsum
          C[ci][2] = mi * m[2] + mxi * m[4] + myi * m[5];   // mysum
          C[ci][3] = mi * m[3] + mxi * m[6] + myi * m[7];   // mxxsum
          C[ci][4] = mi * m[4] + mxi * m[7] + myi * m[8];   // mxysum
          C[ci][5] = mi * m[5] + mxi * m[8] + myi * m[9];   // myysum
          macc = macc + C[ci][0];
        }
        if (on) mflx[(size_t)(c + 1) * P + home] = (-macc) * af;
        continue;
      }
      const int2 e = __ldg(a.order + k - 1);
      const int tt = e.y & 3;
      const bool dep = e.y >> 2;
      // two type-2 tracers without dependents next to each other in the
      // chunk (hi's 16 children) share their parent's kept sums: one pass
      // over the candidates sums both, each in CANDS order
      const int2 e2 = tt == 2 && !dep && g + 1 < g1 && k + 1 < per_cat
                          ? __ldg(a.order + k)
                          : make_int2(0, 0);
      if (e2.y == 2) {
        const float* u0 = b0 + gsz;
        const float *u1 = u0 + R, *u2 = u1 + R;
        float acc1 = 0.f, acc2 = 0.f;
#pragma unroll
        for (int ci = 0; ci < 6; ++ci) {
          if (!(active >> ci & 1)) continue;
          const int d = doff[ci];
          acc1 = acc1 + (P1[ci] * b0[d] + P2[ci] * b1[d] + P3[ci] * b2[d]);
          acc2 = acc2 + (P1[ci] * u0[d] + P2[ci] * u1[d] + P3[ci] * u2[d]);
        }
        if (on) {
          mtflx[((size_t)c * NT + e.x) * P + home] = (-acc1) * af;
          mtflx[((size_t)c * NT + e2.x) * P + home] = (-acc2) * af;
        }
        ++g;
        next(c, k);
        continue;
      }
      float acc = 0.f;
#pragma unroll
      for (int ci = 0; ci < 6; ++ci) {
        if (!(active >> ci & 1)) continue;
        const int d = doff[ci];
        const float t0 = b0[d];
        float mts;
        if (tt == 1) {
          const float t1 = b1[d], t2 = b2[d];
          mts = C[ci][0] * t0 + C[ci][1] * t1 + C[ci][2] * t2;
          if (dep) {
            P1[ci] = mts;
            P2[ci] = C[ci][1] * t0 + C[ci][3] * t1 + C[ci][4] * t2;
            P3[ci] = C[ci][2] * t0 + C[ci][4] * t1 + C[ci][5] * t2;
          }
        } else if (tt == 2) {
          const float t1 = b1[d], t2 = b2[d];
          mts = P1[ci] * t0 + P2[ci] * t1 + P3[ci] * t2;
          if (dep) Q[ci] = mts;
        } else {
          mts = Q[ci] * t0;
        }
        acc = acc + mts;
      }
      if (on) mtflx[((size_t)c * NT + e.x) * P + home] = (-acc) * af;
    }
  }
  cp_async_wait<0>();
}

// Dynamic shared memory of one block with `chunk` plane groups per
// buffer: STAGES buffers of 3 ring planes per group and 3 ints per ring
// cell.
long smem_bytes(int chunk) { return 4L * (3L * STAGES * chunk + 3L) * R; }

cudaError_t launch(const Args& a, cudaStream_t stream, bool run, int* info) {
  if (a.chunk < 1) return cudaErrorInvalidValue;
  const long smem = smem_bytes(a.chunk);
  cudaError_t e = cudaFuncSetAttribute(
      tracer_fluxes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  if (!run) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, tracer_fluxes_kernel);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tracer_fluxes_kernel, THREADS, (size_t)smem);
    if (e != cudaSuccess) return e;
    info[0] = attr.numRegs;
    info[1] = (int)attr.sharedSizeBytes;
    info[2] = attr.maxThreadsPerBlock;
    info[3] = per_sm;
    return cudaSuccess;
  }
  const dim3 grid((a.nx + TX - 1) / TX, (a.ny + TY - 1) / TY);
  tracer_fluxes_kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// info[0] registers per thread, info[1] static shared memory, info[2] the
// most threads a block may have, info[3] blocks resident per SM with
// `chunk` plane groups per buffer.
extern "C" int tracer_fluxes_info(int chunk, int* info) {
  Args a{};
  a.chunk = chunk;
  return (int)launch(a, nullptr, false, info);
}

// One flux pass. Shapes (all f32 / int32 contiguous on the device): tstack
// (ncat, 3*NT, ny, nx) = [tc | tx | ty]; mc, mx, my (ncat+1, ny, nx), row
// 0 open water; mom_n, mom_e (6, 10, ny, nx); afn, afe (ny, nx) masked
// edge areas; order (NT, 2) int32 from kernels/remap.py `flux_order`.
// Outputs mflxe, mflxn (ncat+1, ny, nx) and mtflxe, mtflxn (ncat, NT, ny,
// nx). `chunk` plane groups are staged per barrier. Returns the launch's
// CUDA error (0 = success).
extern "C" int tracer_fluxes(const float* tstack, const float* mc,
                             const float* mx, const float* my,
                             const float* mom_n, const float* mom_e,
                             const float* afn, const float* afe,
                             const int* order, float* mflxe, float* mflxn,
                             float* mtflxe, float* mtflxn, int ncat, int NT,
                             int ny, int nx, int xcyc, int chunk,
                             void* stream) {
  const Args a{tstack, mc, mx, my, mom_n, mom_e, afn, afe,
               reinterpret_cast<const int2*>(order), mflxe, mflxn, mtflxe,
               mtflxn, ncat, NT, ny, nx, xcyc, chunk};
  return (int)launch(a, static_cast<cudaStream_t>(stream), true, nullptr);
}
