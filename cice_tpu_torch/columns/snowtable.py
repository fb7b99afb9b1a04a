"""Snow-aging lookup table (snw_aging_table): tabulated dry-metamorphism
rates (PyTorch port of cice_tpu/columns/snowtable.py).

The table gives the initial grain-growth rate drdt0 (um/hr) as a function
of snow temperature, vertical temperature gradient and density; evolution
follows the SNICAR best fit dr/dt = drdt0 * (tau / (r - r0 + tau))^(1/kappa)
(Flanner & Zender 2006). The 'test' table is generated from that
functional form on the reference's 11x31x8 grid; a 'file' table loads the
three axes and drdt0[, tau, kappa] from an .npz or netCDF file. The lookup
is trilinear: each axis is searched (searchsorted, left side), and its
index pair and weight gather the eight corners.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SnowTable:
    T: tuple          # snow temperature axis (degC), ascending
    Tgrd: tuple       # |dT/dz| axis (K/m), ascending
    rhos: tuple       # density axis (kg/m^3), ascending
    drdt0: np.ndarray   # (nT, nTgrd, nrhos) um/hr
    tau: np.ndarray     # same shape (um)
    kappa: np.ndarray   # same shape


def make_test_table() -> SnowTable:
    """The built-in 'test' table: the reference's 11x31x8 grid and ranges,
    filled from the Flanner-Zender fit so that no data file is needed."""
    T = np.linspace(-57.55, 1.75, 11)            # degC
    Tgrd = np.linspace(0.0, 300.0, 31)           # K/m
    rhos = np.linspace(50.0, 400.0, 8)           # kg/m^3
    TT, GG, RR = np.meshgrid(T, Tgrd, rhos, indexing="ij")
    TK = TT + 273.15
    # FZ06 best-fit shape: Arrhenius in T, near-linear in gradient, weak
    # density dependence
    drdt0 = (1.0e5 * np.exp(-3700.0 / TK) * (1.0 + GG / 100.0)
             * (1.0 - 0.2 * (RR - 50.0) / 350.0))
    tau = np.full_like(drdt0, 8.0)
    kappa = np.full_like(drdt0, 0.58)
    return SnowTable(tuple(T), tuple(Tgrd), tuple(rhos), drdt0, tau, kappa)


def load_table_file(path: str) -> SnowTable:
    """snw_aging_table='file': axes snw_T/snw_Tgrd/snw_rhos and
    drdt0[, tau, kappa] from .npz or netCDF."""
    if path.endswith(".nc"):
        from scipy.io import netcdf_file
        with netcdf_file(path, "r", mmap=False) as f:
            g = lambda n: np.array(f.variables[n][:], np.float64)
            T, Tgrd, rhos = g("snw_T"), g("snw_Tgrd"), g("snw_rhos")
            drdt0 = g("drdt0")
            tau = g("tau") if "tau" in f.variables \
                else np.full_like(drdt0, 8.0)
            kappa = g("kappa") if "kappa" in f.variables \
                else np.full_like(drdt0, 0.58)
    else:
        with np.load(path) as z:
            T, Tgrd, rhos = z["snw_T"], z["snw_Tgrd"], z["snw_rhos"]
            drdt0 = z["drdt0"]
            tau = z["tau"] if "tau" in z else np.full_like(drdt0, 8.0)
            kappa = z["kappa"] if "kappa" in z else np.full_like(drdt0, 0.58)
    return SnowTable(tuple(np.asarray(T, np.float64)),
                     tuple(np.asarray(Tgrd, np.float64)),
                     tuple(np.asarray(rhos, np.float64)),
                     np.asarray(drdt0, np.float64),
                     np.asarray(tau, np.float64),
                     np.asarray(kappa, np.float64))


#: device copies of the tables: {(kind, path, file stamp, dtype, device):
#: (axes, (drdt0, tau, kappa))}. The key holds the file's modification
#: time and size, so a rewritten file is read again.
_DEVICE_TABLES: dict = {}


def device_table(kind: str, path: str, dtype, device):
    """The table of snw_aging_table=`kind` ('file' reads `path`, any other
    kind the test table) as tensors of `dtype` on `device`: the three axes
    and (drdt0, tau, kappa). Read and uploaded once per file version."""
    use_file = kind == "file" and bool(path)
    stamp = None
    if use_file:
        st = os.stat(path)
        stamp = (st.st_mtime_ns, st.st_size)
    key = (use_file, path if use_file else "", stamp, dtype, str(device))
    if key not in _DEVICE_TABLES:
        tab = load_table_file(path) if use_file else make_test_table()
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                      device=device)
        _DEVICE_TABLES[key] = ((t(tab.T), t(tab.Tgrd), t(tab.rhos)),
                               (t(tab.drdt0), t(tab.tau), t(tab.kappa)))
    return _DEVICE_TABLES[key]


def _axis_weights(x, ax: torch.Tensor):
    """Index pair and lerp weight on an ascending axis."""
    i1 = torch.clamp(torch.searchsorted(ax, x.contiguous()), 1, len(ax) - 1)
    i0 = i1 - 1
    x0, x1 = ax[i0], ax[i1]
    w = torch.clamp((x - x0) / torch.clamp(x1 - x0, min=1e-30), 0.0, 1.0)
    return i0, i1, w


def table_aging_rate(axes, arrays, Tsno, Tgrd, rhos, rsnw, rsnw_fall):
    """dr/dt (um/s) by trilinear table lookup and the FZ06 radius kernel.
    `axes`, `arrays`: a `device_table`; the rest broadcast to one shape."""
    Tsno, Tgrd, rhos = torch.broadcast_tensors(Tsno, Tgrd, rhos)
    i0, i1, wa = _axis_weights(Tsno, axes[0])
    j0, j1, wb = _axis_weights(Tgrd, axes[1])
    k0, k1, wc = _axis_weights(rhos, axes[2])

    def tri(A):
        c00 = A[i0, j0, k0] * (1 - wc) + A[i0, j0, k1] * wc
        c01 = A[i0, j1, k0] * (1 - wc) + A[i0, j1, k1] * wc
        c10 = A[i1, j0, k0] * (1 - wc) + A[i1, j0, k1] * wc
        c11 = A[i1, j1, k0] * (1 - wc) + A[i1, j1, k1] * wc
        c0 = c00 * (1 - wb) + c01 * wb
        c1 = c10 * (1 - wb) + c11 * wb
        return c0 * (1 - wa) + c1 * wa

    D, TAU, KAP = arrays
    drdt0 = tri(D)                        # um/hr at r = r0
    tau = torch.clamp(tri(TAU), min=1e-6)
    kappa = torch.clamp(tri(KAP), min=1e-6)
    dr = torch.clamp(rsnw - rsnw_fall, min=0.0)
    rate = drdt0 * (tau / (dr + tau)) ** (1.0 / kappa)    # um/hr
    return rate / 3600.0                                   # um/s
