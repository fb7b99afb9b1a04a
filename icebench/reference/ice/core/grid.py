"""Model grid: construction, metric terms, masks, inter-grid averaging
(PyTorch port of cice_tpu/core/grid.py).

The metric derivation `_derive` runs on the host in float64 NumPy, exactly
as the JAX package does; the resulting `Grid` is a dataclass of tensors on
one device. Staggering: T(i,j) cell center; U(i,j) NE corner of T(i,j);
N(i,j) north face; E(i,j) east face.

Constructors (`make_grid`): `rect` (reference rectgrid), `latlon`
(latlongrid), the file-less `tripole` and `displaced_pole` stand-ins
(spherical metrics and the idealized land mask), and POP binary grid files
(`pop_bin`, io/grids.py), displaced-pole or tripole.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from .. import constants as cst
from ..constants import (FIELD_LOC_CENTER, FIELD_LOC_EFACE, FIELD_LOC_NECORNER,
                         FIELD_LOC_NFACE, FIELD_TYPE_SCALAR)
from .halo import BC, shift

#: every tensor field of Grid, in declaration order
GRID_FIELDS = ("ULAT", "ULON", "TLAT", "TLON", "HTN", "HTE",
               "dxT", "dyT", "dxU", "dyU", "dxN", "dyN", "dxE", "dyE",
               "tarea", "uarea", "narea", "earea", "tarear", "uarear",
               "dxhy", "dyhx", "cyp", "cxp", "cym", "cxm",
               "ANGLE", "ANGLET", "hm", "uvm", "npm", "epm", "bathymetry")


@dataclass(frozen=True)
class Grid:
    """Global grid: coordinates, metric terms, masks; all (ny, nx)."""

    ULAT: torch.Tensor
    ULON: torch.Tensor
    TLAT: torch.Tensor
    TLON: torch.Tensor
    HTN: torch.Tensor          # length of northern edge of T-cell (m)
    HTE: torch.Tensor          # length of eastern edge of T-cell (m)
    dxT: torch.Tensor
    dyT: torch.Tensor
    dxU: torch.Tensor
    dyU: torch.Tensor
    dxN: torch.Tensor
    dyN: torch.Tensor
    dxE: torch.Tensor
    dyE: torch.Tensor
    tarea: torch.Tensor
    uarea: torch.Tensor
    narea: torch.Tensor
    earea: torch.Tensor
    tarear: torch.Tensor
    uarear: torch.Tensor
    # B-grid variational-stress metric combinations (ice_dyn_shared.F90:411)
    dxhy: torch.Tensor
    dyhx: torch.Tensor
    cyp: torch.Tensor
    cxp: torch.Tensor
    cym: torch.Tensor
    cxm: torch.Tensor
    ANGLE: torch.Tensor        # at U points
    ANGLET: torch.Tensor       # at T points
    hm: torch.Tensor           # ocean mask at T points (float 0/1)
    uvm: torch.Tensor          # ocean mask at U points
    npm: torch.Tensor          # N-face mask
    epm: torch.Tensor          # E-face mask
    bathymetry: torch.Tensor   # m, positive depth
    bc: BC = BC()
    nx_global: int = 0
    ny_global: int = 0

    @property
    def tmask(self) -> torch.Tensor:
        return self.hm > 0.5

    @property
    def umask(self) -> torch.Tensor:
        return self.uvm > 0.5

    @property
    def shape(self):
        """The (ny, nx) of this grid's arrays."""
        return tuple(self.hm.shape[-2:])

    @property
    def global_shape(self):
        return (self.ny_global, self.nx_global)

    @property
    def device(self) -> torch.device:
        return self.hm.device

    @property
    def dtype(self) -> torch.dtype:
        return self.hm.dtype

    def fcor(self, where: str = "U", option: str = "latitude") -> torch.Tensor:
        """Coriolis parameter (1/s) — reference `fcor_blk`."""
        lat = {"U": self.ULAT, "T": self.TLAT}[where]
        if option == "constant":
            return torch.full_like(lat, 1.46e-4)
        if option == "zero":
            return torch.zeros_like(lat)
        return 2.0 * cst.omega * torch.sin(lat)


# ---------------------------------------------------------------------------
# construction helpers (host-side float64, identical to the JAX package)
# ---------------------------------------------------------------------------

def _np_shift(f: np.ndarray, dj: int, di: int, bc: BC,
              extrapolate: bool) -> np.ndarray:
    """Host-side neighbor access used during grid derivation; non-cyclic
    edges are filled by linear extrapolation (ice_HaloExtrapolate)."""
    ny, nx = f.shape
    g = f
    if di != 0:
        g = np.roll(g, -di, axis=1)
        if not bc.x_cyclic:
            if di > 0:
                for k in range(di):
                    col = nx - 1 - k
                    g[:, col] = (2.0 * g[:, col - 1] - g[:, col - 2]
                                 if extrapolate else 0.0)
            else:
                for k in range(-di):
                    g[:, k] = (2.0 * g[:, k + 1] - g[:, k + 2]
                               if extrapolate else 0.0)
    if dj != 0:
        g = np.roll(g, -dj, axis=0)
        if not bc.y_cyclic:
            if dj > 0:
                for k in range(dj):
                    row = ny - 1 - k
                    g[row, :] = (2.0 * g[row - 1, :] - g[row - 2, :]
                                 if extrapolate else 0.0)
            else:
                for k in range(-dj):
                    g[k, :] = (2.0 * g[k + 1, :] - g[k + 2, :]
                               if extrapolate else 0.0)
    return g


def _bshift(f: np.ndarray, dj: int, di: int, bc: BC) -> np.ndarray:
    """Shift with zero fill beyond non-cyclic edges (mask-style fields)."""
    g = np.asarray(f, np.float64)
    if di != 0:
        g = np.roll(g, -di, axis=1)
        if not bc.x_cyclic:
            if di > 0:
                g[:, -di:] = 0.0
            else:
                g[:, :(-di)] = 0.0
    if dj != 0:
        g = np.roll(g, -dj, axis=0)
        if not bc.y_cyclic:
            if dj > 0:
                g[-dj:, :] = 0.0
            else:
                g[:(-dj), :] = 0.0
    return g


def derive_arrays(ULAT, ULON, HTN, HTE, hm, bc: BC, bathymetry=None,
                  angle=None) -> dict:
    """All metric fields from the primary arrays, as float64 NumPy
    (reference primary_grid_lengths_HTN/HTE, Tlatlon, makemask)."""
    ny, nx = HTN.shape
    s = lambda f, dj, di: _np_shift(np.asarray(f, np.float64), dj, di, bc,
                                    True)
    HTN = np.asarray(HTN, np.float64)
    HTE = np.asarray(HTE, np.float64)

    dxU = 0.5 * (HTN + s(HTN, 0, +1))
    dxT = 0.5 * (HTN + s(HTN, -1, 0))
    dxN = HTN.copy()
    dxE = 0.25 * (HTN + s(HTN, 0, +1) + s(HTN, -1, 0) + s(HTN, -1, +1))
    dyU = 0.5 * (HTE + s(HTE, +1, 0))
    dyT = 0.5 * (HTE + s(HTE, 0, -1))
    dyN = 0.25 * (HTE + s(HTE, 0, -1) + s(HTE, +1, 0) + s(HTE, +1, -1))
    dyE = HTE.copy()

    tarea = dxT * dyT
    uarea = dxU * dyU
    narea = dxN * dyN
    earea = dxE * dyE
    tarear = np.where(tarea > 0, 1.0 / np.where(tarea > 0, tarea, 1.0), 0.0)
    uarear = np.where(uarea > 0, 1.0 / np.where(uarea > 0, uarea, 1.0), 0.0)

    HTE_w = s(HTE, 0, -1)
    HTN_s = s(HTN, -1, 0)
    dxhy = 0.5 * (HTE - HTE_w)
    dyhx = 0.5 * (HTN - HTN_s)
    cyp = 1.5 * HTE - 0.5 * HTE_w
    cxp = 1.5 * HTN - 0.5 * HTN_s
    cym = -(1.5 * HTE_w - 0.5 * HTE)
    cxm = -(1.5 * HTN_s - 0.5 * HTN)

    x = np.cos(ULAT) * np.cos(ULON)
    y = np.cos(ULAT) * np.sin(ULON)
    z = np.sin(ULAT)
    sw = lambda f: (f + s(f, 0, -1) + s(f, -1, 0) + s(f, -1, -1))
    tx, ty, tz = 0.25 * sw(x), 0.25 * sw(y), 0.25 * sw(z)
    da = np.maximum(np.sqrt(tx * tx + ty * ty + tz * tz), 1e-30)
    TLAT = np.arcsin(np.clip(tz / da, -1.0, 1.0))
    TLON = np.arctan2(ty, tx)

    hm = np.asarray(hm, np.float64)
    uvm = np.minimum(np.minimum(hm, _bshift(hm, 0, +1, bc)),
                     np.minimum(_bshift(hm, +1, 0, bc),
                                _bshift(hm, +1, +1, bc)))
    npm = np.minimum(hm, _bshift(hm, +1, 0, bc))
    epm = np.minimum(hm, _bshift(hm, 0, +1, bc))

    if angle is None:
        angle = np.zeros((ny, nx))
    ANGLE = np.asarray(angle, np.float64)
    ANGLET = 0.25 * (ANGLE + s(ANGLE, 0, -1) + s(ANGLE, -1, 0) +
                     s(ANGLE, -1, -1))
    if bathymetry is None:
        bathymetry = np.where(hm > 0.5, 4000.0, 0.0)

    return dict(ULAT=ULAT, ULON=ULON, TLAT=TLAT, TLON=TLON, HTN=HTN, HTE=HTE,
                dxT=dxT, dyT=dyT, dxU=dxU, dyU=dyU, dxN=dxN, dyN=dyN,
                dxE=dxE, dyE=dyE, tarea=tarea, uarea=uarea, narea=narea,
                earea=earea, tarear=tarear, uarear=uarear, dxhy=dxhy,
                dyhx=dyhx, cyp=cyp, cxp=cxp, cym=cym, cxm=cxm, ANGLE=ANGLE,
                ANGLET=ANGLET, hm=hm, uvm=uvm, npm=npm, epm=epm,
                bathymetry=np.asarray(bathymetry, np.float64))


def grid_from_arrays(arrays: dict, bc: BC, dtype: torch.dtype,
                     device) -> Grid:
    """Grid on `device` from a dict of (ny, nx) arrays named GRID_FIELDS."""
    t = {k: torch.as_tensor(np.array(arrays[k], dtype=np.float64),
                            dtype=dtype, device=device) for k in GRID_FIELDS}
    ny, nx = t["hm"].shape
    return Grid(**t, bc=bc, nx_global=nx, ny_global=ny)


def _derive(ULAT, ULON, HTN, HTE, hm, bc: BC, bathymetry=None, angle=None,
            dtype=torch.float64, device="cuda") -> Grid:
    return grid_from_arrays(derive_arrays(ULAT, ULON, HTN, HTE, hm, bc,
                                          bathymetry, angle),
                            bc, dtype, device)


# ---------------------------------------------------------------------------
# rectangular grid (reference `rectgrid` ice_grid.F90:2572)
# ---------------------------------------------------------------------------

def make_kmt_rect(nx: int, ny: int, kmt_type: str, bc: BC) -> np.ndarray:
    """T-cell ocean mask for the rectangular grid variants
    (reference ice_grid.F90:2672-2762)."""
    hm = np.zeros((ny, nx))
    if kmt_type == "none":
        hm[:, :] = 1.0
    elif kmt_type == "channel":
        hm[2:ny - 2, :] = 1.0
    elif kmt_type == "channel_oneeast":
        hm[ny // 2 - 1, :] = 1.0
    elif kmt_type == "channel_onenorth":
        hm[:, nx // 2 - 1] = 1.0
    elif kmt_type == "wall":
        hm[:, 0:nx - 2] = 1.0
    elif kmt_type == "default":
        imid = int(nx / 2)
        jmid = int(ny / 2)
        hm[2:ny - 2, 2:nx - 2] = 1.0
        if nx > 5 and ny > 5:
            hm[0:jmid + 2, 0:imid + 2] = 1.0
            hm[max(jmid - 3, 0):ny, max(imid - 3, 0):nx] = 1.0
    elif kmt_type == "boxislands":
        # island/dock/bar obstacle course (reference grid_boxislands_kmt,
        # ice_grid.F90:2935-3040)
        nxb, nyb = nx // 20, ny // 20
        if nxb < 1 or nyb < 1:
            raise ValueError("kmt_type='boxislands' needs nx,ny >= 20")
        hm[:, :] = 1.0
        for k in range(3 * nyb + 1):
            hm[ny - 1 - k, max(nx - 1 - 3 * nxb + k, 0):] = 0.0
        hm[ny - 1 - 3 * nyb:, 0] = 0.0
        hm[ny - 1 - 3 * nyb:ny - nyb - 2, 1:2 * nxb] = 0.0
        hm[ny - nyb - 1:ny - nyb + 1, 1:2 * nxb] = 0.0
        hm[2 * nyb - 1:3 * nyb, 0] = 0.0
        hm[:2 * nyb, 1:nxb] = 0.0
        hm[:2 * nyb, 2 * nxb - 2:2 * nxb] = 0.0
        hm[:2 * nyb, 2 * nxb + 1:4 * nxb] = 0.0
        hm[14 * nyb - 1:14 * nyb + 1, 14 * nxb - 1:14 * nxb + 1] = 0.0
        for k, i in enumerate(range(2 * nxb - 1, 4 * nxb), start=1):
            hm[10 * nyb - 1 + k:14 * nyb - k, i] = 0.0
        for k, j in enumerate(range(14 * nyb - 1, 12 * nyb - 2, -1),
                              start=1):
            hm[j, 2 * nxb + 1 + k:6 * nxb - 2 - k] = 0.0
        for k, j in enumerate(range(10 * nyb - 1, 14 * nyb), start=1):
            hm[j, 2 * nxb + 3 + k:2 * nxb + 6 + k] = 0.0
        for k, j in enumerate(range(12 * nyb - 1, 10 * nyb - 2, -1),
                              start=1):
            hm[j, 5 * nxb - 1 + k:8 * nxb] = 0.0
        hm[4 * nyb - 1:5 * nyb, 10 * nxb - 1:16 * nxb] = 0.0
        hm[6 * nyb + 1:8 * nyb, 10 * nxb - 1:16 * nxb] = 0.0
        hm[8 * nyb + 1:8 * nyb + 3, 10 * nxb - 1:16 * nxb] = 0.0
    else:
        raise ValueError(f"unknown kmt_type {kmt_type}")
    if bc.ew == "closed":
        hm[:, 0:2] = 0.0
        hm[:, nx - 2:nx] = 0.0
    if bc.ns == "closed":
        hm[0:2, :] = 0.0
        hm[ny - 2:ny, :] = 0.0
    return hm


def rectgrid(nx: int, ny: int, dxrect_cm: float = 30.0e5,
             dyrect_cm: float = 30.0e5, kmt_type: str = "default",
             bc: BC = BC(ew="cyclic", ns="open"),
             lonrefrect: float = -156.5, latrefrect: float = 71.35,
             dxscale: float = 1.0, dyscale: float = 1.0,
             dtype=torch.float32, device="cuda") -> Grid:
    """Rectangular grid with analytic coordinates; uniform spacing, or
    geometrically scaled from the domain center (rectgrid_scale_dxdy)."""
    dx = dxrect_cm * cst.cm_to_m
    dy = dyrect_cm * cst.cm_to_m
    if dxscale != 1.0 or dyscale != 1.0:
        ix = np.arange(nx) - (nx - 1) / 2.0
        iy = np.arange(ny) - (ny - 1) / 2.0
        dxs = dx * dxscale ** np.abs(ix)
        dys = dy * dyscale ** np.abs(iy)
    else:
        dxs = np.full(nx, dx)
        dys = np.full(ny, dy)
    lon0 = lonrefrect * cst.deg_to_rad
    lat0 = latrefrect * cst.deg_to_rad
    xU = np.cumsum(dxs)
    yU = np.cumsum(dys)
    ULON = lon0 + (xU / cst.radius)[None, :] + 0.0 * np.arange(ny)[:, None]
    ULAT = lat0 + (yU / cst.radius)[:, None] + 0.0 * np.arange(nx)[None, :]
    HTN = np.broadcast_to(dxs[None, :], (ny, nx)).copy()
    HTE = np.broadcast_to(dys[:, None], (ny, nx)).copy()
    hm = make_kmt_rect(nx, ny, kmt_type, bc)
    return _derive(ULAT, ULON, HTN, HTE, hm, bc, dtype=dtype, device=device)


def from_arrays(ULAT, ULON, HTN, HTE, kmt, bc: BC, bathymetry=None,
                angle=None, dtype=torch.float32, device="cuda") -> Grid:
    """Grid from POP-format primary arrays (gx3/gx1/tx1 path)."""
    hm = (np.asarray(kmt) > 0.5).astype(np.float64)
    return _derive(ULAT, ULON, HTN, HTE, hm, bc, bathymetry=bathymetry,
                   angle=angle, dtype=dtype, device=device)


def latlon_grid(nx: int, ny: int, lat_min: float = -78.0,
                lat_max: float = 88.0, kmt=None,
                bc: BC = BC(ew="cyclic", ns="open"), dtype=torch.float32,
                device="cuda") -> Grid:
    """Regular spherical grid spanning the globe in longitude (reference
    `latlongrid` ice_grid.F90:1418, uniform spacing)."""
    dlon = 2.0 * np.pi / nx
    lat_edges = np.linspace(lat_min, lat_max, ny + 1) * cst.deg_to_rad
    ULAT = np.broadcast_to(lat_edges[1:, None], (ny, nx)).copy()
    ULON = np.broadcast_to((dlon * (np.arange(nx) + 1.0))[None, :],
                           (ny, nx)).copy()
    HTN = cst.radius * dlon * np.cos(ULAT)
    dlat = np.diff(lat_edges)
    HTE = np.broadcast_to((cst.radius * dlat)[:, None], (ny, nx)).copy()
    if kmt is None:
        kmt = np.ones((ny, nx))
        kmt[0, :] = 0.0
        kmt[-1, :] = 0.0
    return _derive(ULAT, ULON, HTN, HTE, kmt, bc, dtype=dtype, device=device)


def make_grid(cfg, device="cuda") -> Grid:
    """Construct the grid described by a Config (grid_nml analogue)."""
    g = cfg.grid
    bc = BC(ew=g.ew_boundary_type, ns=g.ns_boundary_type)
    if g.grid_format == "rect":
        return rectgrid(g.nx_global, g.ny_global, g.dxrect, g.dyrect,
                        g.kmt_type, bc, g.lonrefrect, g.latrefrect,
                        dxscale=g.dxscale if g.scale_dxdy else 1.0,
                        dyscale=g.dyscale if g.scale_dxdy else 1.0,
                        dtype=cfg.np_dtype, device=device)
    if g.grid_format == "latlon":
        return latlon_grid(g.nx_global, g.ny_global, bc=bc,
                           dtype=cfg.np_dtype, device=device)
    if g.grid_format in ("pop_bin", "pop_nc", "nc") or (
            g.grid_file and g.grid_format not in ("rect", "latlon",
                                                  "displaced_pole")):
        from ..io.grids import load_grid_files
        return load_grid_files(cfg, device=device)
    from .landmask import idealized_world_kmt
    if g.grid_format == "tripole":
        # synthetic tripole: spherical metrics (mirror-symmetric across the
        # northern seam, since dx depends only on j) with the fold's halo
        if g.nx_global % 2:
            raise ValueError("tripole grids need even nx_global (fold pairs "
                             "i <-> nx-1-i; ug_implementation.rst:279)")
        ns = g.ns_boundary_type
        bc = BC(ew="cyclic",
                ns=ns if ns in ("tripole", "tripoleT") else "tripole")
        kmt = (None if g.kmt_type == "none"
               else idealized_world_kmt(g.nx_global, g.ny_global))
        if kmt is None:
            kmt = np.ones((g.ny_global, g.nx_global))
            kmt[0, :] = 0.0       # southern land rim; the north is the seam
        return latlon_grid(g.nx_global, g.ny_global, lat_min=-78.0,
                           lat_max=89.0, kmt=kmt, bc=bc, dtype=cfg.np_dtype,
                           device=device)
    if g.grid_format == "displaced_pole":
        # the gx domain without its grid files: a spherical grid of the
        # same dimensions and an idealized land mask
        kmt = idealized_world_kmt(g.nx_global, g.ny_global)
        return latlon_grid(g.nx_global, g.ny_global, lat_min=-78.0,
                           lat_max=87.0, kmt=kmt, bc=bc, dtype=cfg.np_dtype,
                           device=device)
    raise ValueError(f"unknown grid_format {g.grid_format}")


# ---------------------------------------------------------------------------
# inter-grid averaging (reference grid_average_X2Y, ice_grid.F90:3817)
# ---------------------------------------------------------------------------

_AREA = dict(T="tarea", U="uarea", N="narea", E="earea")
_MASK = dict(T="hm", U="uvm", N="npm", E="epm")
_LOC = dict(T=FIELD_LOC_CENTER, U=FIELD_LOC_NECORNER, N=FIELD_LOC_NFACE,
            E=FIELD_LOC_EFACE)
# neighbor offsets of the destination point in source-field index space
_OFFSETS = {
    ("T", "U"): [(0, 0), (0, 1), (1, 0), (1, 1)],
    ("U", "T"): [(0, 0), (0, -1), (-1, 0), (-1, -1)],
    ("T", "E"): [(0, 0), (0, 1)],
    ("E", "T"): [(0, 0), (0, -1)],
    ("T", "N"): [(0, 0), (1, 0)],
    ("N", "T"): [(0, 0), (-1, 0)],
    ("E", "U"): [(0, 0), (1, 0)],
    ("N", "U"): [(0, 0), (0, 1)],
    ("E", "N"): [(0, 0), (1, 0), (0, -1), (1, -1)],
    ("N", "E"): [(0, 0), (-1, 0), (0, 1), (-1, 1)],
    ("U", "E"): [(0, 0), (-1, 0)],
    ("U", "N"): [(0, 0), (0, -1)],
}


def grid_average_X2Y(kind: str, work: torch.Tensor, src: str, dst: str,
                     grid) -> torch.Tensor:
    """Average a field between staggered sub-grids.

    kind: 'S' masked area-weighted state average; 'A' unmasked
    area-weighted; 'F' conservative flux average (reference X2YS:4159 /
    X2YA:4388 / X2YF:4616)."""
    if src == dst:
        return work
    bc = grid.bc
    w1 = getattr(grid, _AREA[src])
    m1 = getattr(grid, _MASK[src])
    loc = _LOC[src]
    offsets = _OFFSETS[(src, dst)]
    g = lambda f: [shift(f, dj, di, bc=bc, loc=loc, ftype=FIELD_TYPE_SCALAR)
                   for dj, di in offsets]
    ws, as_, ms = g(work), g(w1), g(m1)
    if kind == "S":
        num = sum(w * a * m for w, a, m in zip(ws, as_, ms))
        den = sum(a * m for a, m in zip(as_, ms))
        return torch.where(den != 0, num / torch.where(den != 0, den, 1.0),
                           0.0)
    if kind == "A":
        num = sum(w * a for w, a in zip(ws, as_))
        den = sum(as_)
        return torch.where(den != 0, num / torch.where(den != 0, den, 1.0),
                           0.0)
    if kind == "F":
        w2 = getattr(grid, _AREA[dst])
        num = sum(w * a for w, a in zip(ws, as_)) / len(ws)
        return torch.where(w2 > 0, num / torch.where(w2 > 0, w2, 1.0), 0.0)
    raise ValueError(f"unknown average kind '{kind}'")
