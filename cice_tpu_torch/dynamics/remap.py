"""`remap_q`: the quadrature variant of incremental remapping on packed
densities (PyTorch port of cice_tpu/dynamics/remap.py; reference
ice_transport_remap.F90 `construct_fields`:1009, `limited_gradient`:1295,
`departure_points`:1449, `update_fields`:3480).

Every transported density gets a van Leer limited linear reconstruction;
the B-grid corners are traced back over dt; across each E and N edge the
swept quadrilateral is split into two signed triangles, each integrated by
a 3-point rule whose points pick their donor among 6 candidate cells by
dense masks. The flux-form update is conservative by construction. The
exact remap (`advection='remap'`) is dynamics/remap_exact.py.
"""

from __future__ import annotations

import torch

from ..constants import (FIELD_LOC_CENTER, FIELD_LOC_EFACE, FIELD_LOC_NFACE,
                         FIELD_LOC_NECORNER, FIELD_TYPE_SCALAR,
                         FIELD_TYPE_VECTOR)
from ..core.grid import Grid
from ..core.halo import shift

#: donor candidates of an edge: (across, along) offsets; across 0 is the
#: cell on the low side of the edge, 1 the one on the high side
_OFFS = [(0, 0), (1, 0), (0, -1), (1, -1), (0, 1), (1, 1)]
#: barycentric weights of the interior 3-point rule (exact for quadratics)
_RULE = ((2 / 3, 1 / 6, 1 / 6), (1 / 6, 2 / 3, 1 / 6), (1 / 6, 1 / 6, 2 / 3))


def _shc(f, dj, di, bc):
    return shift(f, dj, di, bc=bc, loc=FIELD_LOC_CENTER,
                 ftype=FIELD_TYPE_SCALAR)


def limited_gradient(grid: Grid, m):
    """Van Leer limited gradient of a packed (narr, ny, nx) density
    (limited_gradient:1295): per direction the harmonic mean of the
    one-sided differences, zero at extrema."""
    bc = grid.bc
    m_e, m_w = _shc(m, 0, 1, bc), _shc(m, 0, -1, bc)
    m_n, m_s = _shc(m, 1, 0, bc), _shc(m, -1, 0, bc)

    def vl(dup, ddn, dl):
        prod = dup * ddn
        s = torch.where(prod > 0.0, 2.0 * prod / torch.where(
            prod > 0.0, dup + ddn, 1.0), 0.0)
        return s / dl

    return (vl(m - m_w, m_e - m, grid.dxT[None]),
            vl(m - m_s, m_n - m, grid.dyT[None]))


def departure_points(grid: Grid, uvel, vvel, dt):
    """Backward corner trajectories (departure_points:1449): the
    displacement of each U point, clipped to 0.95 of a cell."""
    dx = torch.clamp(-uvel * dt, -0.95 * grid.dxU, 0.95 * grid.dxU)
    dy = torch.clamp(-vvel * dt, -0.95 * grid.dyU, 0.95 * grid.dyU)
    return dx, dy


def _edge_flux(grid: Grid, m, mx, my, p1x, p1y, p2x, p2y, d1x, d1y,
               d2x, d2y, orient: str):
    """The signed transported integral across one edge family, positive
    from the low side to the high side.

    Edge frame: origin at the edge midpoint, +x toward the high side (east
    for E edges; north for N edges, whose frame swaps the axes); p1, p2
    the edge ends and d1, d2 their departure displacements."""
    bc = grid.bc
    if orient == "E":
        dxl, dyl = grid.dxT, grid.dyT
        do_shift = lambda a, off: _shc(a, off[1], off[0], bc)
    else:
        dxl, dyl = grid.dyT, grid.dxT
        do_shift = lambda a, off: _shc(a, off[0], off[1], bc)
    shifts = {off: (do_shift(m, off), do_shift(mx, off), do_shift(my, off))
              for off in _OFFS}
    xc = {off: (off[0] - 0.5) * dxl for off in _OFFS}
    yc = {off: off[1] * dyl for off in _OFFS}

    # the swept quad p1 -> p2 -> q2 -> q1 as two signed triangles
    q1x, q1y = p1x + d1x, p1y + d1y
    q2x, q2y = p2x + d2x, p2y + d2y

    def tri_signed_area(ax, ay, bx, by, cx, cy):
        return 0.5 * ((bx - ax) * (cy - ay) - (cx - ax) * (by - ay))

    flux = 0.0
    for (ax, ay, bx, by, cx, cy) in ((p1x, p1y, p2x, p2y, q1x, q1y),
                                     (p2x, p2y, q2x, q2y, q1x, q1y)):
        A = tri_signed_area(ax, ay, bx, by, cx, cy)
        for wa, wb, wc in _RULE:
            xq = wa * ax + wb * bx + wc * cx
            yq = wa * ay + wb * by + wc * cy
            val = torch.zeros_like(m)
            for off in _OFFS:
                io, jo = off
                in_x = (xq < 0.0) if io == 0 else (xq >= 0.0)
                sel = in_x & (yq >= (jo - 0.5) * dyl) & \
                    (yq < (jo + 0.5) * dyl)
                mo, mxo, myo = shifts[off]
                val = val + torch.where(
                    sel[None], mo + mxo * (xq - xc[off])[None] +
                    myo * (yq - yc[off])[None], 0.0)
            flux = flux + (A / 3.0)[None] * val
    # the p1->p2->q2->q1 loop runs clockwise for transport toward +x
    return -flux


def horizontal_remap(grid: Grid, work, uvel, vvel, dt, *, grid_ice="B",
                     uvelE=None, vvelN=None):
    """The remap_q update of the packed (narr, ny, nx) densities
    (horizontal_remap:317). On C and CD grids the corner velocities are
    means of the face velocities."""
    bc = grid.bc
    mx, my = limited_gradient(grid, work)
    shu = lambda f, dj, di: shift(f, dj, di, bc=bc, loc=FIELD_LOC_NECORNER,
                                  ftype=FIELD_TYPE_VECTOR)
    if grid_ice in ("C", "CD") and uvelE is not None:
        ucorn = 0.5 * (uvelE + shift(uvelE, 1, 0, bc=bc, loc=FIELD_LOC_EFACE,
                                     ftype=FIELD_TYPE_VECTOR))
        vcorn = 0.5 * (vvelN + shift(vvelN, 0, 1, bc=bc, loc=FIELD_LOC_NFACE,
                                     ftype=FIELD_TYPE_VECTOR))
    else:
        ucorn, vcorn = uvel, vvel
    dxp, dyp = departure_points(grid, ucorn * grid.uvm, vcorn * grid.uvm, dt)

    dyT, dxT = grid.dyT, grid.dxT
    zeros = torch.zeros_like(dxT)
    # E edges: the north end is U(i,j) at (0, +dy/2), the south end U(i,j-1)
    fe = _edge_flux(grid, work, mx, my, zeros, 0.5 * dyT, zeros, -0.5 * dyT,
                    dxp, dyp, shu(dxp, -1, 0), shu(dyp, -1, 0), "E")
    fe = fe * grid.epm[None]
    # N edges, frame swapped (+x = north): the east end U(i,j) at
    # (0, +dx/2), the west end U(i-1,j)
    fn = _edge_flux(grid, work, my, mx, zeros, 0.5 * dxT, zeros, -0.5 * dxT,
                    dyp, dxp, shu(dyp, 0, -1), shu(dxp, 0, -1), "N")
    fn = fn * grid.npm[None]

    fw = shift(fe, 0, -1, bc=bc, loc=FIELD_LOC_EFACE, ftype=FIELD_TYPE_SCALAR)
    fs = shift(fn, -1, 0, bc=bc, loc=FIELD_LOC_NFACE, ftype=FIELD_TYPE_SCALAR)
    return work - (fe - fw + fn - fs) * grid.tarear[None]
