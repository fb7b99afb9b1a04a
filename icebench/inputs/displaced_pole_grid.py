"""A displaced-pole POP grid in its binary files (the byte layout CICE's
`popgrid` reads), written by the reference's copy of the program's fixture
writer: `reference/ice/io/fixtures.py`. It depends on the size alone, so it
is written once per checkout under the cache and reused.

params: {"kind": "displaced_pole_grid", "nx": int, "ny": int}
returns: {"grid": path, "kmt": path}
"""

from __future__ import annotations

import os


def make(params, seed, ctx) -> dict:
    from ..reference.ice.io import fixtures as fx
    nx, ny = int(params["nx"]), int(params["ny"])
    d = os.path.join(ctx.cache, "grids")
    os.makedirs(d, exist_ok=True)
    stem = os.path.join(d, f"dp{nx}x{ny}")
    out = {"grid": stem + "_grid.bin", "kmt": stem + "_kmt.bin"}
    if all(os.path.exists(p) for p in out.values()):
        return out
    arrs = fx.make_displaced_pole_arrays(nx, ny)
    tag = f".{os.getpid()}.tmp"
    fx.write_pop_grid_binary(out["grid"] + tag, arrs)
    fx.write_kmt_binary(out["kmt"] + tag, arrs["kmt"])
    for p in out.values():
        os.replace(p + tag, p)
    return out
