"""Plotting utilities: 2-D field maps and diagnostic time series (a copy
of cice_tpu/cli/plots.py, so the port imports nothing of the JAX package).

Equivalent of the reference's analysis tooling
(configuration/tools/ciceplots2d.py and timeseries.py): quick-look PNGs of
history fields and of the runtime-diagnostics series. Matplotlib is
optional — import is deferred and a clear error raised if absent.

CLI:  python -m cice_tpu_torch.cli plot2d history/iceh.*.npz -f aice
      python -m cice_tpu_torch.cli timeseries diag_log.json -k area_nh
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:           # pragma: no cover
        raise SystemExit("plotting requires matplotlib") from e


def load_history_field(path: str, field: str):
    """Read one field (+coords if present) from a history file
    (.npz or netCDF)."""
    if path.endswith(".nc"):
        from scipy.io import netcdf_file
        with netcdf_file(path, "r", mmap=False) as f:
            arr = np.array(f.variables[field][:], np.float64)
            lat = (np.array(f.variables["TLAT"][:], np.float64)
                   if "TLAT" in f.variables else None)
        return arr.squeeze(), lat
    with np.load(path) as z:
        arr = np.asarray(z[field], np.float64)
        lat = np.asarray(z["TLAT"], np.float64) if "TLAT" in z else None
    return arr.squeeze(), lat


def plot2d(paths: List[str], field: str = "aice", out: Optional[str] = None,
           cmap: str = "viridis", vmin=None, vmax=None) -> List[str]:
    """Pseudocolor map(s) of a history field (ciceplots2d.py analogue)."""
    plt = _mpl()
    written = []
    for path in paths:
        arr, _lat = load_history_field(path, field)
        fig, ax = plt.subplots(figsize=(8, 5), dpi=120)
        im = ax.pcolormesh(arr, cmap=cmap, vmin=vmin, vmax=vmax,
                           shading="auto")
        fig.colorbar(im, ax=ax, label=field)
        ax.set_title(f"{field} — {os.path.basename(path)}")
        ax.set_xlabel("i")
        ax.set_ylabel("j")
        dest = out or (os.path.splitext(path)[0] + f".{field}.png")
        fig.savefig(dest, bbox_inches="tight")
        plt.close(fig)
        written.append(dest)
    return written


def timeseries(diag_path: str, keys: Optional[List[str]] = None,
               out: Optional[str] = None) -> str:
    """Line plots of runtime-diagnostics series (timeseries.py analogue).
    Input: a JSON list of per-step diagnostic dicts (Model.diag_log)."""
    plt = _mpl()
    with open(diag_path) as f:
        log = json.load(f)
    if not log:
        raise SystemExit(f"no records in {diag_path}")
    keys = keys or [k for k in log[0] if k != "istep"]
    fig, axes = plt.subplots(len(keys), 1, figsize=(8, 2.2 * len(keys)),
                             dpi=120, sharex=True, squeeze=False)
    x = np.arange(len(log))
    for ax, k in zip(axes[:, 0], keys):
        ax.plot(x, [rec.get(k, np.nan) for rec in log], lw=1.2)
        ax.set_ylabel(k)
        ax.grid(alpha=0.3)
    axes[-1, 0].set_xlabel("diagnostic sample")
    dest = out or (os.path.splitext(diag_path)[0] + ".png")
    fig.savefig(dest, bbox_inches="tight")
    plt.close(fig)
    return dest
