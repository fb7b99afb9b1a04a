"""Ice thickness distribution: category bounds and the initial profile
(the host-side NumPy part of cice_tpu/columns/itd.py; the linear ITD remap
comes with ROADMAP: slice 2)."""

from __future__ import annotations

import math

import numpy as np


def category_bounds(ncat: int, kcatbound: int = 1, nilyr: int = 7,
                    kitd: int = 1) -> np.ndarray:
    """hin_max(0:ncat): thickness category boundaries (m).

    kcatbound: 0 original [Lipscomb 2001 eq. 22], 1 'new' rounded boundaries,
    2 WMO standard, -1 single category. Reference behavior: icepack_init_itd
    (documented in Icepack docs; boundary formulas are standard).
    """
    if kcatbound == -1 or ncat == 1:
        return np.array([0.0, 999.9])
    if kcatbound == 0:
        cc1 = 3.0 / ncat
        cc2 = 15.0 * cc1
        cc3 = 3.0
        bounds = [0.0]
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            bounds.append(bounds[-1] + cc1 + cc2 * (1.0 + math.tanh(cc3 * (x1 - 1.0))))
        bounds[-1] = 999.9
        return np.array(bounds)
    if kcatbound == 1:
        # rounded boundaries (cice 'new' defaults for ncat=5: .64 1.39 2.47 4.57)
        cc1 = 3.0 / ncat
        cc2 = 15.0 * cc1
        cc3 = 3.0
        bounds = [0.0]
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            b = bounds[-1] + cc1 + cc2 * (1.0 + math.tanh(cc3 * (x1 - 1.0)))
            bounds.append(100.0 * round(b * 100.0) / 10000.0)
        bounds = [round(b, 6) for b in bounds]
        bounds[-1] = 999.9
        return np.array(bounds)
    if kcatbound == 2:  # WMO
        wmo = {5: [0.0, 0.30, 0.70, 1.20, 2.0, 999.9],
               6: [0.0, 0.15, 0.30, 0.70, 1.20, 2.0, 999.9],
               7: [0.0, 0.10, 0.15, 0.30, 0.70, 1.20, 2.0, 999.9]}
        if ncat not in wmo:
            raise ValueError("WMO bounds require ncat in (5,6,7)")
        return np.array(wmo[ncat])
    if kcatbound == 3:
        # asymptotic scheme (ug_case_settings.rst:336): fine resolution for
        # thin ice, boundaries growing without bound toward the thick end:
        # H_n = n / (ncat + 1 - n). Behavioral stand-in for the Icepack
        # formula (source external to the reference repo); e.g. ncat=7 ->
        # 0.14, 0.33, 0.60, 1.0, 1.67, 3.0 m.
        bounds = [0.0] + [n / (ncat + 1.0 - n) for n in range(1, ncat)]
        bounds.append(999.9)
        return np.array(bounds)
    raise ValueError(f"unknown kcatbound {kcatbound}")


def initial_itd_profile(ncat: int, hin_max: np.ndarray, hbar: float = 3.0):
    """Initial area fractions per category, peaked near hbar
    (reference set_state_var ice_init.F90:3266 'parabolic' profile)."""
    ainit = np.zeros(ncat)
    hinit = np.zeros(ncat)
    for n in range(ncat):
        hl, hu = hin_max[n], min(hin_max[n + 1], 2.0 * hbar)
        hinit[n] = 0.5 * (hl + min(hu, hin_max[n + 1] if n < ncat - 1 else hl + 1.0))
        if hu > hl:
            xl, xu = hl / hbar, min(hu, 2.0 * hbar) / hbar
            if xl < 2.0:
                # integral of parabola a(h) ~ max(0, h(2-h/hbar)) normalized
                f = lambda x: x * x - x ** 3 / 3.0
                ainit[n] = max(f(min(xu, 2.0)) - f(min(xl, 2.0)), 0.0)
    s = ainit.sum()
    if s > 0:
        ainit = 0.95 * ainit / s   # total initial concentration 0.95
    for n in range(ncat):
        hinit[n] = 0.5 * (hin_max[n] + hin_max[n + 1]) if n < ncat - 1 else hin_max[n] + 0.5
    return ainit, hinit
