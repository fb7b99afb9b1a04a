"""Quality-control non-BFB acceptance test (two-stage t-test); a copy of
cice_tpu/cli/qc.py (pure NumPy/SciPy), so the port imports nothing of the
JAX package.

Port of the reference's QC machinery
(configuration/scripts/tests/QC/cice.t-test.py, 796 LoC; documented in
doc/source/user_guide/ug_testing.rst:989-1085): decides whether two runs
that are NOT bit-for-bit are statistically indistinguishable, using daily
mean ice thickness fields over a multi-year period.

Stage 1 — per-gridcell two-sided t-test on the mean of the difference
series with an effective sample size corrected for lag-1 autocorrelation
(Zwiers & von Storch 1995): N_eff = N (1 - r1) / (1 + r1). The field
passes if the area fraction of failing cells stays below the critical
fraction at 80% confidence.

Stage 2 — Taylor-diagram quadratic skill of the time-mean spatial
patterns: S = (1 + R)^4 / (4 (sigma_f/sigma_r + sigma_r/sigma_f)^2)
(Taylor 2001 eq. 5); passes above a critical skill.

Inputs are arrays (nt, ny, nx) of daily thickness (the reference reads
1825 daily `iceh_inst` netCDF files; here any history series loader can
feed it — see `load_history_series`, which reads the port's history files:
netCDF-3, or .npz with each field under its own name).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np

CONFIDENCE = 0.8


@dataclass
class QCResult:
    passed: bool
    stage1_passed: bool
    stage2_passed: bool
    fail_fraction: float
    skill: float
    n_eff_mean: float

    def __str__(self):
        s = "PASS" if self.passed else "FAIL"
        return (f"QC {s}: stage1 {'PASS' if self.stage1_passed else 'FAIL'}"
                f" (failing-cell fraction {self.fail_fraction:.4f}),"
                f" stage2 {'PASS' if self.stage2_passed else 'FAIL'}"
                f" (skill {self.skill:.4f})")


def _t_critical(dof, p=CONFIDENCE):
    """Two-sided critical t at confidence p (the reference ships a lookup
    table CICE_t_critical_p0.8.nc; scipy provides the same quantiles)."""
    from scipy.stats import t as t_dist
    return t_dist.ppf(1.0 - (1.0 - p) / 2.0, np.maximum(dof, 1.0))


def stage1_ttest(ha: np.ndarray, hb: np.ndarray, mask: np.ndarray):
    """Per-cell autocorrelation-corrected t-test on the difference of the
    daily series. Returns (fail_fraction, passed, mean N_eff)."""
    d = ha - hb                             # (nt, ny, nx)
    nt = d.shape[0]
    dbar = d.mean(axis=0)
    dp = d - dbar
    var = (dp * dp).sum(axis=0) / (nt - 1)
    # lag-1 autocorrelation
    num = (dp[1:] * dp[:-1]).sum(axis=0)
    den = (dp * dp).sum(axis=0)
    r1 = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
    r1 = np.clip(r1, -0.9999, 0.9999)
    n_eff = nt * (1.0 - r1) / (1.0 + r1)
    n_eff = np.clip(n_eff, 2.0, nt)
    se = np.sqrt(var / n_eff)
    tstat = np.where(se > 0, np.abs(dbar) / np.where(se > 0, se, 1.0), 0.0)
    tcrit = _t_critical(n_eff - 1.0)
    # cells with effectively zero variance and zero mean difference pass
    fails = (tstat > tcrit) & (np.abs(dbar) > 1e-8) & mask
    total = mask.sum()
    frac = float(fails.sum()) / max(float(total), 1.0)
    # field significance: at (1-CONFIDENCE) a fraction ~20% of cells fails
    # by chance even for statistically identical runs; stage 1 fails only
    # when the failing fraction exceeds that base rate beyond binomial
    # sampling noise (the role of the reference's lookup table)
    p0 = 1.0 - CONFIDENCE
    margin = 3.0 * np.sqrt(p0 * (1.0 - p0) / max(float(total), 1.0))
    passed = frac <= p0 + margin
    return frac, bool(passed), float(n_eff[mask].mean() if total else nt)


def stage2_skill(ha: np.ndarray, hb: np.ndarray, mask: np.ndarray,
                 crit: float = 0.99):
    """Taylor quadratic skill of the time-mean patterns."""
    fa = ha.mean(axis=0)[mask]
    fb = hb.mean(axis=0)[mask]
    sa = fa.std()
    sb = fb.std()
    if sa == 0.0 and sb == 0.0:
        return 1.0, True
    if sa == 0.0 or sb == 0.0:
        return 0.0, False
    r = np.corrcoef(fa, fb)[0, 1]
    ratio = sa / sb
    skill = (1.0 + r) ** 4 / (4.0 * (ratio + 1.0 / ratio) ** 2)
    return float(skill), bool(skill >= crit)


def qc_compare(ha: np.ndarray, hb: np.ndarray,
               mask: np.ndarray | None = None) -> QCResult:
    """Full two-stage QC comparison of two daily-thickness series."""
    ha = np.asarray(ha, np.float64)
    hb = np.asarray(hb, np.float64)
    if mask is None:
        mask = (ha.mean(axis=0) > 0.01) | (hb.mean(axis=0) > 0.01)
    frac, s1, neff = stage1_ttest(ha, hb, mask)
    skill, s2 = stage2_skill(ha, hb, mask)
    return QCResult(passed=s1 and s2, stage1_passed=s1, stage2_passed=s2,
                    fail_fraction=frac, skill=skill, n_eff_mean=neff)


def load_history_series(history_dir: str, var: str = "hi") -> np.ndarray:
    """Stack `var` from all history files in a case's history dir (the
    reference reads 1825 daily iceh_inst netCDF files; both the npz and
    the netCDF-3 writer outputs are accepted)."""
    files = sorted(glob.glob(os.path.join(history_dir, "*.npz")))
    if files:
        out = []
        for f in files:
            with np.load(f) as z:
                if var in z:
                    out.append(np.asarray(z[var]))
        return np.stack(out)
    files = sorted(glob.glob(os.path.join(history_dir, "*.nc")))
    if not files:
        raise FileNotFoundError(f"no history files in {history_dir}")
    from scipy.io import netcdf_file
    out = []
    for fp in files:
        with netcdf_file(fp, "r", mmap=False) as f:
            if var in f.variables:
                v = np.array(f.variables[var][0], np.float64)
                miss = getattr(f.variables[var], "missing_value", None)
                if miss is not None:
                    v = np.where(np.isclose(v, float(miss)), 0.0, v)
                out.append(v)
    return np.stack(out)


def main(argv):
    """CLI: qc <history_dir_a> <history_dir_b> [var]."""
    var = argv[2] if len(argv) > 2 else "hi"
    ha = load_history_series(argv[0], var)
    hb = load_history_series(argv[1], var)
    res = qc_compare(ha, hb)
    print(res)
    return 0 if res.passed else 1
