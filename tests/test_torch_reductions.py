"""PyTorch port vs JAX package: global reductions
(cice_tpu_torch.core.reductions) against tests/test_reductions.py, the
sumchk oracle (reference drivers/unittest/sumchk).

Every bfbflag agrees with a long-double sum within the JAX test's bound
per mode; 'lsum16' and 'ddpdd' are pairwise TwoSum trees here (the JAX
package scans rows), so they are held to that accuracy, not to JAX's
bits, and stay within 1e-13 under permutation; 'reprosum' equals JAX's
bits (float64 and float32) and is exactly invariant under permutation.
Across ranks (8 spawned gloo processes, each summing its tile of the
field, then combining) 'reprosum' gives the same bits on 1, 2x4 and 4x2
ranks, and the other modes stay within their bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import jax.numpy as jnp  # noqa: E402

from cice_tpu.core.reductions import global_sum as jglobal_sum  # noqa: E402
from cice_tpu_torch.core.reductions import (BFBFLAGS, global_maxval,  # noqa: E402
                                            global_minval, global_sum)
from cice_tpu_torch.parallel import spawn  # noqa: E402
from cice_tpu_torch.parallel.mesh import Mesh  # noqa: E402

TOL = {"off": 1e-12, "lsum4": 2e-4, "lsum8": 1e-12, "lsum16": 1e-14,
       "ddpdd": 1e-14, "reprosum": 1e-9}


def _field(seed=0, n=64):
    rng = np.random.default_rng(seed)
    # wide dynamic range stresses accumulation error
    return rng.uniform(-1.0, 1.0, (n, n)) * 10.0 ** rng.integers(-6, 6,
                                                                  (n, n))


def _ref(x):
    return float(np.sum(x.astype(np.longdouble)))


@pytest.mark.parametrize("mode", BFBFLAGS)
def test_sum_accuracy(mode):
    x = _field()
    ref = _ref(x)
    got = global_sum(torch.as_tensor(x), bfbflag=mode)
    assert got.dtype == torch.float64 and got.ndim == 0
    scale = max(abs(ref), np.abs(x).max())
    assert abs(float(got) - ref) <= TOL[mode] * scale, (mode, float(got), ref)


@pytest.mark.parametrize("mode", ["lsum16", "ddpdd", "reprosum"])
def test_layout_invariance(mode):
    """Permuting the summands moves the compensated modes by no more than
    their roundoff floor and 'reprosum' not at all."""
    x = _field(3)
    perm = np.random.default_rng(7).permutation(x.size)
    a = float(global_sum(torch.as_tensor(x), bfbflag=mode))
    b = float(global_sum(torch.as_tensor(x.ravel()[perm].reshape(x.shape)),
                         bfbflag=mode))
    if mode == "reprosum":
        assert a == b, (a, b)
    else:
        assert abs(a - b) <= 1e-13 * max(abs(a), np.abs(x).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reprosum_equals_jax_bits(dtype):
    """The fixed-point window and rounding are the JAX package's: the same
    bits, in both precisions; the other modes within their bound of JAX's
    (lsum4 and the float32 sums within float32 rounding)."""
    x = _field(11).astype(dtype)
    for mode in BFBFLAGS:
        a = np.asarray(jglobal_sum(jnp.asarray(x), bfbflag=mode))
        b = global_sum(torch.as_tensor(x), bfbflag=mode).numpy()
        assert a.dtype == b.dtype, mode
        if mode == "reprosum":
            assert a.tobytes() == b.tobytes(), (a, b)
        else:
            tol = 2e-4 if dtype == np.float32 or mode == "lsum4" else \
                TOL[mode]
            assert abs(float(a) - float(b)) <= tol * np.abs(x).max() * 64


def test_weighted_masked():
    x = _field(5)
    w = np.abs(x) * 0.1
    m = x > 0
    ref = float(np.sum(np.where(m, x * w, 0.0)))
    got = float(global_sum(torch.as_tensor(x), weight=torch.as_tensor(w),
                           mask=torch.as_tensor(m), bfbflag="lsum8"))
    assert abs(got - ref) <= 1e-9 * max(1.0, abs(ref))


def test_minmax_masked():
    x = _field(9)
    m = x < 0
    tx, tm = torch.as_tensor(x), torch.as_tensor(m)
    assert float(global_maxval(tx, tm)) == x[m].max()
    assert float(global_minval(tx, tm)) == x[m].min()
    mesh = Mesh()
    assert float(global_maxval(tx, mesh=mesh)) == x.max()
    assert float(global_minval(tx, tm, mesh=mesh)) == x[m].min()


def test_unknown_bfbflag_is_refused():
    with pytest.raises(ValueError, match="unknown bfbflag"):
        global_sum(torch.ones(3), bfbflag="lsum32")


@pytest.fixture(scope="module")
def across_ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("sums"))
    fields = {"wide": _field(0), "f32": _field(4).astype(np.float32),
              "ragged": _field(2, n=48)[:, :40]}
    path = spawn.save(fields, f"{wd}/fields.pkl")
    jobs = [("global_sums", dict(fields=path, shape=s, modes=BFBFLAGS), 8)
            for s in ((2, 4), (4, 2))]
    return fields, spawn.launch(jobs, 8, wd, timeout=300.0)


def test_sums_across_ranks(across_ranks):
    """Each rank sums its tile; 'reprosum' gives the 1-rank bits on 2x4
    and 4x2 ranks (every rank the same), the other modes stay within
    their bound of the 1-rank sum (float32 fields within 2e-4)."""
    fields, res = across_ranks
    for name, x in fields.items():
        one = {m: float(global_sum(torch.as_tensor(x), bfbflag=m,
                                   mesh=Mesh())) for m in BFBFLAGS}
        assert one["reprosum"] == float(jglobal_sum(jnp.asarray(x),
                                                    bfbflag="reprosum"))
        scale = max(abs(_ref(x)), np.abs(x).max())
        for r in res:
            for rank in r:
                got = rank[name]
                assert got["reprosum"] == one["reprosum"], name
                for m in BFBFLAGS:
                    tol = 2e-4 if x.dtype == np.float32 else TOL[m]
                    assert abs(got[m] - one[m]) <= tol * scale, \
                        (name, m, got[m], one[m])
