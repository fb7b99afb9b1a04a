"""Rank jobs that only the tests run across spawned gloo ranks
(`cice_tpu_torch.parallel.spawn.launch`): mesh layouts and sharded I/O,
and the launcher's own tests.

The ranks import this module to find the jobs, so it imports pytest,
torch and the port only, never JAX (test_torch_evp_wide.py and
test_torch_pio.py, which launch these jobs, do).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

import torch.distributed as dist  # noqa: E402

from cice_tpu_torch.calendar import Calendar  # noqa: E402
from cice_tpu_torch.convert import state_from_numpy  # noqa: E402
from cice_tpu_torch.io.pio import (read_restart_sharded,  # noqa: E402
                                   write_field_sharded,
                                   write_restart_sharded)
from cice_tpu_torch.model.state import state_leaves  # noqa: E402
from cice_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from cice_tpu_torch.parallel import spawn  # noqa: E402
from cice_tpu_torch.parallel.spawn import load, rank_result  # noqa: E402


def mesh_layout(*, group, shape=None, grid_shape=None, curve_order=False):
    """A Mesh's layout as this rank sees it: the rank grid, its
    coordinates, tile, neighbours (open and cyclic) and mirror."""
    mesh = Mesh(shape, grid_shape=grid_shape, curve_order=curve_order,
                group=group)
    nb = {(dy, dx, c): mesh.neighbour(dy, dx, y_cyclic=c, x_cyclic=c)
          for dy in (-1, 0, 1) for dx in (-1, 0, 1) for c in (False, True)}
    return dict(ranks=mesh.ranks.tolist(), coords=mesh.coords,
                tile=mesh.tile_slices(48, 40), neighbours=nb,
                mirror=mesh.mirror(), backend=mesh.backend)


def _write_fields(fields, dirpath, mesh, device):
    return {name: write_field_sharded(
                dirpath, name, torch.as_tensor(a, device=device), mesh=mesh)
            for name, a in load(fields).items()}


def write_fields(*, group, fields, dirpath, shape, device="cpu"):
    """write_field_sharded of each field (a file of {name: array}), every
    rank its tile."""
    return _write_fields(fields, dirpath, Mesh(shape, group=group), device)


def write_restart(*, group, state, calendar, dirpath, shape, device="cpu",
                  pointer_file=None):
    """write_restart_sharded of a state ({field: array} as
    convert.state_to_numpy gives it) and a calendar (its fields)."""
    mesh = Mesh(shape, group=group)
    return write_restart_sharded(
        dirpath, state_from_numpy(load(state), device), Calendar(**calendar),
        pointer_file, mesh=mesh)


def write_on_last_ranks(*, group, nranks, fields, state, calendar, dirpath,
                        pointer_file, device="cpu"):
    """Fields and a restart from a 1 x nranks Mesh over the world's last
    `nranks` ranks, a group without rank 0; the other ranks return None."""
    world = dist.get_world_size()
    ranks = list(range(world - nranks, world))
    sub = dist.new_group(ranks)             # every rank takes part
    if dist.get_rank() not in ranks:
        return None
    mesh = Mesh((1, nranks), group=sub)
    return dict(
        fields=_write_fields(fields, dirpath, mesh, device),
        restart=write_restart_sharded(
            dirpath, state_from_numpy(load(state), device),
            Calendar(**calendar), pointer_file, mesh=mesh))


def read_restart(*, group, path, template, shape, device="cpu"):
    """read_restart_sharded on every rank of a `shape` mesh into a
    template state (a file as in `write_restart`)."""
    mesh = Mesh(shape, group=group)
    st, cal = read_restart_sharded(
        path, state_from_numpy(load(template), device))
    return rank_result(mesh, state_leaves(st), dict(istep=cal.istep))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("job", [("no_such_job", {}, 2), ("evp_b", {}, 0),
                                 ("evp_b", {}, 3), (42, {}, 1)])
def test_launch_refuses_what_it_cannot_run(job, tmp_path):
    with pytest.raises(ValueError, match="ranks"):
        spawn.launch([job], 2, str(tmp_path))


def test_jobs_by_name_and_by_function(tmp_path):
    """A job is a name in spawn.JOBS or a function of an importable module
    (here this one): each runs on its first n ranks, in a group of its own,
    and the others give None."""
    res = spawn.launch([(mesh_layout, dict(shape=(1, 2)), 2),
                        (mesh_layout, dict(), 1)], 2, str(tmp_path),
                       timeout=120.0)
    assert [r["coords"] for r in res[0]] == [(0, 0), (0, 1)]
    assert [r["backend"] for r in res[0]] == ["gloo", "gloo"]
    assert res[1][0]["ranks"] == [[0]] and res[1][1] is None
    assert set(spawn.JOBS) == {"evp_b", "evp_c", "model_steps",
                               "global_sums"}
