"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or cice_tpu (compared whole: the program's name begins with
the last) in anything `run.py` loads, and nothing of the program in any
reference, `reference/<name>/` for every name there is."""

import ast
import os
import subprocess
import sys

import pytest

from icebench import catalog
from icebench.harness import FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*sub):
    top = os.path.join(catalog.HERE, *sub)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("tests", ".cache",
                                                 "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def _references():
    """The names of the reference directories, `reference/<name>/`."""
    top = os.path.join(catalog.HERE, "reference")
    return sorted(d for d in os.listdir(top)
                  if os.path.isfile(os.path.join(top, d, "__init__.py")))


def _shared():
    """The modules that every reference shares (`reference/*.py`)."""
    top = os.path.join(catalog.HERE, "reference")
    return [os.path.join(top, f) for f in sorted(os.listdir(top))
            if f.endswith(".py")]


def test_the_ice_reference_is_among_those_walked():
    assert "ice" in _references()
    names = {os.path.relpath(p, catalog.HERE)
             for p in _sources("reference", "ice")}
    assert {"reference/ice/reference.py", "reference/ice/model/step.py",
            "reference/ice/dynamics/evp.py",
            "reference/ice/dynamics/remap_exact.py"} <= names


@pytest.mark.parametrize("name", _references())
def test_the_reference_imports_nothing_of_the_program(name):
    paths = list(_sources("reference", name))
    assert os.path.join(catalog.HERE, "reference", name,
                        "reference.py") in paths
    for path in paths + _shared():
        tops = set(_imports(path))
        assert not tops & {"cice_tpu_torch", "icebench"}, path
        assert not tops & set(FORBIDDEN), path


@pytest.mark.parametrize("name", _references())
def test_the_reference_keeps_the_contract(name):
    """`catalog.reference` finds its `ReferenceModel`, with the methods
    that the harness calls."""
    cls = catalog.reference({"name": "any", "reference": name})
    for method in ("zeros", "default_state", "calendar", "step",
                   "tracer_count"):
        assert callable(getattr(cls, method)), (name, method)


@pytest.mark.parametrize("name", _references())
def test_every_relative_import_of_the_reference_exists(name):
    """No branch of a reference imports a module it does not hold (the
    program's kernels, ranks or files)."""
    for path in list(_sources("reference", name)) + _shared():
        for node in ast.walk(ast.parse(open(path).read())):
            if not (isinstance(node, ast.ImportFrom) and node.level):
                continue
            base = os.path.dirname(path)
            for _ in range(node.level - 1):
                base = os.path.dirname(base)
            parts = node.module.split(".") if node.module else []
            target = os.path.join(base, *parts)
            if parts:
                assert os.path.exists(target + ".py") or \
                    os.path.isdir(target), (path, node.module)
            else:
                for a in node.names:
                    assert os.path.exists(os.path.join(
                        target, a.name + ".py")), (path, a.name)


def test_a_run_loads_no_forbidden_module():
    """A whole run of a cell at a small grid on the CPU, in a process of
    its own; then the loaded modules, by top-level name."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {catalog.REPO!r})\n"
        "torch.set_num_threads(2)\n"
        "from icebench import catalog, harness\n"
        "out = harness.run_cell(catalog.benchmark(), 'om025.hourly', 5, 0,"
        " False, 'cpu', shrink=(24, 20), window_steps=1)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "cice_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)
