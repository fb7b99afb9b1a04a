"""The port stands alone: no module of cice_tpu_torch/ and not
chip_smoke.py imports jax, jaxlib or the JAX package cice_tpu (an AST scan
of every import statement, so strings and comments do not count)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "cice_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "cice_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_the_scan_sees_the_port():
    paths = _sources()
    assert len(paths) > 40
    assert any(p.endswith(os.path.join("cli", "main.py")) for p in paths)
