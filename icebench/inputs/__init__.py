"""Input generators, one module per kind, found by the name a
configuration's `inputs` gives: `inputs/<kind>.py` defines
`make(params, seed, ctx) -> dict`. Each makes its inputs from the seed (or
from nothing), writes what it caches under `ctx.cache` and what is the
run's own under `ctx.run_dir`, and returns the names a configuration's
`run` overrides refer to as "{<input>.<key>}".
"""

from __future__ import annotations

import importlib
import re
from dataclasses import dataclass

_NAME = re.compile(r"^[A-Za-z0-9_]+$")


@dataclass
class InputContext:
    cache: str          # kept between runs inside the checkout
    run_dir: str        # this run's own directory (removed at its end)
    made: dict          # what earlier inputs of the configuration returned


def generator(kind: str):
    """The module `inputs/<kind>.py`."""
    if not _NAME.match(kind):
        raise ValueError(f"input kind {kind!r}: not a module name")
    return importlib.import_module(f"{__name__}.{kind}")


def make_all(specs: dict, seed: int, cache: str, run_dir: str) -> dict:
    """Run the configuration's input generators in order; returns
    {input name: what its generator returned}."""
    made: dict = {}
    for name, params in specs.items():
        ctx = InputContext(cache=cache, run_dir=run_dir, made=made)
        made[name] = generator(params["kind"]).make(params, seed, ctx)
    return made


def resolve(run: dict, made: dict) -> dict:
    """The `run` overrides with every "{<input>.<key>}" string replaced by
    what that input returned."""
    pat = re.compile(r"\{([A-Za-z0-9_]+)\.([A-Za-z0-9_]+)\}")

    def sub(v):
        if isinstance(v, str):
            return pat.sub(lambda m: str(made[m.group(1)][m.group(2)]), v)
        if isinstance(v, list):     # JSON lists are the config's tuples
            return tuple(v)
        return v
    return {k: sub(v) for k, v in run.items()}
