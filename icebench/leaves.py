"""A model state as named tensors, the form in which the harness hands the
initial state to the program and compares states: every tensor field by
its name and every tracer as "trcrn.<name>". It reads the program's State
and the reference's alike (both are dataclasses of tensors and one dict of
tracers)."""

from __future__ import annotations

import dataclasses

import torch


def leaves(state) -> dict:
    """{name: tensor} of a state."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            for k in sorted(v):
                out[f"trcrn.{k}"] = v[k]
        elif torch.is_tensor(v):
            out[f.name] = v
    return out


def fill(like, named: dict):
    """A state of `like`'s class holding `named` (as `leaves` names
    them), each cast to `like`'s dtype and device and copied; booleans stay
    boolean. Raises KeyError if `named` lacks a field of `like`."""
    def cast(v, ref):
        return v.to(device=ref.device, dtype=ref.dtype, copy=True)
    kw = {}
    for f in dataclasses.fields(like):
        ref = getattr(like, f.name)
        if isinstance(ref, dict):
            kw[f.name] = {k: cast(named[f"trcrn.{k}"], ref[k]) for k in ref}
        elif torch.is_tensor(ref):
            kw[f.name] = cast(named[f.name], ref)
    return dataclasses.replace(like, **kw)


def to_host(named: dict) -> dict:
    """A copy of `named` in host memory."""
    return {k: v.detach().to("cpu", copy=True) for k, v in named.items()}
