"""The hand-written CUDA kernels: K1 (evp.py), K2 and K3 (remap.py), K4
(bl99.py). Each module counts its own launches; `launch_counts` reads
them all."""

from __future__ import annotations


def launch_counts() -> dict:
    """{kernel or route: launches so far} of this process: evp_fused (K1),
    transport_fused (K2) and transport_chunks (the tracer chunks its
    launches walked), tracer_fluxes (K3), bl99_whole and bl99_per_pass
    (K4 by route)."""
    from . import bl99, evp, remap
    return {"evp_fused": evp.launches, "transport_fused": remap.launches,
            "transport_chunks": remap.chunk_launches,
            "tracer_fluxes": remap.flux_launches,
            "bl99_whole": bl99.whole_launches,
            "bl99_per_pass": bl99.per_pass_launches}
