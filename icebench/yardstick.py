"""The least time the card needs for the work, counted from shapes alone.

Peaks are NVIDIA's published figures for one H100 SXM at its 700 W limit
(dense, no sparsity): 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside
the tensor cores. The counts are frozen copies of the program's own
arithmetic as it stood when the benchmark was defined (K1:
`kernels/evp.bound_bytes_flops`, K2: `kernels/remap.bound_bytes_flops`), so
the yardstick stays where it is when the program changes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# K1, the fused EVP subcycles: 26 input planes (two of them one-byte
# masks), the incoming u, v and 12 stresses read once, 18 output planes
# written once; 412 operations per T cell and 58 per U cell in a subcycle,
# and the tail's stress pass
K1_PLANES_F32 = 26 - 2 + 14 + 18
K1_T_FLOPS, K1_U_FLOPS = 412, 58

# K2, the one-pass transport: the limited gradient of one field
K2_LIMITER_FLOPS = 94


def bound_ms(nbytes: float, flops: float) -> float:
    """The least ms to move `nbytes` and do `flops` in float32."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def k1_bytes_flops(ny: int, nx: int, ndte: int) -> tuple:
    """(bytes, flops) one EVP solve of `ndte` subcycles must move and do."""
    P = ny * nx
    nbytes = (4 * K1_PLANES_F32 + 2) * P
    flops = ((K1_T_FLOPS + K1_U_FLOPS) * ndte + K1_T_FLOPS) * P
    return nbytes, flops


def k2_bytes_flops(nt: int, ncat: int, ny: int, nx: int) -> tuple:
    """(bytes, flops) one transport pass must move and do: `nt` tracer
    fields of `ncat` categories and the open-water row, the 120 moment
    planes and 4 grid planes read once, the tracers and masses written
    once. The operations are the least any state needs (no ice moving:
    every cell's mass reconstruction, the edge scaling and the update), so
    the bound never exceeds what a run's own moments would give."""
    P = ny * nx
    nbytes = 4 * P * (2 * ncat * nt + 2 * (ncat + 1) + 120 + 4)
    recon = (ncat + 1) * (K2_LIMITER_FLOPS + 7)
    edges = 2 * ncat * 2 * nt
    update = ncat * (nt * 11 + 6) + 3
    return nbytes, P * (recon + edges + update)


def state_bytes(named: dict) -> int:
    """Bytes of a state's leaves."""
    return sum(v.numel() * v.element_size() for v in named.values())


def step_least_ms(ny: int, nx: int, ndte: int, ndtd: int, nt: int,
                  ncat: int, nbytes_state: int) -> float:
    """The least ms of one coupled step's work on one H100: the EVP
    solves (`ndtd` per step, as K1 counts them), the transports (as K2
    counts them) and the state read and written once."""
    return (ndtd * bound_ms(*k1_bytes_flops(ny, nx, ndte))
            + ndtd * bound_ms(*k2_bytes_flops(nt, ncat, ny, nx))
            + 2 * nbytes_state / HBM_BYTES_PER_S * 1e3)
