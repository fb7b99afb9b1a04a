"""cice_tpu_torch — the PyTorch/CUDA port of cice_tpu for NVIDIA Hopper.

A package beside `cice_tpu` (the JAX reference, which it never imports):
plain PyTorch for the dense stencil code, hand-written CUDA kernels
(csrc/, built with nvcc on first use) for the hot loops the JAX package
runs as Pallas TPU kernels. Entry points run on "cuda" unless the caller
passes device="cpu"; on CPU tensors every kernel wrapper runs its plain
PyTorch version.

Ported so far: the full coupled step in the default physics (BL99
thermodynamics, ccsm3 shortwave, similarity boundary layer, level ponds,
linear ITD remap, frazil and lateral melt, B-grid EVP, exact incremental
remapping, ridging, slab ocean) on the gx1 displaced-pole grid, and the
other dynamics and transports: C- and CD-grid EVP (dynamics/evp_c.py), the
implicit VP solver (dynamics/vp.py), EAP (dynamics/eap.py), upwind, van
Leer and remap_q (dynamics/transport.py, dynamics/remap.py)
(`config.gx1pop_step`), driven by `model.driver.Model.step` / `.run`; the
kernels are the fused EVP subcycles (kernels/evp.py) and the one-pass and
flux-only transport kernels (kernels/remap.py). The Model keeps the
calendar (calendar.py), writes history (io/history.py) and restarts
(io/restart.py, files shared with the JAX package) and resumes from them
with runtype='continue'. `config.gx1pop_dyn` with `Model.run_dynamics`
runs the dynamics-transport supercycle alone.

Forcing: analytic (box2001, uniform, calm, seasonal) and file datasets
(NCAR, JRA55, monthly, HadGEM, oned, ISPOL atmospheres; climatology and
HYCOM oceans; io/forcing_files.py). Grids: rectangular, lat-lon, the
file-less tripole and displaced-pole stand-ins and POP binaries, with
cyclic, open, closed and tripole (U- or T-fold) boundaries. The CLI
(`python -m cice_tpu_torch.cli run|test`) runs the reference's option sets,
among them the gx3pop, gx1pop and tx1pop baselines on fixtures it writes
(io/fixtures.py). On the card a kernel that cannot take a grid (tripole,
y-cyclic) or a dtype raises; a run names the plain engines instead.
"""

from .config import Config, gx1pop_dyn, gx1pop_step
