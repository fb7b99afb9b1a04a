"""cice_tpu_torch — the PyTorch/CUDA port of cice_tpu for NVIDIA Hopper.

A package beside `cice_tpu` (the JAX reference, which it never imports):
plain PyTorch for the dense stencil code, hand-written CUDA kernels
(csrc/, built with nvcc on first use) for the hot loops the JAX package
runs as Pallas TPU kernels. Entry points run on "cuda" unless the caller
passes device="cpu"; on CPU tensors every kernel wrapper runs its plain
PyTorch version.

Ported so far (slice 1): the dynamics-transport supercycle — B-grid EVP
(fused CUDA kernel, kernels/evp.py) and exact incremental remapping (fused
CUDA kernel, kernels/remap.py) — on the gx1 displaced-pole grid
(`config.gx1pop_dyn`), driven by `model.driver.Model.run_dynamics`.
"""

from .config import Config, gx1pop_dyn
