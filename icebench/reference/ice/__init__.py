"""A frozen copy of the sea-ice model's plain PyTorch path, the yardstick
that `icebench` holds the program against.

The modules are the program's own as they stood when the benchmark was
defined, cut to what the benchmark's configurations run: the CUDA
kernels, the runs across ranks, the files, the command line and every
engine no configuration uses are left out, and the plain engines (the
EVP's plain loop, the plain exact remap) are the only ones it runs
(`model.step.check_supported` refuses the rest). It never changes with
the program: a later change to the program that gives other answers
shows against it. `reference.py` holds its `ReferenceModel`; a later
reference may import these modules and add only its own engines.
"""
