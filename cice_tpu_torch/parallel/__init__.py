"""Runs across ranks over torch.distributed: the rank grid and its
point-to-point exchange (`mesh`), decompositions (`decomp`), the wide-halo
EVP (`evp_wide`) and the rank workers of the tests and the smoke script
(`spawn`)."""
