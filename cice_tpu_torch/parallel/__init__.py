"""Runs across ranks over torch.distributed: the rank grid, its
point-to-point exchange and the sharding of a state into its tiles
(`mesh`), decompositions (`decomp`), the wide-halo EVP and the padding of
tiles by their neighbours' rings (`evp_wide`), and the rank workers of the
tests, the CLI and the smoke script (`spawn`)."""
