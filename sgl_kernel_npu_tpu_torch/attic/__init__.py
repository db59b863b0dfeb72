"""The retired decode kernels of the repository's attic/ (counterpart of
attic/ops_attention/): superseded by the live tiers, on no model or bench
path, kept with their Hopper kernels so that every TPU kernel of the
repository has one. The package's top-level __init__ does not import it."""
