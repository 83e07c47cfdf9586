"""Flux-limited-diffusion radiation (counterpart of `castro_tpu/radiation/`):
the gray and multigroup implicit updates (`fld.py`), frequency-space
advection (`fspace.py`), Compton scattering between groups (`compton.py`)
and the Purser filters (`filter.py`). All torch ops, as the JAX package
leaves them to XLA."""
