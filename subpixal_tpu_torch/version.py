"""Version of subpixal_tpu_torch: the JAX package's version string, which
the port follows."""

__version__ = "0.5.0"
