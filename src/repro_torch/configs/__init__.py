"""Architecture configurations: copies of the JAX package's ``configs/``
(pure data, no jax).  ``registry.get_config(arch, smoke=...)`` resolves
``--arch``."""
