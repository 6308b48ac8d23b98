"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref.py``) and the wrappers that dispatch between them
(``ops.py``)."""
