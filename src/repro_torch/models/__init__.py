"""The model serving path of the dense-attention families: ``config``
(a copy of the JAX package's ``ModelConfig``), ``layers``, ``flash``
(the attention forward over the CUDA flash kernel) and ``model``
(parameters, prefill, decode)."""
