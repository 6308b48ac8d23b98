"""The model stack of every family of the registry: ``config`` (a copy of
the JAX package's ``ModelConfig``), ``layers``, ``flash`` (the attention
forward over the CUDA flash kernel), ``moe`` and ``moe_sharded`` (the
expert-parallel MoE), ``ssm``, ``decode_sp`` (sequence-parallel decode),
``io`` (input stand-ins and synthetic batches) and ``model``
(parameters, forward, prefill, decode)."""
