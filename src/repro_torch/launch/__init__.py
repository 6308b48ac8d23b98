"""Entry points: ``serve`` (batched greedy generation, the retrieval
plane), ``train`` (the dedup-fed trainer) and ``mesh`` (meshes of ranks
over a ``torch.distributed`` process group)."""
