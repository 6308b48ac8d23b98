"""Step factories: the compute-dtype cast, the train and eval steps, and
the prefill / decode steps."""
