"""Step factories: the compute-dtype cast and the prefill / decode
steps."""
