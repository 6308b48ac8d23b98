"""PyTorch / CUDA port of the b-bit sketch trie (bST) for NVIDIA Hopper.

Mirrors the module layout of the JAX package ``repro`` (the reference):
``repro_torch.core`` holds the index, search and top-k, and
``repro_torch.kernels`` the hand-written CUDA kernels with their plain
PyTorch versions.  Imports torch, numpy and the standard library only.
Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
asked for and missing.
"""
