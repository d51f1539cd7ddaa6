"""repro_torch — the AutoSPADA platform in PyTorch, for NVIDIA Hopper.

A port of the JAX package `repro`, laid out like it (`core`, `fleet`,
`kernels`, `serve`, `launch`). It imports torch, numpy and the standard
library, never jax or `repro`. Entry points run on the card unless the
caller passes ``device="cpu"``; asking for CUDA where there is none
raises.
"""
