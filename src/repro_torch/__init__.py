"""PyTorch/CUDA port of the warm-start flow matching system.

Beside the JAX package ``repro`` (the reference, which this package never
imports), ``repro_torch`` serves the DiT warm-start refinement on an
NVIDIA H100 through hand-written CUDA kernels (``kernels/``). Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
