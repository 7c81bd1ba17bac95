"""PyTorch and CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package (``repro``) is the reference; this package imports nothing
of it.  Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel's wrapper takes its plain PyTorch
version."""
