"""PyTorch + CUDA port of the DuetServe reproduction (``repro``, JAX/Pallas).

Module for module it mirrors ``repro``'s layout and names, so each module
here has one counterpart in the reference; it imports nothing of the
reference and no JAX. Entry points run on the CUDA card unless the caller
passes ``device="cpu"`` (``--device cpu``).
"""
