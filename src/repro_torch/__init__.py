"""PyTorch/CUDA port of the Kairos reproduction (``repro``, JAX).

Runs the disaggregated serving path on an NVIDIA H100 with hand-written
CUDA attention kernels; the JAX package is the reference it is tested
against. Entry points take ``device`` ("cuda" by default) and raise when
no card is present unless the caller asks for ``"cpu"``.
"""
