"""Hand-written CUDA kernels of the port (``csrc/``), each with a wrapper
(``ops.py``) that counts its launches and a plain PyTorch version
(``ref.py``) that CPU tensors take."""
