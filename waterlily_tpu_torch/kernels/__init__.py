"""Build and load the hand-written CUDA kernels (``csrc/``)."""
