"""Hand-written CUDA kernels (csrc/), their build (build.py) and their wrappers."""
