"""Hand-written Hopper kernels (``csrc/``), their build, wrappers and plain
PyTorch versions. Nothing is compiled at import time."""
