"""Hand-written CUDA kernels (``csrc/``): build, bindings and plain versions."""
