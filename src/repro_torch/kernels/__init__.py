"""The hand-written CUDA kernels, their builds and plain versions."""
