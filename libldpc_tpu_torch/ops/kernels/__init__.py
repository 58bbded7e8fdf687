"""The CUDA decode kernels: tables, build, wrappers and plain versions."""
