"""Device-side operators (torch) and the CUDA kernels under ops/cuda."""
