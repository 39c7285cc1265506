"""Hand-written CUDA kernels (sources in vcf_tpu_torch/csrc) and their
wrappers, one plain torch version beside each kernel."""
