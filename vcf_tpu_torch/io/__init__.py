"""Host-side image I/O."""

from vcf_tpu_torch.io.images import read_image, write_image, test_image

__all__ = ["read_image", "write_image", "test_image"]
