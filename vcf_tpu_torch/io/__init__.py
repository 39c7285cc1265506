"""Host-side image and video I/O."""

from vcf_tpu_torch.io.images import read_image, write_image, test_image
from vcf_tpu_torch.io.video import test_video

__all__ = ["read_image", "write_image", "test_image", "test_video"]
