"""Host-side image and video I/O."""

from vcf_tpu_torch.io.images import read_image, write_image, test_image
from vcf_tpu_torch.io.video import (read_video, read_y4m, test_video,
                                    write_preview, write_video, write_y4m)

__all__ = ["read_image", "write_image", "test_image", "test_video",
           "read_video", "write_video", "write_preview", "write_y4m",
           "read_y4m"]
