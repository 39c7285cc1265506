import sys

from vcf_tpu_torch.cli import main

sys.exit(main())
