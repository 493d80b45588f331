import sys

from kube_batch_tpu_torch.cli import main

sys.exit(main())
