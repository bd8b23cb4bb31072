"""``python -m torcheval_tpu_torch.analysis`` — the port's tpulint CLI."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
