"""`python -m cornetto_tpu_torch` == `python -m cornetto_tpu_torch.cli`."""

import sys

from cornetto_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
