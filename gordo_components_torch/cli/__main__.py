"""``python -m gordo_components_torch.cli``."""

import sys

from gordo_components_torch.cli.cli import main

if __name__ == "__main__":
    sys.exit(main())
