"""The port's command-line interface (``gordo-components-torch``)."""

from gordo_components_torch.cli.cli import main

__all__ = ["main"]
