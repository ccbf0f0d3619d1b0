"""Data providers of the port."""

from gordo_components_torch.dataset.data_provider.base import GordoBaseDataProvider, Series
from gordo_components_torch.dataset.data_provider.providers import RandomDataProvider

__all__ = ["GordoBaseDataProvider", "RandomDataProvider", "Series"]
