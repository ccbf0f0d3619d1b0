"""Data providers of the port."""

from gordo_components_torch.dataset.data_provider.base import GordoBaseDataProvider, Series
from gordo_components_torch.dataset.data_provider.datalake import (
    DataLakeProvider,
    IrocReader,
    NcsReader,
)
from gordo_components_torch.dataset.data_provider.providers import (
    FileSystemProvider,
    InfluxDataProvider,
    RandomDataProvider,
)

__all__ = [
    "DataLakeProvider",
    "FileSystemProvider",
    "GordoBaseDataProvider",
    "InfluxDataProvider",
    "IrocReader",
    "NcsReader",
    "RandomDataProvider",
    "Series",
]
