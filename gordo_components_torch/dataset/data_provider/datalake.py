"""Data-lake providers: path-convention readers over a mounted file tree.

Counterpart of ``gordo_components_tpu/dataset/data_provider/datalake.py``,
without pandas. The lake is a directory tree at ``store_path`` (a mounted
lake, or a copy of one):

    <store_path>/<asset>/<TAG>/<TAG>_<year>.csv      NCS yearly CSV
    <store_path>/<asset>/<TAG>/<TAG>_<year>.parquet  NCS yearly parquet
    <store_path>/<asset>/<file>.csv                  IROC facility dump

- NCS yearly CSV: semicolon-separated, headerless rows ``tag;value;timestamp``.
- NCS yearly parquet: a pandas frame with a DatetimeIndex and a value
  column (``value_name``, else the first), read by the port's own parquet
  reader (``_files.read_parquet``).
- IROC facility CSV: comma-separated with a header naming ``tag``,
  ``timestamp`` and ``value``; one file holds many tags.

:class:`DataLakeProvider` dispatches each tag to the first reader that can
read it. Its two auth modes (``interactive``, ``dl_service_auth_str``) build
a credential over :mod:`.auth` whose tokens are fetched only when a remote
transport asks for headers, so reads of a mounted lake never touch the
network. Series are ``Series(name, int64 ns UTC, float64)``.
"""

import glob
import logging
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from gordo_components_torch.dataset.data_provider._files import (
    float_column,
    read_csv,
    read_parquet,
    time_column,
)
from gordo_components_torch.dataset.data_provider.base import (
    GordoBaseDataProvider,
    Series,
    empty_series,
    sorted_in_range,
)
from gordo_components_torch.dataset.sensor_tag import SensorTag
from gordo_components_torch.utils import capture_args

logger = logging.getLogger(__name__)


def _asset_dir(store_path: str, asset_paths: Optional[Dict[str, str]], tag: SensorTag) -> str:
    """The tag's asset directory: the asset's name under ``store_path``
    unless ``asset_paths`` maps it elsewhere."""
    asset = tag.asset or ""
    return os.path.join(store_path, (asset_paths or {}).get(asset, asset))


def _year(ns: int) -> int:
    return int(np.datetime64(int(ns), "ns").astype("datetime64[Y]").astype(np.int64)) + 1970


class NcsReader(GordoBaseDataProvider):
    """Per-tag per-year files: ``<store>/<asset>/<TAG>/<TAG>_<year>.csv``
    (or ``.parquet``). Years of the range without a file are skipped; a tag
    without a directory raises."""

    @capture_args
    def __init__(self, store_path: str, asset_paths: Optional[Dict[str, str]] = None,
                 value_name: str = "Value"):
        self.store_path = store_path
        self.asset_paths = asset_paths
        self.value_name = value_name

    def _tag_dir(self, tag: SensorTag) -> str:
        return os.path.join(_asset_dir(self.store_path, self.asset_paths, tag), tag.name)

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return os.path.isdir(self._tag_dir(tag))

    def _read_year(self, tag: SensorTag, year: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        stem = os.path.join(self._tag_dir(tag), f"{tag.name}_{year}")
        if os.path.exists(stem + ".parquet"):
            index, names, columns = read_parquet(stem + ".parquet")
            if index is None:
                raise ValueError(f"{stem}.parquet: no timestamp index")
            col = self.value_name if self.value_name in names else names[0]
            return index, np.asarray(columns[col], np.float64)
        if os.path.exists(stem + ".csv"):
            _, columns = read_csv(stem + ".csv", delimiter=";", names=["tag", "value", "timestamp"])
            where = stem + ".csv"
            return time_column(columns["timestamp"], where), float_column(columns["value"], where)
        return None

    def load_series(self, from_ns: int, to_ns: int, tag_list: List[SensorTag],
                    dry_run: bool = False) -> Iterable[Series]:
        if from_ns >= to_ns:
            raise ValueError(f"from {from_ns} must precede to {to_ns} (ns)")
        for tag in tag_list:
            if not self.can_handle_tag(tag):
                raise FileNotFoundError(
                    f"No NCS directory for tag {tag.name!r} (expected {self._tag_dir(tag)!r})")
            first, last = _year(from_ns), _year(to_ns)
            parts = [p for p in (self._read_year(tag, y) for y in range(first, last + 1)) if p is not None]
            if not parts:
                logger.warning("Tag %r has no files in years %d..%d", tag.name, first, last)
                yield empty_series(tag.name)
                continue
            series = sorted_in_range(tag.name, np.concatenate([p[0] for p in parts]),
                                     np.concatenate([p[1] for p in parts]), from_ns, to_ns)
            if dry_run:
                logger.info("dry_run: %s -> %d rows", tag.name, series.index.size)
            yield series


class IrocReader(GordoBaseDataProvider):
    """Facility CSV dumps: every ``*.csv`` directly under the asset
    directory, with a header naming ``tag``, ``timestamp`` and ``value``;
    one file holds many tags."""

    @capture_args
    def __init__(self, store_path: str, asset_paths: Optional[Dict[str, str]] = None):
        self.store_path = store_path
        self.asset_paths = asset_paths

    def _asset_files(self, tag: SensorTag, cache: Optional[Dict[str, List[str]]] = None) -> List[str]:
        # a listing of a network mount is a round trip: one per asset
        # directory within one load_series call
        d = _asset_dir(self.store_path, self.asset_paths, tag)
        if cache is not None and d in cache:
            return cache[d]
        out = sorted(glob.glob(os.path.join(d, "*.csv")))
        if cache is not None:
            cache[d] = out
        return out

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return bool(self._asset_files(tag))

    @staticmethod
    def _read(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tag names, int64 ns, float64 values) of one facility file."""
        names, columns = read_csv(path)
        missing = {"tag", "timestamp", "value"} - set(names)
        if missing:
            raise ValueError(f"{path}: no column {sorted(missing)} in the header {names}")
        return (np.asarray(columns["tag"], dtype=object), time_column(columns["timestamp"], path),
                float_column(columns["value"], path))

    def load_series(self, from_ns: int, to_ns: int, tag_list: List[SensorTag],
                    dry_run: bool = False) -> Iterable[Series]:
        if from_ns >= to_ns:
            raise ValueError(f"from {from_ns} must precede to {to_ns} (ns)")
        listings: Dict[str, List[str]] = {}
        files: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for tag in tag_list:  # each file read once, not once per tag
            for path in self._asset_files(tag, listings):
                if path not in files:
                    files[path] = self._read(path)
        for tag in tag_list:
            paths = self._asset_files(tag, listings)
            if not paths:
                raise FileNotFoundError(
                    f"No IROC files for tag {tag.name!r} under "
                    f"{_asset_dir(self.store_path, self.asset_paths, tag)!r}")
            picks = [(files[p], files[p][0] == tag.name) for p in paths]
            index = np.concatenate([f[1][mine] for f, mine in picks])
            if index.size == 0:
                logger.warning("Tag %r not present in IROC files %s", tag.name, paths)
                yield empty_series(tag.name)
                continue
            values = np.concatenate([f[2][mine] for f, mine in picks])
            yield sorted_in_range(tag.name, index, values, from_ns, to_ns)


class DataLakeProvider(GordoBaseDataProvider):
    """Dispatches each tag to the lake reader that can read it.

    ``interactive`` / ``dl_service_auth_str`` build a ``LakeCredential``
    over the OAuth2 flows of :mod:`.auth` (device code / service
    principal). Its tokens are fetched lazily, so reading a lake mounted at
    ``store_path`` never touches the network; a remote transport calls
    ``provider.credential.headers()``. ``dl_service_auth_str`` may be
    ``env:VAR`` (the secret stays in the environment); a literal secret is
    kept out of the captured parameters. ``auth_transport`` and
    ``auth_kwargs`` inject the HTTP transport and the flow's settings.
    """

    @capture_args
    def __init__(
        self,
        store_path: str,
        asset_paths: Optional[Dict[str, str]] = None,
        interactive: bool = False,
        dl_service_auth_str: Optional[str] = None,
        value_name: str = "Value",
        auth_transport=None,
        auth_kwargs: Optional[Dict] = None,
    ):
        from gordo_components_torch.dataset.data_provider.auth import credential_from_config

        self.store_path = store_path
        self.asset_paths = asset_paths
        # callables the definition language cannot express: not parameters
        self._params.pop("auth_transport", None)
        self._params.pop("auth_kwargs", None)
        resolved_auth = dl_service_auth_str
        if dl_service_auth_str and dl_service_auth_str.startswith("env:"):
            var = dl_service_auth_str[4:]
            resolved_auth = os.environ.get(var)
            if not resolved_auth:
                raise ValueError(f"dl_service_auth_str points at env var {var!r}, which is unset")
        elif dl_service_auth_str:
            if dl_service_auth_str.endswith(":***"):
                raise ValueError(
                    "dl_service_auth_str is a redacted value from artifact metadata "
                    "('tenant:client:***'); configure the real secret via the 'env:VARNAME' form")
            head = ":".join(dl_service_auth_str.split(":")[:2])
            self._params["dl_service_auth_str"] = head + ":***"
            logger.warning("DataLakeProvider: dl_service_auth_str passed as a literal; prefer the "
                           "'env:VARNAME' form so configs and artifact metadata never carry the secret")
        self.credential = credential_from_config(
            interactive=interactive, dl_service_auth_str=resolved_auth, transport=auth_transport,
            **(auth_kwargs or {}),
        )
        self.readers: List[GordoBaseDataProvider] = [
            NcsReader(store_path, asset_paths=asset_paths, value_name=value_name),
            IrocReader(store_path, asset_paths=asset_paths),
        ]

    def _reader_for(self, tag: SensorTag) -> Optional[GordoBaseDataProvider]:
        return next((r for r in self.readers if r.can_handle_tag(tag)), None)

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return self._reader_for(tag) is not None

    def load_series(self, from_ns: int, to_ns: int, tag_list: List[SensorTag],
                    dry_run: bool = False) -> Iterable[Series]:
        # one call per reader, then the caller's order by position: two
        # tags of one name on two assets stay two series
        readers = []
        for tag in tag_list:
            reader = self._reader_for(tag)
            if reader is None:
                raise FileNotFoundError(
                    f"No lake reader can handle tag {tag.name!r} (asset {tag.asset!r}) "
                    f"under {self.store_path!r}")
            readers.append(reader)
        results: List[Optional[Series]] = [None] * len(tag_list)
        for reader in self.readers:
            positions = [i for i, r in enumerate(readers) if r is reader]
            if positions:
                tags = [tag_list[i] for i in positions]
                for i, series in zip(positions, reader.load_series(from_ns, to_ns, tags, dry_run)):
                    results[i] = series
        yield from results
