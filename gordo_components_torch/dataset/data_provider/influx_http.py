"""A minimal InfluxDB 1.x HTTP client, standard library only.

Counterpart of ``gordo_components_tpu/dataset/data_provider/influx_http.py``
without pandas. It speaks the wire protocol that ``influxdb``'s
``DataFrameClient`` speaks:

- ``GET /query?db=<db>&q=<iql>``, with HTTP basic auth when a username
  is given;
- the answer ``{"results": [{"series": [{"name", "columns", "values"}],
  "error"?}]}``, read into ``{measurement: {column: ndarray}}`` with
  ``time`` as int64 ns (UTC): RFC3339 times to the nanosecond
  (``times.parse_times``), numeric columns as float64 (a null as NaN),
  others as object arrays. Series of one measurement split over several
  entries are concatenated in order.

A statement error arrives with HTTP 200 and raises ``RuntimeError``; a
server that cannot be reached raises urllib's ``URLError``. The keyword
names are ``DataFrameClient``'s (host, port, username, password, database,
ssl), so ``providers._client_from_uri`` builds either.
"""

import base64
import json
import urllib.request
from typing import Dict, List, Optional
from urllib.parse import urlencode

import numpy as np

from gordo_components_torch.dataset.times import parse_times


def _column(name: str, values: List) -> np.ndarray:
    if name == "time":
        return parse_times(values)
    try:
        return np.asarray(values, dtype=np.float64)
    except (TypeError, ValueError):
        return np.asarray(values, dtype=object)


class SimpleInfluxClient:
    """``query(iql) -> {measurement: {column: ndarray}}`` over the Influx
    1.x HTTP API."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 8086,
        username: Optional[str] = None,
        password: Optional[str] = None,
        database: Optional[str] = None,
        ssl: bool = False,
        timeout: float = 30.0,
    ):
        self.host = host
        self.port = int(port)
        self.username = username
        self.password = password
        self.database = database
        self.ssl = bool(ssl)
        self.timeout = float(timeout)

    @property
    def _base_url(self) -> str:
        return f"{'https' if self.ssl else 'http'}://{self.host}:{self.port}"

    def query(self, q: str) -> Dict[str, Dict[str, np.ndarray]]:
        params = {"q": q}
        if self.database:
            params["db"] = self.database
        req = urllib.request.Request(f"{self._base_url}/query?{urlencode(params)}")
        if self.username is not None:
            token = base64.b64encode(f"{self.username}:{self.password or ''}".encode()).decode()
            req.add_header("Authorization", f"Basic {token}")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = json.load(resp)

        parts: Dict[str, List[Dict[str, np.ndarray]]] = {}
        for result in body.get("results", []):
            if "error" in result:
                # a statement error (bad InfluxQL, unknown database) comes
                # with HTTP 200
                raise RuntimeError(f"InfluxDB query error: {result['error']}")
            for series in result.get("series", []) or []:
                cols = series.get("columns", [])
                rows = series.get("values", [])
                parts.setdefault(series.get("name", ""), []).append(
                    {c: _column(c, [row[j] for row in rows]) for j, c in enumerate(cols)})
        return {name: {c: np.concatenate([p[c] for p in frames]) for c in frames[0]}
                for name, frames in parts.items()}
