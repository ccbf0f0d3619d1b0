"""The port's bulk client on the CPU, the slice as a whole, against the JAX
package's.

A small collection (three 10-tag dense detectors and an
``lstm_hourglass`` at lookback 8, fitted by the JAX package, with
``RandomDataset`` metadata) is carried across to the port
(``tools/jax_artifact_to_torch.py``) and served:

- by the port's server (the bank, a Unix socket, the ring): the JAX
  client and the port's score the same day in chunks of 50 rows (the LSTM
  target loses 7 rows a chunk), over JSON and over tensor; values bitwise
  ``jax_df.to_numpy()``, columns ``list(jax_df.columns)``, the index the
  JAX index in ns;
- by the JAX server and by the port's: each package's client against its
  own server, within the bands of ``tests/test_torch_wire.py`` (dense rtol
  0 / atol 1e-5, LSTM rtol 1e-5 / atol 1e-6), and the port's client
  against the JAX server bitwise the JAX client's;
- the port's rungs (Unix socket, ring, parquet, tensor over TCP, and the
  per-model server) bitwise its TCP/JSON rung; a stub that refuses tensor
  and parquet bodies sends an ``"auto"`` run to JSON, never a forced one; a Unix
  socket that dies mid-run sends the rest of the run over TCP once; a
  stale routing table is rerouted through a stub ``/routing``, as JAX's.
- the forwarders: the Influx points equal JAX's, the parquet files read
  by pyarrow and the port's reader as the JAX forwarder's.
- a per-model tensor POST with warnings as errors (the read-only rows).

Every network wait has a timeout.
"""

import asyncio
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
from aiohttp.test_utils import TestServer

from gordo_components_torch.client import Client as PortClient
from gordo_components_torch.client import ForwardPredictionsIntoInflux as PortInflux
from gordo_components_torch.client import ForwardPredictionsIntoParquet as PortParquet
from gordo_components_torch.dataset.data_provider._parquet import read_parquet
from gordo_components_torch.server import run_server
from gordo_components_torch.utils.wire import TENSOR_CONTENT_TYPE
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.client import Client as JaxClient
from gordo_components_tpu.client import ForwardPredictionsIntoInflux as JaxInflux
from gordo_components_tpu.client import ForwardPredictionsIntoParquet as JaxParquet
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector, LSTMAutoEncoder
from gordo_components_tpu.server import build_app as jax_build_app
from torch_client_stubs import ClosingUnixSocket, Stub, answer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch", os.path.join(REPO, "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

TAGS = [f"tag-{i}" for i in range(10)]
DENSE = ["cl-dense-0", "cl-dense-1", "cl-dense-2"]
LSTM = "cl-lstm"
NAMES = DENSE + [LSTM]
START, END = "2020-01-01T00:00:00Z", "2020-01-02T00:00:00Z"  # 144 rows at 10 min
BATCH = 50  # three chunks a target
DATASET = {"type": "RandomDataset", "tag_list": TAGS, "resolution": "10min"}
TIMEOUT_S = 120  # the bound of a run's network waits
BANDS = {"dense": (0, 1e-5), "lstm": (1e-5, 1e-6)}


def _port(**kwargs):
    return PortClient("proj", **{"batch_size": BATCH, "parallelism": 4, **kwargs})


def _jax_frames(results):
    return {r.name: r.predictions for r in results}


def _port_frames(results):
    assert all(r.ok for r in results), [(r.name, r.error_messages[:1]) for r in results]
    return {r.name: r.predictions for r in results}


def _same(port, jax):
    """A port frame bitwise a JAX frame: values, columns, index in ns."""
    assert port.values.dtype == np.float64
    np.testing.assert_array_equal(port.values, jax.to_numpy())
    assert port.columns == list(jax.columns)
    np.testing.assert_array_equal(port.index.view("i8"), jax.index.as_unit("ns").asi8)


def _same_port(got, want):
    for name in NAMES:
        np.testing.assert_array_equal(got[name].values, want[name].values, err_msg=name)
        assert got[name].columns == want[name].columns
        np.testing.assert_array_equal(got[name].index, want[name].index)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root) of the collection, written once."""
    rng = np.random.RandomState(3)
    X = pd.DataFrame(rng.rand(160, 10).astype("float32"), columns=TAGS)
    jax_root, port_root = tmp_path_factory.mktemp("jaxc"), tmp_path_factory.mktemp("portc")
    for name in NAMES:
        if name == LSTM:
            est = LSTMAutoEncoder(kind="lstm_hourglass", lookback_window=8, epochs=1, batch_size=64)
        else:
            est = AutoEncoder(kind="feedforward_hourglass", epochs=1, batch_size=64)
        model = DiffBasedAnomalyDetector(base_estimator=est)
        model.fit(X)
        jax_serializer.dump(model, str(jax_root / name), metadata={"name": name, "dataset": DATASET})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    return str(jax_root), str(port_root)


@pytest.fixture(scope="module")
def served(roots):
    """The port's server over the collection (bank, Unix socket, ring) and
    a per-model one."""
    sock_dir = tempfile.mkdtemp(prefix="gcl")
    ring = f"gordo-cl-{os.getpid()}"
    server = run_server(roots[1], host="127.0.0.1", port=0, device="cpu", background=True,
                        uds_path=os.path.join(sock_dir, "s.sock"), shm_ring=ring)
    per_model = run_server(roots[1], host="127.0.0.1", port=0, device="cpu", background=True, use_bank=False)
    try:
        if server.app._warmup is not None:
            server.app._warmup.join(TIMEOUT_S)
        yield server, per_model, ring, os.path.join(sock_dir, "s.sock")
    finally:
        per_model.close()
        server.close()
        shutil.rmtree(sock_dir, ignore_errors=True)


@pytest.fixture(scope="module")
def port_json(served):
    """The port client's TCP/JSON run, the reference of its other rungs."""
    client = _port(base_url=served[0].url, use_tensor=False, use_parquet=False, transport="tcp")
    frames = _port_frames(client.predict(START, END))
    assert client.wire_stats == {"json": {"posts": 12, "bytes_out": client.wire_stats["json"]["bytes_out"],
                                          "rows": 576}}
    return frames


def _jax_predict(base_url, **kwargs):
    async def go():
        client = JaxClient("proj", base_url=base_url, batch_size=BATCH, parallelism=4, **kwargs)
        return await asyncio.wait_for(client.predict_async(pd.Timestamp(START), pd.Timestamp(END)), TIMEOUT_S)
    return asyncio.run(go())


@pytest.mark.parametrize("encoding", ["json", "tensor"])
def test_port_and_jax_clients_agree_bitwise_on_one_server(served, port_json, encoding):
    tensor = encoding == "tensor"
    jax = _jax_predict(served[0].url, use_tensor=tensor, use_parquet=False, transport="tcp")
    assert all(r.ok for r in jax), [(r.name, r.error_messages[:1]) for r in jax]
    client = _port(base_url=served[0].url, use_tensor=tensor, use_parquet=False, transport="tcp")
    port = _port_frames(client.predict(START, END))
    assert [r.name for r in jax] == NAMES
    for name, frame in _jax_frames(jax).items():
        _same(port[name], frame)
    assert len(port[LSTM]) == 3 * BATCH - 6 - 3 * 7 and len(port[DENSE[0]]) == 144
    assert list(client.wire_stats) == [encoding]
    _same_port(port, port_json)


def test_each_package_over_its_own_server_agrees_within_the_bands(roots, served):
    async def jax_run():
        server = TestServer(jax_build_app(roots[0]))
        await server.start_server()
        try:
            base = str(server.make_url("")).rstrip("/")
            client = JaxClient("proj", base_url=base, batch_size=BATCH, parallelism=4, transport="tcp")
            jax = await asyncio.wait_for(client.predict_async(pd.Timestamp(START), pd.Timestamp(END)), TIMEOUT_S)
            # the port's client against the JAX server too (aiohttp keeps
            # its sockets alive: the pool's path), over tensor and JSON
            ported = [await asyncio.wait_for(_port(base_url=base, transport="tcp", use_tensor=tensor,
                                                   use_parquet=False).predict_async(START, END), TIMEOUT_S)
                      for tensor in (True, False)]
            return jax, ported
        finally:
            await server.close()

    jax, ported = asyncio.run(jax_run())
    jax = _jax_frames(jax)
    for run in ported:
        for name, frame in _port_frames(run).items():
            _same(frame, jax[name])
    port = _port_frames(_port(base_url=served[0].url, transport="tcp").predict(START, END))
    for name in NAMES:
        rtol, atol = BANDS["lstm" if name == LSTM else "dense"]
        np.testing.assert_allclose(port[name].values, jax[name].to_numpy(), rtol=rtol, atol=atol, err_msg=name)
        assert port[name].columns == list(jax[name].columns)
        np.testing.assert_array_equal(port[name].index.view("i8"), jax[name].index.as_unit("ns").asi8)


RUNGS = {
    "tensor-tcp": dict(use_tensor=True, transport="tcp"),
    "uds": dict(use_tensor=True, transport="uds"),
    "shm": dict(use_tensor=True, transport="shm"),
    "auto": dict(),
    "parquet": dict(use_tensor=False, use_parquet=True, transport="tcp"),
    "json-uds": dict(use_tensor=False, use_parquet=False, transport="uds"),
    "per-model-tensor": dict(use_tensor=True, transport="tcp"),
}


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_port_rungs_are_bitwise_its_tcp_json_rung(served, port_json, rung):
    server, per_model = served[0], served[1]
    base = per_model.url if rung.startswith("per-model") else server.url
    client = _port(base_url=base, **RUNGS[rung])
    got = _port_frames(client.predict(START, END))
    if rung.startswith("per-model"):
        want = _port_frames(_port(base_url=base, use_tensor=False, use_parquet=False,
                                  transport="tcp").predict(START, END))
    else:
        want = port_json
    _same_port(got, want)
    expected = {"tensor-tcp": "tcp", "uds": "uds", "shm": "shm", "auto": "shm", "parquet": "tcp",
                "json-uds": "uds", "per-model-tensor": "tcp"}[rung]
    assert client.transport_used == expected
    encoding = "parquet" if rung == "parquet" else "json" if rung == "json-uds" else "tensor"
    assert list(client.wire_stats) == [encoding] and client.wire_stats[encoding]["rows"] == 576


def _refusing_proxy(upstream):
    """A stub in front of ``upstream`` that answers 400 to any body but
    JSON (a server that speaks JSON alone)."""
    def handler(method, path, headers, body):
        if method == "POST" and headers.get("Content-Type") != "application/json":
            return answer(400, {"error": "unsupported content type"})
        req = urllib.request.Request(upstream + path, data=body if method == "POST" else None,
                                     headers={"Content-Type": headers.get("Content-Type", "application/json")},
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
                return resp.status, {"Content-Type": resp.headers["Content-Type"]}, resp.read(), 0
        except urllib.error.HTTPError as exc:
            return exc.code, {"Content-Type": exc.headers["Content-Type"]}, exc.read(), 0
    return Stub(handler=handler)


def test_refused_tensor_and_parquet_bodies_downgrade_an_auto_run_to_json(served, port_json, caplog):
    proxy = _refusing_proxy(served[0].url)
    try:
        # over TCP: the proxy passes on /models' transports, and the ring
        # or the socket would reach the server past it
        client = _port(base_url=proxy.url, parallelism=1, transport="tcp")
        got = _port_frames(client.predict(START, END))
        posts = [h.get("Content-Type") for m, _, h, _ in proxy.requests if m == "POST"]
    finally:
        proxy.close()
    _same_port(got, port_json)
    # one refusal of each, then the run is JSON
    assert posts.count(TENSOR_CONTENT_TYPE) == posts.count("application/x-parquet") == 1
    assert list(client.wire_stats) == ["json"] and posts.count("application/json") == 12
    assert client.transport_used == "tcp" and "downgrading run" in caplog.text


def test_a_forced_tensor_run_never_downgrades(served):
    proxy = _refusing_proxy(served[0].url)
    try:
        results = _port(base_url=proxy.url, use_tensor=True, transport="tcp").predict(START, END)
    finally:
        proxy.close()
    assert not any(r.ok for r in results)
    assert all(len(r.error_messages) == 3 and "HTTP 400" in r.error_messages[0] for r in results)


def test_a_dead_unix_socket_sends_the_run_over_tcp_once(served, port_json, caplog):
    sock_dir = tempfile.mkdtemp(prefix="gcd")
    dead = ClosingUnixSocket(os.path.join(sock_dir, "dead.sock"))
    try:
        client = _port(base_url=served[0].url, use_tensor=True, transport="uds", uds_path=dead.path, retries=1)
        got = _port_frames(client.predict(START, END))
    finally:
        dead.close()
        shutil.rmtree(sock_dir, ignore_errors=True)
    _same_port(got, port_json)
    assert client.transport_used == "tcp" and dead.accepted >= 1
    assert caplog.text.count("unix-socket transport failed mid-run") == 1
    assert list(client.wire_stats) == ["tensor"] and client.wire_stats["tensor"]["posts"] == 12


def test_a_stale_routing_table_is_rerouted_as_jax(served):
    """Replica 0 of the first table is a stub that no longer serves
    ``cl-dense-0`` (404 "No such model"); the forced refresh finds it on
    the port's server."""
    server = served[0]
    gone = Stub({"/gordo/v0/proj/cl-dense-0/anomaly/prediction": [answer(404, {"error": "No such model 'cl-dense-0'"})],
                 "/gordo/v0/proj/cl-dense-0/metadata": [answer(200, {"endpoint-metadata": {"dataset": DATASET}})]})
    tables = [{"version": 1, "members": {"cl-dense-0": 0},
               "replicas": [{"replica": 0, "url": gone.url}, {"replica": 1, "url": server.url}]},
              {"version": 2, "members": {"cl-dense-0": 1},
               "replicas": [{"replica": 0, "url": gone.url}, {"replica": 1, "url": server.url}]}]
    runs = {}
    try:
        for side in ("port", "jax"):
            watchman = Stub({"/routing": [answer(200, tables[0], {"ETag": '"1"'}),
                                          answer(200, tables[1], {"ETag": '"2"'})]})
            kwargs = dict(base_url=server.url, routing_url=watchman.url, use_tensor=False, use_parquet=False,
                          transport="tcp")
            try:
                if side == "port":
                    client = _port(**kwargs)
                    results = client.predict(START, END, targets=["cl-dense-0"])
                    frame = _port_frames(results)["cl-dense-0"]
                else:
                    async def go():
                        c = JaxClient("proj", batch_size=BATCH, parallelism=4, **kwargs)
                        r = await asyncio.wait_for(c.predict_async(pd.Timestamp(START), pd.Timestamp(END),
                                                                   targets=["cl-dense-0"]), TIMEOUT_S)
                        return c, r
                    client, results = asyncio.run(go())
                    frame = results[0].predictions
                    assert results[0].ok, results[0].error_messages
            finally:
                watchman.close()
            runs[side] = (frame, dict(client._fanout_stats), client.routing_version,
                          [p for p in watchman.paths()])
    finally:
        gone.close()
    _same(runs["port"][0], runs["jax"][0])
    assert runs["port"][1:] == runs["jax"][1:]
    assert runs["port"][1]["reroutes"] == 3 and runs["port"][2] == 2
    assert runs["port"][3] == ["/routing", "/routing?refresh=1"]


class _Points:
    def __init__(self):
        self.points = []

    def write_points(self, points):
        self.points.extend(points)


def test_forwarders_write_what_the_jax_forwarders_write(served, tmp_path):
    jax = _jax_predict(served[0].url, transport="tcp", use_tensor=True)
    port = PortClient("proj", base_url=served[0].url, batch_size=BATCH).predict(START, END)
    for j, p in zip(jax, port):
        jp, pp = _Points(), _Points()
        JaxInflux(client=jp).forward(j)
        PortInflux(client=pp).forward(p)
        assert pp.points == jp.points, j.name
        assert len(pp.points) == j.predictions.size
        JaxParquet(str(tmp_path / "jax")).forward(j)
        PortParquet(str(tmp_path / "port")).forward(p)
        jpath, ppath = (str(tmp_path / side / f"{j.name}.parquet") for side in ("jax", "port"))
        jdf, pdf = pd.read_parquet(jpath), pd.read_parquet(ppath)
        np.testing.assert_array_equal(pdf.to_numpy(), jdf.to_numpy())
        assert list(pdf.columns) == list(jdf.columns)
        assert list(pdf.dtypes) == list(jdf.dtypes)
        np.testing.assert_array_equal(pdf.index.as_unit("ns").asi8, jdf.index.as_unit("ns").asi8)
        assert str(pdf.index.tz) == str(jdf.index.tz) == "UTC"
        (ji, jn, jc), (pi, pn, pc) = read_parquet(jpath), read_parquet(ppath)
        assert pn == jn and np.array_equal(pi, ji)
        for name in jn:
            np.testing.assert_array_equal(pc[name], jc[name])


def test_predict_forwards_each_ok_target_and_ingest_waits_for_a8(served, tmp_path):
    client = _port(base_url=served[0].url, forwarder=PortParquet(str(tmp_path)))
    results = client.predict(START, END, targets=[DENSE[0], "ghost"])
    assert [r.ok for r in results] == [True, False]
    assert results[1].error_messages[0].startswith("dataset: HTTP 404 from ")
    assert sorted(os.listdir(tmp_path)) == [f"{DENSE[0]}.parquet"]
    # A8's /ingest is ported: this server runs without its streaming plane
    # (GORDO_STREAM=0), so it refuses the rows and the error names the knob
    with pytest.raises(ValueError, match=r"HTTP 404 .*GORDO_STREAM=0"):
        client.ingest(DENSE[0], np.zeros((3, 10)))


READ_ONLY_SCRIPT = r"""
import json, os, sys, urllib.request
import numpy as np
from gordo_components_torch import serializer
from gordo_components_torch.convert import entry_from_numpy, lstm_to_flax
from gordo_components_torch.models.factories.feedforward import hourglass_calc_dims
from gordo_components_torch.models.register import lookup_factory
from gordo_components_torch.server import run_server
from gordo_components_torch.utils.wire import pack_frames

rng = np.random.default_rng(0)
enc = hourglass_calc_dims(0.5, 3, 10)
dims = [10, *enc, *enc[::-1], 10]
params = {"params": {f"Dense_{i}": {"kernel": rng.standard_normal((a, b)).astype(np.float32),
                                    "bias": rng.standard_normal(b).astype(np.float32)}
                     for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}}
entry = entry_from_numpy("ro", "AutoEncoder", "feedforward_hourglass", {}, 10, params, np.zeros(10), np.ones(10),
                         np.zeros(10), np.ones(10), tags=[f"t{i}" for i in range(10)])
serializer.dump(entry, os.path.join(sys.argv[1], "ro"))
module = lookup_factory("LSTMAutoEncoder", "lstm_hourglass")(10)
state = {k: (0.3 * rng.standard_normal(tuple(v.shape))).astype(np.float32) for k, v in module.state_dict().items()}
entry = entry_from_numpy("ro-lstm", "LSTMAutoEncoder", "lstm_hourglass", {}, 10, lstm_to_flax(state), np.zeros(10),
                         np.ones(10), np.zeros(10), np.ones(10), tags=[f"t{i}" for i in range(10)], lookback=4)
serializer.dump(entry, os.path.join(sys.argv[1], "ro-lstm"))
server = run_server(sys.argv[1], host="127.0.0.1", port=0, device="cpu", background=True, use_bank=False)
try:
    X = rng.random((16, 10), dtype=np.float32)
    statuses = []
    for target, endpoint in (("ro", "anomaly/prediction"), ("ro", "prediction"), ("ro-lstm", "anomaly/prediction"),
                             ("ro-lstm", "prediction")):
        for frames in ([("X", X)], [("X", X), ("y", X)]):
            req = urllib.request.Request(f"{server.url}/gordo/v0/p/{target}/{endpoint}", data=pack_frames(frames),
                                         headers={"Content-Type": "application/x-gordo-tensor"})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    statuses.append(resp.status)
            except urllib.error.HTTPError as exc:
                statuses.append([exc.code, exc.read().decode()[:200]])
    print(json.dumps(statuses))
finally:
    server.close()
"""


def test_a_per_model_tensor_post_raises_no_warning(tmp_path):
    """Warnings are errors in the server: the tensor body's read-only rows
    must reach torch without the non-writable-array warning (which torch
    gives once a process, hence a process of its own)."""
    out = subprocess.run([sys.executable, "-W", "error", "-c", READ_ONLY_SCRIPT, str(tmp_path)],
                         capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [200] * 8


def test_a_client_that_goes_away_is_logged_not_printed(served, capsys):
    """A hedge's loser drops its socket before the server answers: the
    server logs it at DEBUG instead of printing a traceback."""
    server = served[1]
    try:
        raise BrokenPipeError(32, "Broken pipe")
    except BrokenPipeError:
        server.handle_error(None, ("127.0.0.1", 1))
    assert capsys.readouterr().err == ""
    try:
        raise RuntimeError("a fault of the server's own")
    except RuntimeError:
        server.handle_error(None, ("127.0.0.1", 1))
    assert "RuntimeError: a fault of the server's own" in capsys.readouterr().err
