"""The port's tensor wire format against the JAX package's, on the CPU.

- The codec (``utils/wire.py``): ``pack_frames`` writes the JAX module's
  bytes for every allowed dtype (big-endian, 0-d, empty, non-contiguous,
  64 frames), ``unpack_frames`` reads JAX bodies into equal arrays, and
  each malformed body (the cases of ``tests/test_wire.py::TestFrameCodec``
  and a few more) raises ``WireFormatError`` with the JAX message. The
  request and answer codecs of ``server/model_io.py`` and
  ``qos/classify.classify_meta`` against theirs.
- The server: a JAX collection (a dense detector and an LSTM detector,
  banked; a detector over PCA and a bare ``AutoEncoder``, per model) is
  served by the JAX server (aiohttp test client) and, carried across by
  ``tools/jax_artifact_to_torch.py``, by the port. Both get one sequence of
  tensor POSTs: the same statuses and error texts (malformed, unknown,
  non-anomaly, quarantined, a ``__meta__`` tenant over its bucket), the
  answers' ``__meta__`` frames byte-equal and their arrays within the
  families' bands (dense atol 1e-5 as ``tests/test_torch_server.py``, LSTM
  rtol 1e-5 / atol 1e-6), ``/models``' ``accepts`` and ``/stats``'
  ``wire`` equal.
- Inside the port, bitwise: each tensor answer is the float32 of the JSON
  answer's values for the same rows; a traced tensor POST has its
  ``parse`` span with ``encoding="tensor"`` and its bank ``postprocess``
  span with ``stage="to_wire"``.
"""

import asyncio
import importlib.util
import json
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
from aiohttp.test_utils import TestClient, TestServer
from sklearn.decomposition import PCA
from sklearn.pipeline import Pipeline

from gordo_components_torch.qos import classify as port_classify
from gordo_components_torch.server import model_io as port_io
from gordo_components_torch.server import run_server
from gordo_components_torch.utils import wire as port_wire
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector, LSTMAutoEncoder
from gordo_components_tpu.qos import classify as jax_classify
from gordo_components_tpu.server import build_app as jax_build_app
from gordo_components_tpu.server import model_io as jax_io
from gordo_components_tpu.utils import wire as jax_wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch", os.path.join(REPO, "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

TENSOR = {"Content-Type": port_wire.TENSOR_CONTENT_TYPE}
JSON = {"Content-Type": "application/json"}
TAGS = ["tag-0", "tag-1", "tag-2"]
P = "/gordo/v0/proj"
RNG = np.random.RandomState(5)
X = RNG.rand(20, 3).astype("float32")
Y = RNG.rand(20, 3).astype("float32")


# --------------------------------------------------------------------------- #
# the codec
# --------------------------------------------------------------------------- #

def _arrays():
    rng = np.random.RandomState(0)
    base = (rng.rand(4, 6) * 100).astype("<f8")
    out = {f"{dt}-{shape}": (rng.rand(*shape) * 100).astype(np.dtype(dt))
           for dt in ("<f4", "<f8", "<i4", "<i8", "|u1", "|b1", "<u2", "<i2", ">f4", ">f8", ">i4", "|i1")
           for shape in ((3, 4), (0, 5), (7,), (2, 3, 2))}
    out["0-d"] = np.float32(2.5) * np.ones((), np.float32)
    out["0-d-int"] = np.array(7, dtype="<i8")
    out["non-contiguous"] = base[:, ::2]
    out["transposed"] = base.astype("<f4").T
    out["8-d"] = np.arange(2 ** 8, dtype="<f4").reshape((2,) * 8)
    return out


ARRAYS = _arrays()


@pytest.mark.parametrize("key", sorted(ARRAYS))
def test_pack_frames_writes_the_jax_bytes(key):
    frames = [("a", ARRAYS[key])]
    body = port_wire.pack_frames(frames)
    assert body == jax_wire.pack_frames(frames)
    got = port_wire.unpack_frames(jax_wire.pack_frames(frames))["a"]
    want = np.ascontiguousarray(ARRAYS[key])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_64_frames_and_their_order():
    frames = [(f"f{i:02d}", np.full((i % 5, 2), i, dtype="<f4" if i % 2 else "<i8")) for i in range(64)]
    frames[0] = ("__meta__", np.frombuffer(b'{"tenant": "a"}', np.uint8))
    body = port_wire.pack_frames(frames)
    assert body == jax_wire.pack_frames(frames)
    out = port_wire.unpack_frames(body)
    assert list(out) == [name for name, _ in frames]
    for name, arr in frames:
        np.testing.assert_array_equal(out[name], arr)
        assert not out[name].flags.writeable  # views of the body


def test_rows_as_f32_matches_jax():
    native = port_wire.unpack_frames(port_wire.pack_frames([("X", X)]))["X"]
    assert port_wire.rows_as_f32(native) is native  # the frombuffer view itself
    for arr in (X.astype(">f4"), X.astype("<f8"), (X * 10).astype("<i4"), X[:, 0]):
        got, want = port_wire.rows_as_f32(arr), jax_wire.rows_as_f32(arr)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert port_wire.encoding_of("application/x-gordo-tensor; v=1") == "tensor"
    for ct in (None, "", "application/json", "application/x-parquet", port_wire.TENSOR_CONTENT_TYPE):
        assert port_wire.encoding_of(ct) == jax_wire.encoding_of(ct)
    assert (port_wire.WIRE_MAGIC, port_wire.WIRE_VERSION, port_wire.ANOMALY_FRAME_NAMES) == (
        jax_wire.WIRE_MAGIC, jax_wire.WIRE_VERSION, jax_wire.ANOMALY_FRAME_NAMES)


def _good(n=20):
    return jax_wire.pack_frames([("X", X[:n])])


def _lie():
    body = bytearray(_good(4))
    off = len(body) - X[:4].nbytes - 8
    body[off:off + 8] = (X[:4].nbytes - 4).to_bytes(8, "little")
    return bytes(body)


def _retype(old: bytes, new: bytes):
    body = bytearray(_good(2))
    i = body.index(old)
    body[i:i + len(old)] = new
    return bytes(body)


def _frames_byte(n):
    body = bytearray(_good(2))
    body[5] = n
    return bytes(body)


def _ndim9():
    body = bytearray(_good(2))
    body[body.index(b"<f4") + 3] = 9
    return bytes(body)


def _bad_name():
    body = bytearray(_good(2))
    body[7] = 0xFF  # the name "X"
    return bytes(body)


# each case: a function of the wire module that must raise
MALFORMED = {
    "bad-magic": lambda w: w.unpack_frames(b"NOPE" + _good()[4:]),
    "unknown-version": lambda w: w.unpack_frames(_good()[:4] + b"\x09" + _good()[5:]),
    "truncated-payload": lambda w: w.unpack_frames(_good()[:-5]),
    "truncated-header": lambda w: w.unpack_frames(jax_wire.WIRE_MAGIC + b"\x01"),
    "truncated-shape": lambda w: w.unpack_frames(_good()[:14]),
    "trailing-bytes": lambda w: w.unpack_frames(_good() + b"\x00\x00"),
    "payload-size-lie": lambda w: w.unpack_frames(_lie()),
    "disallowed-dtype": lambda w: w.unpack_frames(_retype(b"<f4", b"<m8")),
    "object-dtype": lambda w: w.unpack_frames(_retype(b"<f4", b"|O8")),
    "wide-dtype": lambda w: w.unpack_frames(_retype(b"<f4", b"<c8")),
    "undecodable-dtype": lambda w: w.unpack_frames(_retype(b"<f4", b"zz9")),
    "zero-frames": lambda w: w.unpack_frames(_frames_byte(0)),
    "65-frames": lambda w: w.unpack_frames(_frames_byte(65)),
    "9-dims": lambda w: w.unpack_frames(_ndim9()),
    "name-not-utf8": lambda w: w.unpack_frames(_bad_name()),
    "pack-empty": lambda w: w.pack_frames([]),
    "pack-empty-name": lambda w: w.pack_frames([("", X)]),
    "pack-long-name": lambda w: w.pack_frames([("n" * 256, X)]),
    "pack-65-frames": lambda w: w.pack_frames([(f"f{i}", X) for i in range(65)]),
    "pack-9-dims": lambda w: w.pack_frames([("X", np.zeros((1,) * 9, np.float32))]),
    "pack-object": lambda w: w.pack_frames([("X", np.array(["a"], dtype=object))]),
    "pack-complex": lambda w: w.pack_frames([("X", np.zeros(2, np.complex128))]),
    "rows-3d": lambda w: w.rows_as_f32(np.ones((2, 2, 2), np.float32)),
}


def _raised(fn, module):
    try:
        fn(module)
    except Exception as exc:  # the type and message are what is compared
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_bodies_raise_the_jax_message(case):
    got, want = _raised(MALFORMED[case], port_wire), _raised(MALFORMED[case], jax_wire)
    assert want is not None and want[0] == "WireFormatError"
    assert got == want


META_TABLE = [
    (None, None), ({}, None), ({"tenant": "acme"}, None), ({"priority": "bulk"}, None),
    ({"tenant": "acme", "priority": "best-effort"}, None), ({"priority": "nonsense"}, "batch"),
    ({"tenant": "  a|b  "}, None), ({"tenant": ""}, None), ({"tenant": 7, "priority": 3}, None),
    ({"tenant": "x" * 100}, None), ({"offset": 3}, "best_effort"), ({"tenant": "default"}, "batch"),
    ({"priority": "ONLINE"}, "batch"),
]


@pytest.mark.parametrize("meta, base_class", META_TABLE)
def test_classify_meta_matches_jax(meta, base_class):
    port_base = jax_base = None
    if base_class is not None:
        port_base = port_classify.RequestClass("hdr", base_class)
        jax_base = jax_classify.RequestClass("hdr", base_class)
    got = port_classify.classify_meta(meta, port_base)
    want = jax_classify.classify_meta(meta, jax_base)
    assert (got.tenant, got.qos_class) == (want.tenant, want.qos_class)
    assert (got is port_base) == (want is jax_base)


def _meta_bytes(doc) -> np.ndarray:
    return np.frombuffer(doc if isinstance(doc, bytes) else json.dumps(doc).encode(), np.uint8)


REQUESTS = {
    "X": [("X", X)],
    "X-y": [("X", X), ("y", Y)],
    "X-f8-be": [("X", X.astype(">f8"))],
    "X-1d": [("X", X[:, 0])],
    "meta": [("__meta__", _meta_bytes({"tenant": "acme", "priority": "batch"})), ("X", X)],
    "meta-list": [("__meta__", _meta_bytes([1, 2])), ("X", X)],
    "meta-not-json": [("__meta__", _meta_bytes(b"{nope")), ("X", X)],
    "no-X": [("Z", X)],
    "y-rows": [("X", X), ("y", Y[:5])],
    "X-3d": [("X", np.ones((2, 2, 2), np.float32))],
}


@pytest.mark.parametrize("key", sorted(REQUESTS))
def test_decode_tensor_request_matches_jax(key):
    body = port_wire.pack_frames(REQUESTS[key])
    try:
        got = port_io.decode_tensor_request_ex(body)
    except port_wire.WireFormatError as exc:
        got = str(exc)
    try:
        want = jax_io.decode_tensor_request_ex(body)
    except jax_wire.WireFormatError as exc:
        want = str(exc)
    if isinstance(want, str):
        assert got == want
        return
    for g, w in zip(got[:2], want[:2]):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and g.flags.c_contiguous
            np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    X_port, _ = port_io.decode_tensor_request(body)
    np.testing.assert_array_equal(X_port, got[0])


def test_answer_encoders_write_the_jax_bytes():
    arrays = {name: np.random.RandomState(i).rand(13, 3).astype("f4") for i, name in
              enumerate(port_wire.ANOMALY_FRAME_NAMES[:4])}
    arrays.update({name: np.random.RandomState(9).rand(13).astype("f4")
                   for name in port_wire.ANOMALY_FRAME_NAMES[4:]})
    assert port_io.encode_anomaly_response(TAGS, arrays, 7) == jax_io.encode_anomaly_response(TAGS, arrays, 7)
    out = arrays["model-output"]
    assert port_io.encode_prediction_response(out, 20) == jax_io.encode_prediction_response(out, 20)


# --------------------------------------------------------------------------- #
# the server against the JAX server
# --------------------------------------------------------------------------- #

TENANTS = {"GORDO_QOS_TENANTS": json.dumps({"meta-t": {"rate": 0.001, "burst": 1}}), "GORDO_TRACE_SAMPLE": "1",
           "GORDO_SLO_SAMPLE_S": "3600"}


def _tensor(frames):
    return "POST", port_wire.pack_frames(frames), TENSOR


def _meta(tenant):
    return ("__meta__", _meta_bytes({"tenant": tenant}))


GOOD = port_wire.pack_frames([("X", X)])
# (key, method, path, body bytes or None, headers); both servers get them in order
STEPS = [
    ("dense_anomaly", f"{P}/wire-dense/anomaly/prediction", *_tensor([("X", X)])),
    ("dense_anomaly_y", f"{P}/wire-dense/anomaly/prediction", *_tensor([("X", X), ("y", Y)])),
    ("dense_anomaly_f8", f"{P}/wire-dense/anomaly/prediction", *_tensor([("X", X.astype(">f8"))])),
    ("dense_prediction", f"{P}/wire-dense/prediction", *_tensor([("X", X)])),
    ("lstm_anomaly", f"{P}/wire-lstm/anomaly/prediction", *_tensor([("X", X)])),
    ("lstm_prediction", f"{P}/wire-lstm/prediction", *_tensor([("X", X)])),
    ("pca_anomaly", f"{P}/wire-pca/anomaly/prediction", *_tensor([("X", X)])),
    ("pca_prediction", f"{P}/wire-pca/prediction", *_tensor([("X", X)])),
    ("bare_prediction", f"{P}/wire-bare/prediction", *_tensor([("X", X)])),
    ("bare_anomaly_422", f"{P}/wire-bare/anomaly/prediction", *_tensor([("X", X)])),
    ("ghost_404", f"{P}/ghost/anomaly/prediction", *_tensor([("X", X)])),
    ("bad_magic", f"{P}/wire-dense/anomaly/prediction", "POST", b"NOPE" + GOOD[4:], TENSOR),
    ("truncated", f"{P}/wire-dense/anomaly/prediction", "POST", GOOD[:-5], TENSOR),
    ("trailing", f"{P}/wire-dense/prediction", "POST", GOOD + b"\x00", TENSOR),
    ("no_x", f"{P}/wire-dense/anomaly/prediction", *_tensor([("Z", X)])),
    ("y_rows", f"{P}/wire-lstm/anomaly/prediction", *_tensor([("X", X), ("y", Y[:3])])),
    ("x_3d", f"{P}/wire-pca/anomaly/prediction", *_tensor([("X", np.ones((2, 2, 2), np.float32))])),
    ("wrong_width", f"{P}/wire-dense/anomaly/prediction", *_tensor([("X", X[:, :2])])),
    ("meta_tenant_1", f"{P}/wire-dense/anomaly/prediction", *_tensor([_meta("meta-t"), ("X", X)])),
    ("meta_tenant_2", f"{P}/wire-dense/anomaly/prediction", *_tensor([_meta("meta-t"), ("X", X)])),
    ("meta_overrides_header", f"{P}/wire-dense/prediction", "POST",
     port_wire.pack_frames([_meta("meta-t"), ("X", X)]), {**TENSOR, "X-Gordo-Tenant": "someone"}),
    ("meta_malformed", f"{P}/wire-dense/prediction", *_tensor([("__meta__", _meta_bytes(b"[1")), ("X", X)])),
    ("quarantined_410", f"{P}/wire-lstm/anomaly/prediction", *_tensor([("X", X)])),
    ("models", f"{P}/models", "GET", None, {}),
    ("stats", f"{P}/stats", "GET", None, {}),
]
QUARANTINE_BEFORE = "quarantined_410"
OK = {"dense_anomaly", "dense_anomaly_y", "dense_anomaly_f8", "dense_prediction", "lstm_anomaly",
      "lstm_prediction", "pca_anomaly", "pca_prediction", "bare_prediction", "meta_tenant_1", "meta_malformed"}


def _poison(quarantine):
    for _ in range(quarantine.threshold):
        quarantine.record_failure("wire-lstm", "poisoned by the test")


async def _jax_answers(root):
    client = TestClient(TestServer(jax_build_app(root)))
    await client.start_server()
    try:
        out = {}
        for key, path, method, raw, headers in STEPS:
            if key == QUARANTINE_BEFORE:
                _poison(client.server.app["quarantine"])
            resp = await client.request(method, path, data=raw, headers=headers)
            out[key] = resp.status, resp.content_type, await resp.read()
        return out
    finally:
        await client.close()


def call(base, method, path, raw=None, headers=None):
    """(status, content type, body bytes) of one request."""
    req = urllib.request.Request(base + path, data=raw, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get_content_type(), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get_content_type(), exc.read()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root) of the collection, written once."""
    rng = np.random.RandomState(0)
    Xv = pd.DataFrame(rng.rand(200, 3).astype("float32"), columns=TAGS)
    jax_root, port_root = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    models = {
        "wire-dense": DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64)),
        "wire-lstm": DiffBasedAnomalyDetector(base_estimator=LSTMAutoEncoder(
            kind="lstm_model", dims=(4,), lookback_window=8, epochs=1, batch_size=64)),
        "wire-pca": DiffBasedAnomalyDetector(base_estimator=Pipeline(
            [("pca", PCA(n_components=3)), ("model", AutoEncoder(epochs=1, batch_size=64))])),
        "wire-bare": AutoEncoder(epochs=1, batch_size=64),
    }
    for name, model in models.items():
        model.fit(Xv if name != "wire-bare" else Xv.to_numpy())
        jax_serializer.dump(model, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    return str(jax_root), str(port_root)


@pytest.fixture(scope="module")
def served(roots):
    jax_root, port_root = roots
    env = {k: os.environ.get(k) for k in TENANTS}
    os.environ.update(TENANTS)
    try:
        jax = asyncio.run(_jax_answers(jax_root))
        server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    finally:
        for k, v in env.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    try:
        port = {}
        for key, path, method, raw, headers in STEPS:
            if key == QUARANTINE_BEFORE:
                _poison(server.app.quarantine)
            port[key] = call(server.url, method, path, raw, headers)
        server.app.quarantine.clear()
        yield server, jax, port
    finally:
        server.close()


def _retry_free(text: str) -> str:
    return re.sub(r"~[0-9.]+s", "~Ns", text)


def test_the_sequence_answers_the_same_statuses_and_errors(served):
    _, jax, port = served
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in jax.items()}
    assert {k for k, v in port.items() if v[0] == 200} == OK | {"models", "stats"}
    for key, (status, ctype, body) in port.items():
        if status == 200:
            continue
        assert ctype == jax[key][1] == "application/json", key
        got, want = json.loads(body), json.loads(jax[key][2])
        # a refusal's text names its retry time, which moves with the clock
        assert _retry_free(got["error"]) == _retry_free(want["error"]), key
        if status == 410:
            assert got["reason"] == want["reason"] == "poisoned by the test"
        if status == 429:
            assert got["reason"] == want["reason"] == "tenant_rate" and got["tenant"] == "meta-t"
    assert json.loads(port["bad_magic"][2])["error"].startswith("tensor body: bad magic")


@pytest.mark.parametrize("key", sorted(OK))
def test_tensor_answers_match_jax(served, key):
    _, jax, port = served
    assert port[key][1] == jax[key][1] == port_wire.TENSOR_CONTENT_TYPE
    got, want = port_wire.unpack_frames(port[key][2]), jax_wire.unpack_frames(jax[key][2])
    assert list(got) == list(want)
    assert got["__meta__"].tobytes() == want["__meta__"].tobytes()
    lstm = key.startswith("lstm")
    for name in list(want)[1:]:
        assert got[name].dtype == want[name].dtype == np.float32 and got[name].shape == want[name].shape
        rtol, atol = (1e-5, 1e-6) if lstm else (0, 1e-5)
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=f"{key} {name}")


def test_models_and_wire_stats_match_jax(served):
    _, jax, port = served
    got, want = json.loads(port["models"][2]), json.loads(jax["models"][2])
    assert got["accepts"] == want["accepts"] == [
        "application/json", port_wire.TENSOR_CONTENT_TYPE, "application/x-parquet"]
    assert "transports" not in got and "transports" not in want
    got, want = json.loads(port["stats"][2]), json.loads(jax["stats"][2])
    assert got["wire"] == want["wire"]
    assert got["wire"]["requests"] == {"tensor": sum(1 for _, _, m, _, _ in STEPS if m == "POST")}
    assert got["workers"] == want["workers"] == {} and "shm" not in got and "transports" not in got


# --------------------------------------------------------------------------- #
# inside the port: bitwise against its own JSON answers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("target, endpoint", [("wire-dense", "anomaly/prediction"), ("wire-dense", "prediction"),
                                              ("wire-lstm", "anomaly/prediction"), ("wire-lstm", "prediction"),
                                              ("wire-pca", "anomaly/prediction"), ("wire-bare", "prediction")])
def test_tensor_answer_is_the_json_answers_float32(served, target, endpoint):
    server = served[0]
    path = f"{P}/{target}/{endpoint}"
    for frames, body in (([("X", X)], {"X": X.tolist()}), ([("X", X), ("y", Y)], {"X": X.tolist(), "y": Y.tolist()})):
        status, _, raw = call(server.url, "POST", path, json.dumps(body).encode(), JSON)
        assert status == 200
        answer = json.loads(raw)
        status, ctype, raw = call(server.url, "POST", path, port_wire.pack_frames(frames), TENSOR)
        assert status == 200 and ctype == port_wire.TENSOR_CONTENT_TYPE
        frames = port_wire.unpack_frames(raw)
        meta = json.loads(frames.pop("__meta__").tobytes())
        if endpoint == "prediction":
            assert list(frames) == ["data"]
            np.testing.assert_array_equal(np.asarray(answer["data"]), frames["data"].astype(np.float64))
            assert meta == {"offset": len(X) - len(frames["data"])}
            continue
        assert list(frames) == list(port_wire.ANOMALY_FRAME_NAMES)
        assert meta["tags"] == TAGS and meta["offset"] == len(X) - len(frames["model-output"])
        data = answer["data"]
        for name in port_wire.ANOMALY_FRAME_NAMES:
            if name.startswith("total"):
                np.testing.assert_array_equal(np.asarray(data[name]), frames[name].astype(np.float64))
                continue
            cols = list(data[name])
            assert len(cols) == frames[name].shape[1]
            for i, col in enumerate(cols):
                np.testing.assert_array_equal(np.asarray(data[name][col]), frames[name][:, i].astype(np.float64))


def test_tensor_spans_and_counters(served):
    server = served[0]
    tid = "ab" * 16
    status, _, _ = call(server.url, "POST", f"{P}/wire-dense/anomaly/prediction", GOOD,
                        {**TENSOR, "traceparent": f"00-{tid}-{'cd' * 8}-01"})
    assert status == 200
    (trace,) = server.app.tracer.find(tid)
    spans = {s.name: s.attributes for s in trace.spans}
    assert spans["parse"]["encoding"] == "tensor"
    assert spans["postprocess"]["stage"] == "to_wire"
    text = call(server.url, "GET", f"{P}/metrics")[2].decode()
    with server.app.stats_lock:
        n, nbytes = server.app.stats["wire"]["requests"]["tensor"], server.app.stats["wire"]["bytes"]["tensor"]
    assert f'gordo_server_requests_total{{encoding="tensor"}} {n}' in text
    assert f'gordo_server_request_bytes_total{{encoding="tensor"}} {nbytes}' in text
    assert "gordo_server_worker_requests_total" not in text and "gordo_shm_" not in text
