"""The port's serving mesh against the JAX package's, on the CPU (after
tests/test_mesh.py).

- **Units.** The identity from ``GORDO_MESH_REPLICA_ID`` /
  ``GORDO_MESH_REPLICAS`` resolves (and fails) as JAX's, and
  ``GORDO_MESH_DISTRIBUTED=1`` raises naming ROADMAP.md A12b; the partition
  and the member slice equal JAX's and are disjoint and exhaustive; an
  owned collection filters, acquires and releases; an artifact packed by
  either package unpacks in the other to the same tree, and an archive that
  escapes (``..``, an absolute path, a link, a device) is refused by both;
  ``plan_fleet`` equals JAX's on the same ownership, loads and health.
- **Routes, both servers.** Replica 0 of two over one converted collection:
  ``/mesh``, ``.../mesh/member/<t>/artifact``, an acquire (a bad body, a
  member name that is a path, a member already owned, one not on disk), a
  release (an unknown member: 404 with the reason) answer with JAX's
  status codes and bodies (swap times masked).
- **The mesh, on the port.** Two port replicas and the port's watchman:
  dual ownership answers bitwise on both replicas; ``POST /migrate`` moves a
  member while a client follows the routing table and POSTs (refetching the
  table once on a 404, as the bulk client does): no answer but 200, the
  version steps, ``gordo_fleet_migrations_total`` counts it;
  ``/migrate``'s validation and conflicts; an acquire with ``source``
  ships the artifact into a replica over its own root; ``/fleet-rebalance``
  dry run equals the JAX watchman's over the same replicas, and a forced
  one moves a member; a dark replica steps the version and emits the mesh
  events.
"""

import asyncio
import importlib.util
import io
import json
import os
import shutil
import tarfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from gordo_components_torch import resilience as port_resilience
from gordo_components_torch.parallel import distributed as port_dist
from gordo_components_torch.placement import planner as port_planner
from gordo_components_torch.server import run_server
from gordo_components_torch.server import model_io as port_io
from gordo_components_torch.utils.wire import TENSOR_CONTENT_TYPE, pack_frames
from gordo_components_torch.watchman import run_watchman
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.parallel import distributed as jax_dist
from gordo_components_tpu.placement import planner as jax_planner
from gordo_components_tpu.server import build_app as jax_build_app
from gordo_components_tpu.server import model_io as jax_io
from gordo_components_tpu.watchman.server import build_watchman_app as jax_watchman_app

_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

N_FEATURES = 4
MEMBERS = ["mesh-0", "mesh-1", "mesh-2", "mesh-3"]
P = "/gordo/v0/proj"
ENV = {"GORDO_SERVER_WARMUP": "0"}


@pytest.fixture(autouse=True)
def _clean_faults():
    port_resilience.reset()
    yield
    port_resilience.reset()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Four detectors in one shared directory (the mesh's shared-volume
    deploy), as JAX artifacts and as the port's conversion."""
    X = np.random.RandomState(0).rand(96, N_FEATURES).astype("float32")
    jax_root, port_root = tmp_path_factory.mktemp("jax-mesh"), tmp_path_factory.mktemp("port-mesh")
    for i, name in enumerate(MEMBERS):
        det = DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64))
        det.fit(X + 0.01 * i)
        jax_serializer.dump(det, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    return str(jax_root), str(port_root)


# ------------------------------------------------------------------ #
# units
# ------------------------------------------------------------------ #


IDENTITY_ENVS = {
    "unset": {}, "both": {"GORDO_MESH_REPLICA_ID": "1", "GORDO_MESH_REPLICAS": "3"},
    "id_only": {"GORDO_MESH_REPLICA_ID": "1"}, "count_only": {"GORDO_MESH_REPLICAS": "2"},
    "out_of_range": {"GORDO_MESH_REPLICA_ID": "2", "GORDO_MESH_REPLICAS": "2"},
    "not_int": {"GORDO_MESH_REPLICA_ID": "nope", "GORDO_MESH_REPLICAS": "2"},
    "zero_replicas": {"GORDO_MESH_REPLICA_ID": "0", "GORDO_MESH_REPLICAS": "0"},
    "coordinator": {"GORDO_MESH_REPLICA_ID": "0", "GORDO_MESH_REPLICAS": "1", "GORDO_MESH_COORDINATOR": "h:1"},
}


def _resolve(mod):
    try:
        ident = mod.serving_mesh_identity()
    except ValueError as exc:
        return "ValueError", str(exc)
    if ident is None:
        return None
    return ident.replica_id, ident.replica_count, ident.coordinator, ident.distributed


@pytest.mark.parametrize("case", sorted(IDENTITY_ENVS))
def test_mesh_identity_resolves_from_the_environment_as_jax(case, monkeypatch):
    for k in ("GORDO_MESH_REPLICA_ID", "GORDO_MESH_REPLICAS", "GORDO_MESH_COORDINATOR", "GORDO_MESH_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in IDENTITY_ENVS[case].items():
        monkeypatch.setenv(k, v)
    assert _resolve(port_dist) == _resolve(jax_dist)
    if case == "unset":
        assert port_dist.bootstrap_serving_mesh() is None
    if case == "both":
        assert port_dist.bootstrap_serving_mesh() == port_dist.MeshIdentity(1, 3)
        monkeypatch.setenv("GORDO_MESH_DISTRIBUTED", "1")
        with pytest.raises(NotImplementedError, match="A12b"):
            port_dist.bootstrap_serving_mesh()


@pytest.mark.parametrize("n", [0, 1, 4, 11, 24])
def test_partition_equals_jax_and_is_disjoint_and_exhaustive(n):
    names = [f"x-{i:02d}" for i in range(n)][::-1]
    for count in (1, 2, 3, 5):
        parts = [port_dist.MeshIdentity(i, count).partition(names) for i in range(count)]
        assert parts == [jax_dist.MeshIdentity(i, count).partition(names) for i in range(count)]
        assert parts == [jax_dist.partition_members(names, i, count) for i in range(count)]
        assert [port_dist.process_member_slice(n, i, count) for i in range(count)] == [
            jax_dist.process_member_slice(n, i, count) for i in range(count)]
        flat = [m for p in parts for m in p]
        assert sorted(flat) == sorted(names) and len(set(flat)) == n
    with pytest.raises(ValueError):
        port_dist.process_member_slice(n, 3, 3)


def test_collection_owned_filter_and_acquire_release(roots):
    _jax_root, port_root = roots
    col = port_io.ModelCollection(port_root, device="cpu", owned=MEMBERS[:2])
    assert col.names() == MEMBERS[:2]
    col.acquire(MEMBERS[2])
    assert MEMBERS[2] in col.models
    col.release(MEMBERS[2])
    assert MEMBERS[2] not in col.models and MEMBERS[2] in port_io.scan_artifacts(port_root)
    with pytest.raises(KeyError):
        col.release("never-owned")
    with pytest.raises(FileNotFoundError):
        col.acquire("no-such-artifact")
    assert "no-such-artifact" not in col.owned
    assert port_io.ModelCollection(port_root, device="cpu", owned=[]).names() == []
    unowned = port_io.ModelCollection(port_root, device="cpu")
    unowned.release(MEMBERS[0])  # an unowned collection first owns what it serves
    assert unowned.names() == MEMBERS[1:] and unowned.owned == set(MEMBERS[1:])


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_artifacts_ship_between_the_packages(roots, tmp_path):
    """A tar packed by either package unpacks in the other to the same tree
    (the trees compare, not the tar bytes)."""
    jax_root, port_root = roots
    for src, pack, unpack in ((os.path.join(port_root, MEMBERS[0]), port_io.pack_artifact_dir, jax_io.unpack_artifact_dir),
                              (os.path.join(port_root, MEMBERS[0]), jax_io.pack_artifact_dir, port_io.unpack_artifact_dir),
                              (os.path.join(jax_root, MEMBERS[1]), port_io.pack_artifact_dir, port_io.unpack_artifact_dir)):
        dest = tmp_path / f"landed-{len(os.listdir(tmp_path))}"
        unpack(pack(src), str(dest))
        assert _tree(dest) == _tree(src)


def _evil(kind):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        if kind in ("dotdot", "absolute", "nested_dotdot"):
            info = tarfile.TarInfo({"dotdot": "../evil.txt", "absolute": "/tmp/evil.txt",
                                    "nested_dotdot": "a/../../evil.txt"}[kind])
            info.size = 4
            tar.addfile(info, io.BytesIO(b"boom"))
        elif kind == "symlink":
            info = tarfile.TarInfo("link")
            info.type, info.linkname = tarfile.SYMTYPE, "/etc/passwd"
            tar.addfile(info)
        elif kind == "device":
            info = tarfile.TarInfo("dev")
            info.type = tarfile.CHRTYPE
            tar.addfile(info)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["dotdot", "absolute", "nested_dotdot", "symlink", "device"])
def test_the_traversal_guard_refuses_what_jax_refuses(kind, tmp_path):
    raw = _evil(kind)
    for unpack in (jax_io.unpack_artifact_dir, port_io.unpack_artifact_dir):
        with pytest.raises(ValueError, match="unsafe"):
            unpack(raw, str(tmp_path / "guarded"))
    assert os.listdir(tmp_path / "guarded") == []


MBR = {0: ["a", "b", "c"], 1: ["d", "e", "f"]}
LOADS = {"a": 4000, "b": 4000, "c": 200, "d": 200, "e": 200, "f": 200}
FLEET_CASES = {
    "hot_replica": (MBR, LOADS, dict(threshold=1.2, min_rows=100)),
    "degraded": (MBR, LOADS, dict(replica_health={1: "degraded"}, threshold=1.2, min_rows=100)),
    "burning": (MBR, LOADS, dict(replica_health={1: "burning"}, threshold=1.2, min_rows=100)),
    "unreachable": (MBR, LOADS, dict(replica_health={1: "unreachable"}, threshold=1.2, min_rows=100)),
    "floor": (MBR, LOADS, dict(threshold=1.2, min_rows=10**9)),
    "one_replica": ({0: ["a"]}, {"a": 5}, {}),
    "empty": ({}, {}, {}),
    "three_replicas_dual_owned": ({0: ["a", "b", "x"], 1: ["c", "x"], 2: ["d"]},
                                  {"a": 900, "b": 700, "c": 50, "d": 10, "x": 300}, dict(max_moves=2, min_rows=0)),
    "below_threshold": (MBR, {"a": 210, "b": 200, "c": 200, "d": 200, "e": 200, "f": 200},
                        dict(threshold=1.2, min_rows=0)),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_plan_fleet_equals_jax(case):
    mbr, loads, kwargs = FLEET_CASES[case]
    port = port_planner.plan_fleet(mbr, loads, **kwargs)
    jax = jax_planner.plan_fleet(mbr, loads, **kwargs)
    assert port.summary() == jax.summary()
    assert port_planner.plan_fleet(mbr, loads, **kwargs).summary() == port.summary()
    if case == "hot_replica":
        assert port.should_apply and port.moves[0].src == 0 and port.skew_after < port.skew_before
    if case in ("degraded", "burning", "unreachable"):
        assert not any(m.dst == 1 for m in port.moves) and port.eligible == [0]


# ------------------------------------------------------------------ #
# the routes, both servers
# ------------------------------------------------------------------ #


def _with_env(values, fn):
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        return fn()
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _replica_env(i, count):
    return {**ENV, "GORDO_MESH_REPLICA_ID": str(i), "GORDO_MESH_REPLICAS": str(count)}


def _call(url, method="GET", body=None, headers=None):
    """(status, JSON body or bytes) of one request, any status."""
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json",
                                                                         **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw, ctype = resp.read(), resp.headers["Content-Type"]
            return resp.status, json.loads(raw) if ctype == "application/json" else raw
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


ROUTE_STEPS = [
    ("view", "GET", "/mesh", None), ("artifact_unowned", "GET", f"/mesh/member/{MEMBERS[3]}/artifact", None),
    ("artifact_unknown", "GET", "/mesh/member/ghost/artifact", None),
    ("acquire_not_json", "POST", "/mesh/acquire", b"nope"), ("acquire_int", "POST", "/mesh/acquire", {"member": 3}),
    ("acquire_dotdot", "POST", "/mesh/acquire", {"member": "../evil", "source": "http://127.0.0.1:1"}),
    ("acquire_slash", "POST", "/mesh/acquire", {"member": "a/b"}), ("acquire_empty", "POST", "/mesh/acquire",
                                                                     {"member": ""}),
    ("acquire_bad_source", "POST", "/mesh/acquire", {"member": "ghost", "source": 5}),
    ("acquire_owned", "POST", "/mesh/acquire", {"member": MEMBERS[0]}),
    ("acquire_missing", "POST", "/mesh/acquire", {"member": "ghost"}),
    ("release_unknown", "POST", "/mesh/release", {"member": "ghost"}),
    ("acquire", "POST", "/mesh/acquire", {"member": MEMBERS[3]}),
    ("release", "POST", "/mesh/release", {"member": MEMBERS[1]}), ("view_after", "GET", "/mesh", None),
]


def _mask(body):
    if isinstance(body, dict):
        return {k: ("<t>" if k == "pause_ms" else _mask(v)) for k, v in body.items() if k != "request_id"}
    return body


async def _jax_mesh_answers(root):
    app = _with_env(_replica_env(0, 2), lambda: jax_build_app(root, devices=1))
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        out = {}
        for key, method, path, body in ROUTE_STEPS:
            data = body if isinstance(body, (bytes, type(None))) else json.dumps(body)
            resp = await client.request(method, P + path, data=data, headers={"Content-Type": "application/json"})
            raw = await resp.read()
            out[key] = resp.status, json.loads(raw) if resp.content_type == "application/json" else raw
        return out
    finally:
        await client.close()


def test_mesh_routes_answer_as_jax(roots, tmp_path):
    jax_root, port_root = roots
    jax_copy, port_copy = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(jax_root, jax_copy)
    shutil.copytree(port_root, port_copy)
    jax = asyncio.run(_jax_mesh_answers(str(jax_copy)))
    server = _with_env(_replica_env(0, 2), lambda: run_server(str(port_copy), host="127.0.0.1", port=0,
                                                              device="cpu", background=True))
    try:
        port = {key: _call(server.url + P + path, method, body) for key, method, path, body in ROUTE_STEPS}
    finally:
        server.close()
    for key, _m, _p, _b in ROUTE_STEPS:
        assert port[key][0] == jax[key][0], (key, port[key], jax[key])
        if key == "acquire_missing":  # the roots are each package's own
            assert port[key][1]["hint"] == jax[key][1]["hint"]
            assert port[key][1]["error"].split(" under ")[0] == jax[key][1]["error"].split(" under ")[0]
        else:
            assert _mask(port[key][1]) == _mask(jax[key][1]), key
    assert port["view"][1]["owned"] == MEMBERS[:2] and port["view_after"][1]["owned"] == [MEMBERS[0], MEMBERS[3]]
    assert port["release_unknown"] == (404, {"error": "cannot release unknown member 'ghost'"})


# ------------------------------------------------------------------ #
# the mesh on the port
# ------------------------------------------------------------------ #


class Mesh:
    """Port replicas over one directory and the port's watchman."""

    def __init__(self, root, count=2, refresh_interval=0.1):
        self.servers = [_with_env(_replica_env(i, count), lambda: run_server(
            root, host="127.0.0.1", port=0, device="cpu", background=True)) for i in range(count)]
        self.urls = [s.url for s in self.servers]
        self.wm = run_watchman("proj", self.urls[0], metrics_urls=[u + P + "/metrics" for u in self.urls],
                               host="127.0.0.1", port=0, refresh_interval=refresh_interval, background=True)

    def close(self):
        self.wm.close()
        for s in self.servers:
            s.close()

    def routing(self, refresh=False):
        return _call(self.wm.url + "/routing" + ("?refresh=1" if refresh else ""))[1]


@pytest.fixture
def mesh(roots, tmp_path):
    root = tmp_path / "shared"
    shutil.copytree(roots[1], root)
    m = Mesh(str(root))
    try:
        yield m
    finally:
        m.close()


def _score(base, member, seed=7, rows=24):
    X = np.random.RandomState(seed).rand(rows, N_FEATURES).astype("float32")
    return _call(f"{base}{P}/{member}/anomaly/prediction", "POST", pack_frames([("X", X)]),
                 {"Content-Type": TENSOR_CONTENT_TYPE})


def test_dual_ownership_answers_bitwise_on_both_replicas(mesh):
    table = mesh.routing()
    assert sorted(table["members"]) == MEMBERS
    member = next(m for m, o in table["members"].items() if o == 0)
    status, body = _call(mesh.urls[1] + P + "/mesh/acquire", "POST", {"member": member, "source": mesh.urls[0]})
    assert status == 200 and body["acquired"] and body["shipped"] and body["swap"]["generation"] == 1, body
    answers = [_score(u, member) for u in mesh.urls]
    assert answers[0][0] == answers[1][0] == 200 and answers[0][1] == answers[1][1]
    table = mesh.routing(refresh=True)
    assert table["migrating"].get(member) == [0, 1] and table["members"][member] in (0, 1)
    status, body = _call(mesh.urls[1] + P + "/mesh/acquire", "POST", {"member": member})
    assert status == 200 and body["already_owned"] is True and body["generation"] == 1


def test_migration_under_load_answers_200_throughout(mesh):
    table = mesh.routing()
    v0 = table["version"]
    member = next(m for m, o in table["members"].items() if o == 0)
    want = _score(mesh.urls[0], member, seed=3)
    statuses, answers, rerouted, stop = [], [], [], threading.Event()

    def load():
        # a client that follows the table, refetching it once on a 404 (a
        # table read before the release), as the bulk client does
        while not stop.is_set():
            status, body = _score(mesh.urls[mesh.routing()["members"].get(member, 0)], member, seed=3)
            if status == 404:
                rerouted.append(1)
                status, body = _score(mesh.urls[mesh.routing(refresh=True)["members"][member]], member, seed=3)
            statuses.append(status)
            answers.append(body)

    loader = threading.Thread(target=load)
    loader.start()
    try:
        status, verdict = _call(mesh.wm.url + "/migrate", "POST", {"member": member, "to": 1})
    finally:
        stop.set()
        loader.join()
    assert status == 200 and verdict["moved"] and verdict["src"] == 0 and verdict["dst"] == 1, verdict
    assert verdict["acquire"]["swap"]["pause_ms"] is not None and verdict["release"]["swap"]["pause_ms"] is not None
    assert statuses and set(statuses) == {200}, sorted(set(statuses))
    assert all(a == want[1] for a in answers)  # bitwise before, during and after
    table = mesh.routing(refresh=True)
    assert table["members"][member] == 1 and member not in table["migrating"] and table["version"] > v0
    assert _score(mesh.urls[1], member, seed=3) == want
    assert _call(mesh.urls[0] + P + "/mesh")[1]["owned"] == sorted(set(MEMBERS[:2]) - {member})
    status, text = _call(mesh.wm.url + "/metrics")
    assert status == 200 and "gordo_fleet_migrations_total 1" in text.decode()
    assert "gordo_fleet_routing_version" in text.decode()
    events = _call(mesh.urls[1] + P + "/events?type=mesh.acquire")[1]["events"]
    assert [(e["type"], e["attrs"]["member"], e["replica"]) for e in events] == [("mesh.acquire", member, "replica-1")]


def test_migrate_validation_and_conflict(mesh):
    assert _call(mesh.wm.url + "/migrate", "POST", {"member": "x"})[0] == 400
    assert _call(mesh.wm.url + "/migrate", "POST", b"nope")[0] == 400
    assert _call(mesh.wm.url + "/migrate", "POST", {"member": "x", "to": 1, "from": "0"})[0] == 400
    member, owner = next(iter(mesh.routing()["members"].items()))
    status, body = _call(mesh.wm.url + "/migrate", "POST", {"member": member, "to": owner})
    assert status == 409 and body["error"] == "member already at destination"
    status, body = _call(mesh.wm.url + "/migrate", "POST", {"member": member, "to": 99})
    assert status == 409 and body["error"] == "unknown destination replica 99"
    # an acquire the destination refuses: counted as a failed migration
    status, body = _call(mesh.wm.url + "/migrate", "POST", {"member": "ghost", "to": 1, "from": 0})
    assert status == 409 and body["error"].startswith("acquire answered 502"), body
    assert "gordo_fleet_migrations_failed_total 1" in _call(mesh.wm.url + "/metrics")[1].decode()


def test_acquire_with_source_ships_into_a_replica_of_its_own_root(roots, tmp_path):
    _jax_root, port_root = roots
    own = tmp_path / "own"
    os.makedirs(own)
    shutil.copytree(os.path.join(port_root, MEMBERS[0]), own / MEMBERS[0])
    src = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    dst = _with_env(ENV, lambda: run_server(str(own), host="127.0.0.1", port=0, device="cpu", background=True))
    try:
        status, body = _call(dst.url + P + "/mesh/acquire", "POST", {"member": MEMBERS[2]})
        assert status == 404 and "hint" in body
        status, body = _call(dst.url + P + "/mesh/acquire", "POST", {"member": MEMBERS[2], "source": src.url})
        assert status == 200 and body["shipped"] and body["owned"] == [MEMBERS[0], MEMBERS[2]], body
        assert _tree(own / MEMBERS[2]) == _tree(os.path.join(port_root, MEMBERS[2]))
        assert _score(dst.url, MEMBERS[2]) == _score(src.url, MEMBERS[2])
        status, body = _call(dst.url + P + "/mesh/acquire", "POST", {"member": MEMBERS[3], "source": "http://127.0.0.1:1"})
        assert status == 502 and "artifact fetch from http://127.0.0.1:1 failed" in body["error"]
    finally:
        dst.close()
        src.close()


async def _jax_watchman_dry_run(urls):
    app = jax_watchman_app("proj", urls[0], refresh_interval=0.1, metrics_urls=[u + P + "/metrics" for u in urls])
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        resp = await client.post("/fleet-rebalance?dry_run=1")
        return resp.status, await resp.json()
    finally:
        await client.close()


def test_fleet_rebalance_dry_run_as_jax_then_a_forced_move(mesh):
    hot = [m for m, o in mesh.routing()["members"].items() if o == 0]
    for _ in range(6):
        for m in hot:
            assert _score(mesh.urls[0], m, seed=5, rows=48)[0] == 200
    status, preview = _call(mesh.wm.url + "/fleet-rebalance?dry_run=1", "POST")
    assert status == 200 and preview["applied"] == 0 and preview["dry_run"] is True
    assert "insufficient load signal" in preview["plan"]["reason"]
    jax_status, jax_preview = asyncio.run(_jax_watchman_dry_run(mesh.urls))
    assert (status, preview) == (jax_status, jax_preview)
    status, result = _call(mesh.wm.url + "/fleet-rebalance", "POST", {"force": True})
    assert status == 200 and result["plan"]["moves"] and result["applied"] >= 1, result
    move = result["moves"][0]
    assert move["moved"] and move["dst"] == 1
    assert mesh.routing(refresh=True)["members"][move["member"]] == 1
    assert f"gordo_fleet_migrations_total {result['applied']}" in _call(mesh.wm.url + "/metrics")[1].decode()


def test_a_dark_replica_steps_the_version_and_emits_mesh_events(roots, tmp_path):
    root = tmp_path / "shared"
    shutil.copytree(roots[1], root)
    mesh = Mesh(str(root), refresh_interval=300.0)
    try:
        v0 = mesh.routing(refresh=True)["version"]
        port_resilience.configure_from_env("watchman.probe=refuse,times=2")
        dark = mesh.routing(refresh=True)
        assert dark["version"] > v0 and not any(r["reachable"] for r in dark["replicas"])
        healed = mesh.routing(refresh=True)
        assert healed["version"] > dark["version"] and all(r["reachable"] for r in healed["replicas"])
        assert sorted(healed["members"]) == MEMBERS
        events = _call(mesh.wm.url + "/events?type=mesh.replica_unreachable,mesh.replica_recovered")[1]["events"]
        types = [e["type"] for e in events]
        assert types.index("mesh.replica_unreachable") < types.index("mesh.replica_recovered")
        assert next(e for e in events if e["type"] == "mesh.replica_unreachable")["severity"] == "error"
    finally:
        mesh.close()
