"""The bulk client's rules against the JAX package's, on the CPU.

- ``resilience/retry_budget.py``: ``decorrelated_jitter`` fed one
  ``random.Random`` gives the JAX sleeps bitwise; ``RetryBudget`` walks
  the same states and refuses the same arguments; ``Deadline.wait_for``
  raises a ``DeadlineExceeded`` that ``asyncio.TimeoutError`` catches.
- ``client/io.py`` against the JAX module over one loopback stub each
  (``tests/torch_client_stubs.py``), the port on its own HTTP client, JAX
  on aiohttp: ``retry_after_seconds`` (both RFC 9110 forms), the retried
  statuses and the raised ones, ``Retry-After`` as the sleep's lower
  bound, the budget's cap, the deadline header restamped on each attempt
  and no sleep past it, hedging (a fast primary never hedges, the hedge
  gets one attempt and no budget, the primary's error when both fail), and
  a keep-alive socket that outlives a cancelled hedge; the session's
  answer framings (length, chunked, HTTP/1.0 to the close) and codings.
- ``client/client.py``'s rules against the JAX ``Client``: the
  constructor's checks and per-class posture, ``_connector_limit``,
  ``_hedge_delay_s``, ``_chunk_urls`` with and without a routing table,
  ``_trace_headers`` and ``_fetch_routing`` against a stub ``/routing``
  with an ETag (304, the forced refresh, the per-member throttle).

Every network wait has a timeout; the file takes a few seconds.
"""

import asyncio
import random
import zlib
from email.utils import format_datetime
from datetime import datetime, timedelta, timezone

import aiohttp
import pytest

from gordo_components_torch.client import Client as PortClient
from gordo_components_torch.client import http as port_http
from gordo_components_torch.client import io as port_io
from gordo_components_torch.resilience import deadline as port_deadline
from gordo_components_torch.resilience import retry_budget as port_rb
from gordo_components_tpu.client import Client as JaxClient
from gordo_components_tpu.client import io as jax_io
from gordo_components_tpu.resilience import deadline as jax_deadline
from gordo_components_tpu.resilience import retry_budget as jax_rb
from torch_client_stubs import RawStub, Stub, answer

TIMEOUT_S = 30  # the bound of every test's network waits

# --------------------------------------------------------------------------- #
# retry_budget and Deadline
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("base, prev, cap", [(0.5, 0.5, 60.0), (0.1, 2.0, 1.0), (1.0, 0.2, 60.0), (0.0, 0.0, 5.0),
                                             (0.5, 40.0, 60.0), (0.5, 0.5, -1.0)])
def test_decorrelated_jitter_is_bitwise_the_jax_schedule(base, prev, cap):
    a, b = random.Random(11), random.Random(11)
    got, want = [], []
    p = q = prev
    for _ in range(20):
        p = port_rb.decorrelated_jitter(base, p, cap=cap, rng=a)
        q = jax_rb.decorrelated_jitter(base, q, cap=cap, rng=b)
        got.append(p)
        want.append(q)
    assert got == want


def test_retry_budget_walks_the_jax_states():
    steps = "nsssssssssssssnnnnnnnnnnnnnnnnnnnnnnnnnnnnnnnnnnssnsns" * 3
    for kwargs in ({}, {"ratio": 0.5, "initial": 0.0, "max_tokens": 2.0}, {"ratio": 0.0, "initial": 3.0},
                   {"initial": 500.0}):
        port, jax = port_rb.RetryBudget(**kwargs), jax_rb.RetryBudget(**kwargs)
        for step in steps:
            if step == "n":
                port.note_request(), jax.note_request()
            else:
                assert port.try_spend() == jax.try_spend()
            assert port.snapshot() == jax.snapshot()
        assert repr(port) == repr(jax)
    for kwargs in ({"ratio": -0.1}, {"max_tokens": 0}):
        with pytest.raises(ValueError) as got:
            port_rb.RetryBudget(**kwargs)
        with pytest.raises(ValueError) as want:
            jax_rb.RetryBudget(**kwargs)
        assert str(got.value) == str(want.value)


def test_deadline_wait_for_raises_a_timeout_error_as_jax():
    async def slow():
        await asyncio.sleep(5)

    async def go(module):
        d = module.Deadline(0.02)
        try:
            await d.wait_for(slow())
        except asyncio.TimeoutError as exc:
            return type(exc).__name__, str(exc)
        return None

    got, want = asyncio.run(go(port_deadline)), asyncio.run(go(jax_deadline))
    assert got == want == ("DeadlineExceeded", "deadline exceeded after 0.020s budget")

    async def fast(module):
        async def value():
            return 7
        return await module.Deadline(5).wait_for(value())

    assert asyncio.run(fast(port_deadline)) == asyncio.run(fast(jax_deadline)) == 7


# --------------------------------------------------------------------------- #
# io: retry_after_seconds
# --------------------------------------------------------------------------- #

def _http_date(seconds_from_now):
    return format_datetime(datetime.now(timezone.utc) + timedelta(seconds=seconds_from_now), usegmt=True)


@pytest.mark.parametrize("value", ["17", " 3.5 ", "", "   ", "-4", "0", "inf", "nan", "1e3", "garbage",
                                   "Wed, 21 Oct 2015 07:28:00 GMT", "21 Oct 2015 07:28:00", "Wed, 32 Oct 2015 07:28:00 GMT",
                                   "future-http-date"])
def test_retry_after_seconds_matches_jax(value):
    future = value == "future-http-date"
    if future:
        value = _http_date(120)
    got, want = port_io.retry_after_seconds(value), jax_io.retry_after_seconds(value)
    if future:
        assert 100 < got < 121 and abs(got - want) < 2.0  # each side reads the clock itself
    elif want is None or want != want:
        assert (got is None and want is None) or (got != got and want != want)
    else:
        assert got == want
    if value == "Wed, 21 Oct 2015 07:28:00 GMT":
        assert got == 0.0


# --------------------------------------------------------------------------- #
# io: fetch_json against a stub, the port on its client and JAX on aiohttp
# --------------------------------------------------------------------------- #

@pytest.fixture
def sleeps(monkeypatch):
    """The sleeps asked for (each slept for at most 0.5 s)."""
    asked = []
    real = asyncio.sleep

    async def fake(delay, *args, **kwargs):
        if delay > 0:
            asked.append(delay)
        await real(min(delay, 0.5), *args, **kwargs)

    monkeypatch.setattr(asyncio, "sleep", fake)
    return asked


def _run_both(script, call, sleeps):
    """{"port"/"jax": (outcome, sleeps, the stub's requests)} of ``call``
    (``(module, session, url) -> awaitable``) against a fresh stub each."""
    out = {}
    for side in ("port", "jax"):
        stub = Stub(script)
        sleeps.clear()
        url = stub.url + "/thing"

        async def go():
            if side == "port":
                async with port_http.Session(timeout=TIMEOUT_S) as s:
                    return await call(port_io, s, url)
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=TIMEOUT_S)) as s:
                return await call(jax_io, s, url)

        try:
            result = ("ok", asyncio.run(go()))
        except Exception as exc:
            result = ("raised", _err(exc, stub.url))
        finally:
            stub.close()
        out[side] = result, list(sleeps), stub.requests
    return out


def _err(exc, base=None):
    """An error as both sides can be compared: the class's family, the
    status and the message (``base``, a stub's URL, masked)."""
    status = getattr(exc, "status", None)
    family = {"ClientResponseError": "response", "ValueError": "value", "HttpUnprocessableEntity": "422",
              "DeadlineExceeded": "deadline"}.get(type(exc).__name__, type(exc).__name__)
    message = getattr(exc, "message", None) if status is not None else str(exc)
    if base and isinstance(message, str):
        message = message.replace(base, "URL")
    return family, status, message


RETRY_CASES = {
    "500-500-200": [answer(500, {"error": "boom"}), answer(500, {"error": "boom"}), answer(200, {"v": 1})],
    "408-200": [answer(408, b"slow"), answer(200, {"v": 2})],
    "503-always": [answer(503, {"error": "down"})],
    "429-retry-after-7": [answer(429, {"error": "shed"}, {"Retry-After": "7"}), answer(200, {"v": 3})],
    "429-retry-after-past-date": [answer(429, b"shed", {"Retry-After": "Wed, 21 Oct 2015 07:28:00 GMT"}),
                                  answer(200, {"v": 4})],
    "429-retry-after-huge": [answer(429, b"shed", {"Retry-After": "99999"}), answer(200, {"v": 5})],
    "404": [answer(404, {"error": "No such model"})],
    "400": [answer(400, b"x" * 900)],
    "422": [answer(422, {"error": "not a detector"})],
    "200-tensor": [answer(200, b"GTNS\x01rest", content_type="application/x-gordo-tensor")],
    "200-text": [answer(200, b"hello", content_type="text/plain"), answer(200, {"v": 6})],
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_fetch_json_retries_and_raises_as_jax(case, sleeps):
    budgets = {}

    def call(module, session, url):
        budget = (port_rb if module is port_io else jax_rb).RetryBudget()
        budgets[module.__name__] = budget
        return module.fetch_json(session, url, retries=3, backoff=0.01, retry_budget=budget, rng=random.Random(3))

    out = _run_both({"/thing": RETRY_CASES[case]}, call, sleeps)
    (port_res, port_sleeps, port_reqs), (jax_res, jax_sleeps, jax_reqs) = out["port"], out["jax"]
    assert port_res == jax_res
    assert port_sleeps == jax_sleeps
    assert len(port_reqs) == len(jax_reqs)
    assert budgets["gordo_components_torch.client.io"].snapshot() == budgets["gordo_components_tpu.client.io"].snapshot()
    if case.startswith("429-retry-after-7"):
        assert port_sleeps == [7.0]
    if case.startswith("429-retry-after-huge"):
        assert port_sleeps == [60.0]


def test_an_exhausted_budget_fails_fast_as_jax(sleeps):
    def call(module, session, url):
        budget = (port_rb if module is port_io else jax_rb).RetryBudget(ratio=0.0, initial=0.0)
        return module.fetch_json(session, url, retries=5, backoff=0.01, retry_budget=budget, rng=random.Random(3))

    out = _run_both({"/thing": [answer(500, b"boom"), answer(200, {"v": 1})]}, call, sleeps)
    for side in ("port", "jax"):
        result, slept, reqs = out[side]
        assert result[0] == "raised" and result[1][:2] == ("response", 500)
        assert slept == [] and len(reqs) == 1


def test_the_deadline_header_is_restamped_and_no_sleep_passes_it(sleeps):
    def call(module, session, url):
        d = (port_deadline if module is port_io else jax_deadline).Deadline.after_ms(400)
        return module.fetch_json(session, url, retries=4, backoff=0.01, deadline=d, rng=random.Random(3))

    script = {"/thing": [answer(429, b"shed", {"Retry-After": "30"})]}
    out = _run_both(script, call, sleeps)
    for side in ("port", "jax"):
        result, slept, reqs = out[side]
        # the second attempt finds the deadline spent (or, a hair before
        # it, gets the 429 again): either way the error, never a 30 s sleep
        assert result[0] == "raised" and result[1][:2] in (("deadline", None), ("response", 429)), side
        stamps = [int(h["X-Gordo-Deadline-Ms"]) for _, _, h, _ in reqs]
        assert 1 <= len(stamps) <= 2 and stamps[0] <= 400 and stamps == sorted(stamps, reverse=True), side
        assert slept and all(s <= 0.4 for s in slept), side
    assert len(out["port"][2]) == len(out["jax"][2])


def test_fetch_metadata_all_matches_jax(sleeps):
    cases = {
        "ok": [answer(200, {"project": "p", "targets": {"a": {"endpoint-metadata": {"x": 1}}}})],
        "404": [answer(404, {"error": "nope"})],
        "not-a-dict": [answer(200, [1, 2])],
        "targets-list": [answer(200, {"targets": [1]})],
        "malformed": [answer(200, b"{nope")],
        "slow": [answer(200, {"targets": {}}, delay_s=0.6)],
    }
    for name, steps in cases.items():
        def call(module, session, url):
            return module.fetch_metadata_all(session, url.rsplit("/thing", 1)[0], "p", deadline=0.3)

        out = _run_both({"/gordo/v0/p/metadata-all": steps}, call, sleeps)
        assert out["port"][0] == out["jax"][0], name


# --------------------------------------------------------------------------- #
# hedging
# --------------------------------------------------------------------------- #

def _hedge_run(module, session_factory, urls, delay, stats, **kw):
    async def go():
        async with session_factory() as s:
            res = await module.fetch_json_hedged(s, urls, hedge_delay_s=delay, hedge_stats=stats, retries=3,
                                                 backoff=0.01, rng=random.Random(5), **kw)
            # the session's next request after a cancelled loser
            after = await module.fetch_json(s, urls[0].replace("/slow", "/fast"), retries=1)
            return res, after
    return asyncio.run(go())


def _sessions():
    return {"port": (port_io, lambda: port_http.Session(timeout=TIMEOUT_S)),
            "jax": (jax_io, lambda: aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=TIMEOUT_S)))}


@pytest.mark.parametrize("scenario", ["fast-primary", "slow-primary", "both-fail", "hedge-fails", "primary-fails-fast"])
def test_hedging_matches_jax(scenario, sleeps):
    primary_script = {
        "fast-primary": [answer(200, {"who": "primary"})],
        "slow-primary": [answer(200, {"who": "primary"}, delay_s=1.0)],
        "both-fail": [answer(503, {"error": "primary down"}, delay_s=0.3)],
        "hedge-fails": [answer(200, {"who": "primary"}, delay_s=0.4)],
        "primary-fails-fast": [answer(404, {"error": "gone"})],
    }[scenario]
    hedge_script = {
        "both-fail": [answer(500, {"error": "hedge down"})],
        "hedge-fails": [answer(500, {"error": "hedge down"})],
    }.get(scenario, [answer(200, {"who": "hedge"})])
    outcomes = {}
    for side, (module, factory) in _sessions().items():
        primary = Stub({"/slow": primary_script, "/fast": [answer(200, {"who": "after"})]})
        hedge = Stub({"/slow": hedge_script})
        stats = {"hedges": 0, "hedge_wins": 0}
        budget = (port_rb if module is port_io else jax_rb).RetryBudget(ratio=0.0, initial=1.0)
        try:
            try:
                res = _hedge_run(module, factory, [primary.url + "/slow", hedge.url + "/slow"], 0.15, stats,
                                 retry_budget=budget)
            except Exception as exc:
                res = ("raised", _err(exc, primary.url))
        finally:
            primary.close()
            hedge.close()
        outcomes[side] = res, stats, len(hedge.requests), budget.snapshot()
    assert outcomes["port"] == outcomes["jax"]
    res, stats, hedge_requests, _ = outcomes["port"]
    expect = {
        "fast-primary": ({"hedges": 0, "hedge_wins": 0}, 0),
        "slow-primary": ({"hedges": 1, "hedge_wins": 1}, 1),
        "both-fail": ({"hedges": 1, "hedge_wins": 0}, 1),  # the hedge's one attempt, no budget
        "hedge-fails": ({"hedges": 1, "hedge_wins": 0}, 1),
        "primary-fails-fast": ({"hedges": 0, "hedge_wins": 0}, 0),
    }[scenario]
    assert (stats, hedge_requests) == expect
    if scenario == "both-fail":
        assert res == ("raised", ("response", 503, '{"error": "primary down"}'))
    elif scenario != "primary-fails-fast":
        assert res[1] == {"who": "after"}


def test_a_cancelled_request_closes_its_socket_and_the_pool_reuses_the_rest():
    stub = Stub({"/slow": [answer(200, {"v": "slow"}, delay_s=2.0)], "/fast": [answer(200, {"v": "fast"})]})

    async def go():
        async with port_http.Session(limit=4, timeout=TIMEOUT_S) as s:
            first = await s.get(stub.url + "/fast")
            task = asyncio.ensure_future(s.get(stub.url + "/slow"))
            await asyncio.sleep(0.2)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            answers = [(await s.get(stub.url + "/fast")).json() for _ in range(5)]
            idle = sum(len(p) for p in s._idle.values())
            return first.json(), answers, idle

    try:
        first, answers, idle = asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
    finally:
        stub.close()
    assert first == {"v": "fast"} and answers == [{"v": "fast"}] * 5
    assert idle == 1  # one socket carried every answer after the first


def _chunked(data: bytes) -> bytes:
    """``data`` in two chunks, a chunk extension and a trailer field."""
    half = len(data) // 2
    return (b"%x;ext=1\r\n%s\r\n%x\r\n%s\r\n0\r\nX-Trailer: 1\r\n\r\n"
            % (half, data[:half], len(data) - half, data[half:]))


def test_http_session_reads_gzip_chunked_and_http10_answers():
    """gzip with a length; a chunked answer, plain and gzip (a compressed
    aiohttp answer goes out chunked), twice on one socket; an HTTP/1.0
    answer with no length, read to the close and never pooled."""
    import gzip
    body = b'{"a": 1}'
    stub = Stub({"/gz": [answer(200, gzip.compress(body), {"Content-Encoding": "gzip"})]})

    async def get(url, n=1, **kwargs):
        async with port_http.Session(timeout=TIMEOUT_S) as s:
            out = [await s.get(url, **kwargs) for _ in range(n)]
            idle = sum(len(p) for p in s._idle.values())
        return [(r.status, r.json(), r.headers.get("content-encoding"), r.content_type) for r in out], idle

    try:
        got, _ = asyncio.run(asyncio.wait_for(get(stub.url + "/gz", params={"digest": "1"}), TIMEOUT_S))
        assert got == [(200, {"a": 1}, "gzip", "application/json")]
        assert stub.requests[0][1] == "/gz?digest=1" and "gzip" in stub.requests[0][2]["Accept-Encoding"]
    finally:
        stub.close()
    head = b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\nTransfer-Encoding: chunked\r\n"
    for coding, data in ((None, body), ("gzip", gzip.compress(body))):
        raw = head + (b"Content-Encoding: %s\r\n" % coding.encode() if coding else b"") + b"\r\n" + _chunked(data)
        stub = RawStub(raw)
        try:
            got, idle = asyncio.run(asyncio.wait_for(get(stub.url + "/c", n=2), TIMEOUT_S))
            assert got == [(200, {"a": 1}, coding, "application/json")] * 2
            assert (stub.connections, idle) == (1, 1)  # the second answer came on the first's socket
        finally:
            stub.close()
    stub = RawStub(b"HTTP/1.0 200 OK\r\nContent-Type: application/json\r\n\r\n" + body, close=True)
    try:
        got, idle = asyncio.run(asyncio.wait_for(get(stub.url + "/h", n=2), TIMEOUT_S))
        assert got == [(200, {"a": 1}, None, "application/json")] * 2
        assert (stub.connections, idle) == (2, 0)
    finally:
        stub.close()


@pytest.mark.parametrize("wbits", [zlib.MAX_WBITS, -zlib.MAX_WBITS], ids=["zlib", "raw"])
def test_http_session_decodes_deflate_answers(wbits):
    """``Content-Encoding: deflate`` as aiohttp's server sends it (zlib's
    format; the JAX server picks deflate first for ``gzip, deflate``) and
    as raw deflate, which aiohttp's client also reads."""
    body = b'{"a": [1, 2, 3]}'
    packer = zlib.compressobj(wbits=wbits)
    data = packer.compress(body) + packer.flush()
    stub = Stub({"/d": [answer(200, data, {"Content-Encoding": "deflate"})]})

    async def go():
        async with port_http.Session(timeout=TIMEOUT_S) as s:
            resp = await s.get(stub.url + "/d")
            return resp.status, resp.json()

    try:
        assert asyncio.run(asyncio.wait_for(go(), TIMEOUT_S)) == (200, {"a": [1, 2, 3]})
    finally:
        stub.close()


# --------------------------------------------------------------------------- #
# the client's rules
# --------------------------------------------------------------------------- #

TABLE = {
    "version": 4,
    "members": {"m1": 0, "m2": 1, "m3": 7, "m4": 2},
    "migrating": {"m1": [0, 1, 2], "m2": [1, 2], "m4": [2, 0]},
    "replicas": [
        {"replica": 0, "url": "http://r0:1/", "status": "ok"},
        {"replica": 1, "url": "http://r1:1", "status": "degraded"},
        {"replica": 2, "url": "http://r2:1", "reachable": True, "quarantined": ["m4"]},
        {"replica": 3, "url": "http://r3:1", "reachable": False},
        {"url": "http://no-index"},
    ],
}

CLIENT_KWARGS = [
    {},
    {"hedge": True, "parallelism": 3},
    {"hedge": True, "priority": "best-effort", "parallelism": 20},
    {"priority": "bulk", "tenant": "  acme|x  "},
    {"hedge": True, "replica_urls": ["http://a:1/", "http://b:2", "", "http://base:5555"],
     "base_url": "http://base:5555/"},
    {"hedge": True, "routing": TABLE},
    {"routing": TABLE, "parallelism": 1},
    {"retry_budget_ratio": 0.3, "priority": "batch"},
]


def _pair(**kwargs):
    port, jax = PortClient("proj", **kwargs), JaxClient("proj", **kwargs)
    port._hedge_rng, jax._hedge_rng = random.Random(9), random.Random(9)
    port._rid_prefix = jax._rid_prefix = "abcdef012345"
    return port, jax


@pytest.mark.parametrize("i", range(len(CLIENT_KWARGS)))
def test_client_posture_urls_and_routing_match_jax(i):
    port, jax = _pair(**CLIENT_KWARGS[i])
    for attr in ("base_url", "tenant", "qos_class", "hedge", "replica_urls", "routing_version",
                 "hedge_delay_init_s", "retries", "backoff", "transport", "use_parquet", "use_tensor"):
        assert getattr(port, attr) == getattr(jax, attr), attr
    assert port.retry_budget.snapshot() == jax.retry_budget.snapshot()
    assert port._connector_limit() == jax._connector_limit()
    assert port._routing == jax._routing
    for target in ("m1", "m2", "m3", "m4", "m5"):
        for endpoint in ("anomaly/prediction", "prediction"):
            assert port._chunk_urls(target, endpoint) == jax._chunk_urls(target, endpoint)
        assert port._url(target, "metadata") == jax._url(target, "metadata")
        assert port._member_base_url(target) == jax._member_base_url(target)
    for rep in TABLE["replicas"]:
        for target in ("m1", "m4"):
            assert port._replica_healthy_for(rep, target) == jax._replica_healthy_for(rep, target)
    assert port._trace_headers("abcdef012345-1f") == jax._trace_headers("abcdef012345-1f")
    rng = random.Random(i)
    for n in range(40):
        assert port._hedge_delay_s() == jax._hedge_delay_s(), n
        s = rng.random()
        port._latency.record(s)
        jax._latency.record(s)


@pytest.mark.parametrize("kwargs", [{"use_parquet": "yes"}, {"use_tensor": "maybe"}, {"transport": "quic"},
                                    {"routing": {"members": [1]}}, {"routing": []}])
def test_client_refuses_what_jax_refuses(kwargs):
    with pytest.raises(ValueError) as got:
        PortClient("p", **kwargs)
    with pytest.raises(ValueError) as want:
        JaxClient("p", **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("snapshot", [{}, {"replicas": None}, {"replicas": ["http://a/", "", 7, {"url": "http://b//"},
                                                                            {"status": "ok"}, {"url": None}]}])
def test_replicas_from_watchman_matches_jax(snapshot):
    assert PortClient.replicas_from_watchman(snapshot) == JaxClient.replicas_from_watchman(snapshot)


def test_ingest_is_refused_naming_a8():
    """A8's ``/ingest`` is ported: a server without its streaming plane
    refuses the forwarder's chunk, and the error names the knob; the JAX
    client's forwarder fails on the same answer."""
    refused = {"error": "streaming plane not enabled (GORDO_STREAM=0)"}
    for cls, match in ((PortClient, r"HTTP 404 .*GORDO_STREAM=0"), (JaxClient, "404|GORDO_STREAM=0")):
        stub = Stub({"/gordo/v0/p/m1/ingest": [answer(404, refused)]})
        try:
            with pytest.raises(Exception, match=match):
                cls("p", base_url=stub.url, retries=1).ingest("m1", [[1.0]])
        finally:
            stub.close()
        assert [r[:2] for r in stub.requests] == [("POST", "/gordo/v0/p/m1/ingest")]


def test_fetch_routing_etag_force_and_throttle_match_jax():
    table2 = {**TABLE, "version": 5}
    script = {"/routing": [answer(200, TABLE, {"ETag": '"v4"'}), answer(304, b""),
                           answer(200, table2, {"ETag": '"v5"'}), answer(200, table2, {"ETag": '"v5"'}),
                           answer(500, b"boom"), answer(200, {"nope": 1})]}
    logs = {}
    for side, cls, factory in (("port", PortClient, lambda: port_http.Session(timeout=TIMEOUT_S)),
                               ("jax", JaxClient,
                                lambda: aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=TIMEOUT_S)))):
        stub = Stub(script)
        client = cls("proj", routing_url=stub.url + "/", routing_refresh_window_s=60.0)

        async def go():
            async with factory() as s:
                return [
                    await client._fetch_routing(s),
                    await client._fetch_routing(s),
                    await client._fetch_routing(s, force=True, member="m1"),
                    await client._fetch_routing(s, force=True, member="m1"),  # throttled: no request
                    await client._fetch_routing(s, force=True, member="m2"),
                    await client._fetch_routing(s),
                    await client._fetch_routing(s),
                ]

        try:
            changed = asyncio.run(asyncio.wait_for(go(), TIMEOUT_S))
        finally:
            stub.close()
        logs[side] = (changed, [(p, h.get("If-None-Match")) for _, p, h, _ in stub.requests],
                      client.routing_version, dict(client._fanout_stats), client._routing_etag)
    assert logs["port"] == logs["jax"]
    changed, requests, version, stats, _ = logs["port"]
    assert changed == [True, False, True, False, False, False, False]
    assert requests[:3] == [("/routing", None), ("/routing", '"v4"'), ("/routing?refresh=1", None)]
    assert version == 5 and stats["refreshes_throttled"] == 1


@pytest.mark.parametrize("ns", [1577837400000000000, 0, 1577837400123456000, 1577837400000000007,
                                -86400123456789, 4102444799999999999], ids=str)
def test_timestamp_texts_are_str_of_pandas_timestamps(ns):
    import numpy as np
    import pandas as pd
    from gordo_components_torch.dataset.times import timestamp_texts

    index = np.array([ns, ns + 600_000_000_000], dtype="datetime64[ns]")
    assert timestamp_texts(index) == [str(pd.Timestamp(int(n), tz="UTC")) for n in index.view(np.int64)]
