"""The port's data-lake auth flows, driven offline through stub transports:
the cases of ``tests/test_lake_auth.py`` against
``gordo_components_torch.dataset.data_provider.auth`` (the port's own copy
of the JAX module) and the port's ``DataLakeProvider``.

An in-process transport plays the AAD token endpoints, the device flow's
polling protocol (authorization_pending -> slow_down -> token) and its
error surfaces included. The port's module must answer as the JAX one
does: the same parts from a ``dl_service_auth_str``, the same errors, the
same redacted parameters.
"""

import pandas as pd
import pytest

from gordo_components_torch.dataset.data_provider.auth import (
    DeviceCodeFlow,
    LakeCredential,
    ServicePrincipalFlow,
    Token,
    credential_from_config,
    parse_service_auth_str,
)
from gordo_components_torch.dataset.data_provider.datalake import DataLakeProvider
from gordo_components_torch.dataset.times import to_ns
from gordo_components_tpu.dataset.data_provider import auth as jax_auth
from gordo_components_tpu.dataset.data_provider.datalake import DataLakeProvider as JaxDataLakeProvider


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_parse_service_auth_str():
    parts = parse_service_auth_str("ten:cli:sec")
    assert parts == {
        "tenant_id": "ten", "client_id": "cli", "client_secret": "sec"
    } == jax_auth.parse_service_auth_str("ten:cli:sec")
    for bad in ("", "a:b", "a:b:c:d", "a::c"):
        with pytest.raises(ValueError) as ours:
            parse_service_auth_str(bad)
        with pytest.raises(ValueError) as theirs:
            jax_auth.parse_service_auth_str(bad)
        assert str(ours.value) == str(theirs.value)


def test_service_principal_grant_and_error_redaction():
    calls = []

    def transport(url, form):
        calls.append((url, dict(form)))
        if form["client_secret"] == "good":
            return {"access_token": "tok-1", "expires_in": 100}
        return {
            "error": "invalid_client",
            "error_description": "AADSTS7000215: invalid secret",
        }

    flow = ServicePrincipalFlow(
        "ten", "cli", "good", transport=transport, clock=FakeClock(10.0)
    )
    token = flow.acquire()
    assert token.access_token == "tok-1"
    assert token.expires_on == 110.0
    assert "/ten/oauth2/token" in calls[0][0]
    assert calls[0][1]["grant_type"] == "client_credentials"

    bad = ServicePrincipalFlow("ten", "cli", "nope", transport=transport)
    with pytest.raises(PermissionError) as exc:
        bad.acquire()
    assert "invalid_client" in str(exc.value)
    assert "nope" not in str(exc.value)  # the secret never leaks into errors


def _device_transport(script):
    """Token-endpoint replies played back in order after the devicecode."""
    state = {"polls": 0}

    def transport(url, form):
        if url.endswith("/devicecode"):
            return {
                "device_code": "dev-1",
                "user_code": "ABC123",
                "verification_url": "https://example/device",
                "interval": 1,
                "expires_in": 600,
                "message": "go to https://example/device, enter ABC123",
            }
        assert form["code"] == "dev-1"
        reply = script[min(state["polls"], len(script) - 1)]
        state["polls"] += 1
        return reply

    return transport, state


def test_device_code_flow_polls_to_token():
    transport, state = _device_transport([
        {"error": "authorization_pending"},
        {"error": "slow_down"},
        {"error": "authorization_pending"},
        {"access_token": "tok-dev", "expires_in": 50},
    ])
    prompts, sleeps = [], []
    clock = FakeClock()

    def sleep(s):
        sleeps.append(s)
        clock.t += s

    flow = DeviceCodeFlow(
        "ten", "cli", transport=transport, prompt=prompts.append,
        sleep=sleep, clock=clock,
    )
    token = flow.acquire()
    assert token.access_token == "tok-dev"
    assert state["polls"] == 4
    assert prompts and "ABC123" in prompts[0]
    # slow_down adds 5s to the polling interval from its own poll onward
    assert sleeps == [1.0, 6.0, 6.0]


def test_device_code_flow_denial_and_expiry():
    transport, _ = _device_transport([{"error": "access_denied"}])
    flow = DeviceCodeFlow(
        "ten", "cli", transport=transport, prompt=lambda m: None,
        sleep=lambda s: None, clock=FakeClock(),
    )
    with pytest.raises(PermissionError, match="access_denied"):
        flow.acquire()

    transport, _ = _device_transport([{"error": "authorization_pending"}])
    clock = FakeClock()

    def sleep(s):
        clock.t += 400.0  # two sleeps blow past the 600s code expiry

    slow = DeviceCodeFlow(
        "ten", "cli", transport=transport, prompt=lambda m: None,
        sleep=sleep, clock=clock,
    )
    with pytest.raises(TimeoutError):
        slow.acquire()


def test_credential_caches_and_refreshes_before_expiry():
    clock = FakeClock()
    acquired = []

    class Flow:
        def acquire(self):
            acquired.append(clock.t)
            return Token("tok-%d" % len(acquired), clock.t + 1000.0)

    cred = LakeCredential(Flow(), clock=clock)
    assert cred.get_token() == "tok-1"
    clock.t = 600.0  # still >300s from expiry: cached
    assert cred.get_token() == "tok-1"
    clock.t = 701.0  # inside the 300s refresh skew: re-acquire
    assert cred.get_token() == "tok-2"
    assert acquired == [0.0, 701.0]
    assert cred.headers() == {"Authorization": "Bearer tok-2"}


def test_credential_from_config_precedence():
    assert credential_from_config() is None
    sp = credential_from_config(
        interactive=True, dl_service_auth_str="t:c:s", transport=lambda u, f: {}
    )
    # service-principal wins when both are set: builder pods are headless
    assert isinstance(sp.flow, ServicePrincipalFlow)
    dev = credential_from_config(
        interactive=True, transport=lambda u, f: {},
        tenant_id="ten", client_id="cli",
    )
    assert isinstance(dev.flow, DeviceCodeFlow)


def test_provider_env_indirection_keeps_secret_out_of_params(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("LAKE_AUTH", "ten:cli:supersecret")
    provider = DataLakeProvider(
        str(tmp_path), dl_service_auth_str="env:LAKE_AUTH"
    )
    # the captured params (re-emitted into configs/artifact metadata by the
    # serializer) carry the indirection, never the secret
    assert provider._params["dl_service_auth_str"] == "env:LAKE_AUTH"
    assert provider.credential is not None
    assert provider.credential.flow._client_secret == "supersecret"

    jax_provider = JaxDataLakeProvider(str(tmp_path), dl_service_auth_str="env:LAKE_AUTH")
    assert provider.to_dict()["dl_service_auth_str"] == jax_provider.to_dict()["dl_service_auth_str"]

    monkeypatch.delenv("LAKE_AUTH")
    with pytest.raises(ValueError, match="LAKE_AUTH"):
        DataLakeProvider(str(tmp_path), dl_service_auth_str="env:LAKE_AUTH")


def test_provider_literal_secret_is_redacted_in_params(tmp_path):
    provider = DataLakeProvider(str(tmp_path), dl_service_auth_str="t:c:sec")
    assert provider._params["dl_service_auth_str"] == "t:c:***"
    assert provider.credential.flow._client_secret == "sec"
    # wiring callables never reach the captured params either
    assert "auth_transport" not in provider._params
    assert "auth_kwargs" not in provider._params


def test_bare_interactive_config_constructs_and_round_trips(tmp_path):
    # reference-era YAML is just `interactive: true` — no tenant/client:
    # the public device-code client defaults in, and the provider survives
    # the serializer round-trip (auth wiring callables are not params)
    from gordo_components_torch.dataset.data_provider.auth import (
        DEFAULT_PUBLIC_CLIENT_ID,
    )
    from gordo_components_torch.serializer.definitions import (
        into_definition, pipeline_from_definition,
    )

    assert DEFAULT_PUBLIC_CLIENT_ID == jax_auth.DEFAULT_PUBLIC_CLIENT_ID

    provider = DataLakeProvider(str(tmp_path), interactive=True)
    assert isinstance(provider.credential.flow, DeviceCodeFlow)
    assert provider.credential.flow.client_id == DEFAULT_PUBLIC_CLIENT_ID
    rebuilt = pipeline_from_definition(into_definition(provider))
    assert isinstance(rebuilt, DataLakeProvider)
    assert rebuilt.credential is not None


def test_redacted_auth_str_fails_loudly(tmp_path):
    # 'tenant:client:***' is what artifact metadata carries after
    # redaction; reconstructing with it must fail at the source, not at
    # the first remote request with a baffling invalid_client
    with pytest.raises(ValueError, match="redacted"):
        DataLakeProvider(str(tmp_path), dl_service_auth_str="t:c:***")
    with pytest.raises(ValueError, match="redacted"):
        JaxDataLakeProvider(str(tmp_path), dl_service_auth_str="t:c:***")


def test_provider_offline_reads_never_touch_auth(tmp_path):
    # a mounted lake read with auth configured must not acquire tokens:
    # acquisition is lazy and only remote transports ask for headers
    def exploding_transport(url, form):
        raise AssertionError("offline read hit the token endpoint")

    tag_dir = tmp_path / "asset" / "T1"
    tag_dir.mkdir(parents=True)
    idx = pd.date_range("2020-01-01", periods=5, freq="1h", tz="UTC")
    pd.DataFrame({"Value": range(5)}, index=idx).to_parquet(
        tag_dir / "T1_2020.parquet"
    )
    provider = DataLakeProvider(
        str(tmp_path),
        dl_service_auth_str="t:c:s",
        auth_transport=exploding_transport,
    )
    from gordo_components_torch.dataset.sensor_tag import SensorTag

    series = list(
        provider.load_series(
            to_ns("2020-01-01"),
            to_ns("2020-01-02"),
            [SensorTag("T1", "asset")],
        )
    )
    assert len(series) == 1 and series[0].index.size == 5
    assert list(series[0].values) == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert (series[0].index == idx.as_unit("ns").asi8).all()
