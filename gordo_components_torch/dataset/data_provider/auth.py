"""Data-Lake auth flows: device-code and service-principal OAuth2.

The port's copy of ``gordo_components_tpu/dataset/data_provider/auth.py``
(standard library only; the port imports nothing of the JAX package). The
lake provider authenticates either interactively (the AAD device-code
flow: print a code, the operator enters it at a login page, the client
polls for the token) or from a ``dl_service_auth_str`` of the form
``tenant_id:client_id:client_secret`` (the client-credentials grant). Both
grants go straight to the OAuth2 token endpoints. Every network touch goes
through an injectable ``transport`` callable, so the whole protocol
(pending -> slow_down -> token, refresh before expiry, error surfaces) is
tested offline against a stub.

``transport(url, form: dict) -> dict``: POST ``form`` urlencoded, return
the decoded JSON. OAuth2 error responses (HTTP 400 with an ``error``
field) must be RETURNED, not raised: the device flow's polling protocol
is built from them.
"""

import json
import logging
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

LOGIN_BASE = "https://login.microsoftonline.com"
# Gen1 lake resource identifier (the audience the token is minted for)
DATALAKE_RESOURCE = "https://datalake.azure.net/"
# the well-known public (secretless) client id the reference's lake SDK
# ships as its device-code default; interactive configs that name no app
# of their own sign in through it, exactly as reference-era YAML did
DEFAULT_PUBLIC_CLIENT_ID = "04b07795-8ddb-461a-bbee-02f9e1bf7b46"
# refresh when this close to expiry: long fleet stagings must not start a
# thousand-file read with a token that dies mid-listing
REFRESH_SKEW_S = 300.0


def parse_service_auth_str(auth_str: str) -> Dict[str, str]:
    """``tenant_id:client_id:client_secret`` -> parts (reference format).

    Raises ``ValueError`` naming the expected shape (but never echoing the
    secret) on malformed input.
    """
    parts = auth_str.split(":")
    if len(parts) != 3 or not all(parts):
        raise ValueError(
            "dl_service_auth_str must be 'tenant_id:client_id:client_secret' "
            f"(got {len(parts)} colon-separated part(s))"
        )
    return {
        "tenant_id": parts[0], "client_id": parts[1], "client_secret": parts[2]
    }


def urllib_transport(url: str, form: Dict[str, str]) -> dict:
    """Default transport: stdlib POST, OAuth2 errors returned as dicts."""
    data = urllib.parse.urlencode(form).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/x-www-form-urlencoded"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:  # 400s carry the protocol body
        body = exc.read().decode(errors="replace")
        try:
            return json.loads(body)
        except ValueError:
            raise RuntimeError(f"token endpoint HTTP {exc.code}: {body[:200]}")


class Token:
    """An access token with an absolute (monotonic-clock) expiry."""

    def __init__(self, access_token: str, expires_on: float):
        self.access_token = access_token
        self.expires_on = expires_on

    def expired(self, now: float, skew: float = REFRESH_SKEW_S) -> bool:
        return now >= self.expires_on - skew


class ServicePrincipalFlow:
    """Client-credentials grant from a ``dl_service_auth_str``."""

    def __init__(
        self,
        tenant_id: str,
        client_id: str,
        client_secret: str,
        resource: str = DATALAKE_RESOURCE,
        transport: Optional[Callable[[str, dict], dict]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.tenant_id = tenant_id
        self.client_id = client_id
        self._client_secret = client_secret
        self.resource = resource
        self.transport = transport or urllib_transport
        self.clock = clock

    def acquire(self) -> Token:
        url = f"{LOGIN_BASE}/{self.tenant_id}/oauth2/token"
        reply = self.transport(url, {
            "grant_type": "client_credentials",
            "client_id": self.client_id,
            "client_secret": self._client_secret,
            "resource": self.resource,
        })
        if "access_token" not in reply:
            # surface AAD's own code (invalid_client, unauthorized_client,
            # ...) — but never the secret
            raise PermissionError(
                "service-principal token request failed: "
                f"{reply.get('error', 'no access_token in reply')}: "
                f"{str(reply.get('error_description', ''))[:200]}"
            )
        return Token(
            reply["access_token"],
            self.clock() + float(reply.get("expires_in", 3600)),
        )


class DeviceCodeFlow:
    """Interactive device-code grant (the reference's ``interactive=True``).

    ``prompt`` receives the human instruction ("go to <url>, enter
    <code>"); polling then follows the protocol: ``authorization_pending``
    -> keep polling, ``slow_down`` -> add 5s to the interval,
    ``expired_token``/``access_denied`` -> abort. ``sleep`` is injectable
    so tests run the whole dance in microseconds.
    """

    def __init__(
        self,
        tenant_id: str = "common",
        client_id: str = DEFAULT_PUBLIC_CLIENT_ID,
        resource: str = DATALAKE_RESOURCE,
        transport: Optional[Callable[[str, dict], dict]] = None,
        prompt: Callable[[str], None] = print,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        timeout_s: float = 900.0,
    ):
        self.tenant_id = tenant_id
        self.client_id = client_id
        self.resource = resource
        self.transport = transport or urllib_transport
        self.prompt = prompt
        self.sleep = sleep
        self.clock = clock
        self.timeout_s = timeout_s

    def acquire(self) -> Token:
        base = f"{LOGIN_BASE}/{self.tenant_id}/oauth2"
        dev = self.transport(f"{base}/devicecode", {
            "client_id": self.client_id,
            "resource": self.resource,
        })
        if "device_code" not in dev:
            raise PermissionError(
                f"device-code request failed: {dev.get('error', dev)}"
            )
        self.prompt(
            dev.get("message")
            or f"To sign in, visit {dev.get('verification_url')} and enter "
               f"the code {dev.get('user_code')}"
        )
        interval = float(dev.get("interval", 5))
        deadline = self.clock() + min(
            self.timeout_s, float(dev.get("expires_in", self.timeout_s))
        )
        while True:
            if self.clock() >= deadline:
                raise TimeoutError(
                    "device-code sign-in not completed before the code expired"
                )
            reply = self.transport(f"{base}/token", {
                "grant_type": "urn:ietf:params:oauth:grant-type:device_code",
                "client_id": self.client_id,
                "code": dev["device_code"],
            })
            if "access_token" in reply:
                return Token(
                    reply["access_token"],
                    self.clock() + float(reply.get("expires_in", 3600)),
                )
            error = reply.get("error")
            if error == "authorization_pending":
                pass
            elif error == "slow_down":
                interval += 5.0
            else:  # expired_token, access_denied, bad client, ...
                raise PermissionError(
                    f"device-code sign-in failed: {error}: "
                    f"{str(reply.get('error_description', ''))[:200]}"
                )
            self.sleep(interval)


class LakeCredential:
    """A caching credential over either flow.

    ``get_token()`` returns a live access token, re-acquiring through the
    flow when the cached one is within ``REFRESH_SKEW_S`` of expiry;
    ``headers()`` is the ready-to-send Authorization header for any
    remote-lake transport.
    """

    def __init__(self, flow, clock: Callable[[], float] = time.monotonic):
        self.flow = flow
        self.clock = clock
        self._token: Optional[Token] = None
        # staging worker threads share one credential; without the lock,
        # concurrent callers seeing an expired token would each run the
        # flow (and a DeviceCodeFlow would prompt the operator twice)
        self._lock = threading.Lock()

    def get_token(self) -> str:
        with self._lock:
            if self._token is None or self._token.expired(self.clock()):
                refreshing = self._token is not None
                self._token = self.flow.acquire()
                if refreshing:
                    logger.info("lake credential refreshed before expiry")
            return self._token.access_token

    def headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self.get_token()}"}


def credential_from_config(
    interactive: bool = False,
    dl_service_auth_str: Optional[str] = None,
    transport: Optional[Callable[[str, dict], dict]] = None,
    **flow_kwargs,
) -> Optional[LakeCredential]:
    """Reference-config kwargs -> credential (or None when auth is off).

    Service-principal wins when both are configured, matching the
    reference's preference for non-interactive auth in pods; builder pods
    have no operator at a keyboard.
    """
    if dl_service_auth_str:
        parts = parse_service_auth_str(dl_service_auth_str)
        return LakeCredential(
            ServicePrincipalFlow(transport=transport, **parts, **flow_kwargs)
        )
    if interactive:
        # tenant/client default to the public device-code client, so bare
        # reference-era ``interactive: true`` configs construct (and
        # round-trip through the serializer) without flow_kwargs
        return LakeCredential(DeviceCodeFlow(transport=transport, **flow_kwargs))
    return None
