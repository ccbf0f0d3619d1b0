"""Async HTTP helpers of the bulk client, over :mod:`.http`.

Counterpart of ``gordo_components_tpu/client/io.py``, rule for rule; where
the JAX module takes an ``aiohttp.ClientSession`` these take a
:class:`~gordo_components_torch.client.http.Session`. The client's half of
the overload defense:

- retries sleep on decorrelated jitter, so chunks that failed together do
  not retry together;
- a shared :class:`~gordo_components_torch.resilience.retry_budget.RetryBudget`
  gates every retry, capping the re-offered load at ``1 + ratio`` times
  the offered load;
- a :class:`~gordo_components_torch.resilience.deadline.Deadline` is
  stamped on each attempt as ``X-Gordo-Deadline-Ms`` (the budget left, not
  the first one), bounds each attempt, and no sleep runs past it;
- :func:`fetch_json_hedged` re-issues a slow request to a second replica
  after a delay and takes the first success.

408, 429 and 5xx answers are retried; 422 raises
:class:`HttpUnprocessableEntity`; any other 4xx raises ``ValueError`` with
the JAX message. A ``application/x-gordo-tensor`` answer comes back as its
raw bytes.
"""

import asyncio
import logging
import random
from typing import Any, Dict, List, Optional

from gordo_components_torch.client.http import ClientError, ClientResponseError, Session
from gordo_components_torch.resilience.deadline import DEADLINE_HEADER, Deadline, DeadlineExceeded
from gordo_components_torch.resilience.retry_budget import RetryBudget, decorrelated_jitter
from gordo_components_torch.utils.wire import TENSOR_CONTENT_TYPE

__all__ = [
    "HttpUnprocessableEntity",
    "fetch_json",
    "fetch_json_hedged",
    "fetch_metadata_all",
    "retry_after_seconds",
]

logger = logging.getLogger(__name__)


def retry_after_seconds(value: str) -> Optional[float]:
    """Seconds to wait from a ``Retry-After`` value, or None. Both RFC 9110
    forms parse: delta-seconds (``"17"``) and an HTTP-date (``"Wed, 21 Oct
    2015 07:28:00 GMT"``, which proxies send); a date in the past is 0."""
    value = value.strip()
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    from email.utils import parsedate_to_datetime

    try:
        when = parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    from datetime import datetime, timezone

    if when.tzinfo is None:  # a legacy zone-less date
        when = when.replace(tzinfo=timezone.utc)
    return max(0.0, (when - datetime.now(timezone.utc)).total_seconds())


class HttpUnprocessableEntity(Exception):
    """422: the endpoint exists but refused the payload (a retry cannot
    help)."""


async def fetch_metadata_all(
    session: Session,
    base_url: str,
    project: str,
    deadline: float = 10.0,
    digest: bool = False,
) -> Optional[Dict[str, Any]]:
    """The collection server's ``metadata-all`` body in one request (the
    per-target ``digest`` form with ``digest=True``), or None on a non-200,
    a timeout or a body of another shape: callers then fetch each target.
    ``deadline`` (seconds) bounds it, so a foreign endpoint that accepts
    the connection and hangs does not stall the caller."""
    suffix = "?digest=1" if digest else ""

    async def get():
        resp = await session.get(f"{base_url.rstrip('/')}/gordo/v0/{project}/metadata-all{suffix}")
        if resp.status != 200:
            return None
        return resp.json()

    try:
        body = await Deadline(deadline).wait_for(get())
    except (ClientError, asyncio.TimeoutError, ValueError) as exc:
        # ValueError: a malformed 200; DeadlineExceeded is a TimeoutError
        logger.debug("metadata-all fetch failed: %s", exc)
        return None
    if not isinstance(body, dict) or not isinstance(body.get("targets"), dict):
        return None  # a catch-all proxy can answer 200 with any JSON
    return body


async def fetch_json(
    session: Session,
    url: str,
    *,
    method: str = "GET",
    json_payload: Optional[Dict[str, Any]] = None,
    data: Optional[bytes] = None,
    headers: Optional[Dict[str, str]] = None,
    retries: int = 3,
    backoff: float = 0.5,
    backoff_cap: float = 60.0,
    retry_budget: Optional[RetryBudget] = None,
    deadline: Optional[Deadline] = None,
    rng: Optional[random.Random] = None,
) -> Any:
    """GET or POST returning the parsed JSON (or a tensor answer's bytes),
    with bounded retries of transient failures. ``retries`` counts all
    attempts (at least one). ``data`` posts raw bytes with ``headers``
    naming their content type; it excludes ``json_payload``.

    Retry sleeps are decorrelated jitter; a 429's ``Retry-After`` is their
    lower bound (capped at 60 s). ``retry_budget`` refusing a token raises
    the last error at once. ``deadline`` is stamped on each attempt, bounds
    it, ends the loop once spent and caps every sleep. ``rng`` pins the
    jitter for tests."""
    if json_payload is not None and data is not None:
        raise ValueError("pass json_payload or data, not both")
    retries = max(1, int(retries))
    if retry_budget is not None:
        retry_budget.note_request()

    async def attempt_once() -> Any:
        send_headers = headers
        if deadline is not None:
            send_headers = dict(headers or {})
            send_headers[DEADLINE_HEADER] = str(max(1, int(deadline.remaining_ms())))
        resp = await session.request(method, url, json=json_payload, data=data, headers=send_headers)
        if resp.status == 422:
            raise HttpUnprocessableEntity(resp.text())
        if resp.status in (408, 429) or resp.status >= 500:
            raise ClientResponseError(resp.status, resp.text(), resp.headers, url)
        if resp.status >= 400:
            raise ValueError(f"HTTP {resp.status} from {url}: {resp.text()[:500]}")
        if resp.content_type == TENSOR_CONTENT_TYPE:
            return resp.read()  # the caller decodes the frames
        return resp.json()

    last_exc: Optional[Exception] = None
    prev_delay = backoff
    for attempt in range(retries):
        try:
            if deadline is not None:
                if deadline.expired():
                    raise DeadlineExceeded(f"deadline expired before attempt {attempt + 1} to {url}")
                return await deadline.wait_for(attempt_once())
            return await attempt_once()
        except (ClientError, asyncio.TimeoutError) as exc:
            last_exc = exc
            if attempt + 1 >= retries:
                break
            if deadline is not None and deadline.expired():
                break
            if retry_budget is not None and not retry_budget.try_spend():
                logger.warning(
                    "Request %s %s failed (%s); retry budget exhausted — failing fast instead of "
                    "re-offering load", method, url, exc,
                )
                break
            delay = prev_delay = decorrelated_jitter(backoff, prev_delay, cap=backoff_cap, rng=rng)
            if isinstance(exc, ClientResponseError) and exc.headers is not None and exc.headers.get("Retry-After"):
                hinted = retry_after_seconds(exc.headers["Retry-After"])
                if hinted is not None:
                    delay = max(delay, min(hinted, 60.0))
            if deadline is not None:
                delay = min(delay, deadline.remaining_s())
            logger.warning("Request %s %s failed (%s); retry %d/%d in %.1fs",
                           method, url, exc, attempt + 1, retries, delay)
            await asyncio.sleep(delay)
    raise last_exc  # type: ignore[misc]


async def fetch_json_hedged(
    session: Session,
    urls: List[str],
    *,
    hedge_delay_s: float,
    hedge_stats: Optional[Dict[str, int]] = None,
    **kwargs: Any,
) -> Any:
    """Send to ``urls[0]``; if it has not answered within
    ``hedge_delay_s``, send one duplicate to ``urls[1]`` and return the
    first success, cancelling the other (its socket is closed). One URL is
    plain :func:`fetch_json`.

    ``hedge_stats`` counts ``hedges`` and ``hedge_wins``. The hedge gets
    ``retries=1`` and no budget: it is extra offered load and must not
    earn retry tokens. Both failing raises the primary's error."""
    if len(urls) < 2:
        return await fetch_json(session, urls[0], **kwargs)
    primary = asyncio.ensure_future(fetch_json(session, urls[0], **kwargs))
    try:
        return await asyncio.wait_for(asyncio.shield(primary), hedge_delay_s)
    except asyncio.TimeoutError:
        pass  # the primary is still in flight: hedge it
    except BaseException:
        # the primary failed fast, or the caller was cancelled: the
        # shielded task must not run on unawaited
        primary.cancel()
        raise
    if hedge_stats is not None:
        hedge_stats["hedges"] = hedge_stats.get("hedges", 0) + 1
    hedge_kwargs = {**kwargs, "retries": 1, "retry_budget": None}
    hedge = asyncio.ensure_future(fetch_json(session, urls[1], **hedge_kwargs))
    pending = {primary, hedge}
    first_exc: Optional[BaseException] = None
    try:
        while pending:
            done, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
            for task in done:
                exc = task.exception()
                if exc is None:
                    if task is hedge and hedge_stats is not None:
                        hedge_stats["hedge_wins"] = hedge_stats.get("hedge_wins", 0) + 1
                    return task.result()
                if task is primary:
                    first_exc = exc
                else:
                    logger.debug("hedge request to %s failed: %s", urls[1], exc)
                    if first_exc is None:
                        first_exc = exc
    finally:
        for task in pending:  # cancel the loser
            task.cancel()
    raise first_exc  # type: ignore[misc]
