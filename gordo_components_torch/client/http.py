"""A small HTTP/1.1 client on asyncio streams, for the bulk client.

The JAX client rides ``aiohttp.ClientSession`` with a ``TCPConnector`` or a
``UnixConnector``; the port's runs on machines without aiohttp, so this
module stands in for the part of it the client uses:

- :class:`Session`: one keep-alive pool a session, keyed by address (host
  and port, or a Unix socket path), and at most ``limit`` requests on the
  wire at once (the connector's ``limit``); ``timeout`` bounds each
  request whole, as ``ClientTimeout(total=...)`` does;
- bodies by ``Content-Length``, answers by ``Content-Length``, chunked
  transfer, or to the end of the connection (an HTTP/1.0 server such as
  ``http.server``'s); ``Content-Encoding: gzip`` (and deflate) answers are
  decoded, as aiohttp decodes them;
- :class:`Response`: the status, the headers (case-insensitive), the
  content type and the whole body, read before the request returns.

A request cancelled while on the wire (the loser of a hedge, a spent
deadline) closes its socket and never returns it to the pool, so no
half-read answer can reach the next request. A socket is pooled only
after its whole answer was read and the server kept it open. A pooled
socket the server closed while idle fails its next request before any
answer byte arrives; that request goes once more on a new socket.

Errors follow aiohttp's classes: :class:`ClientConnectionError` (refused,
reset, closed mid-answer, a Unix socket path that is gone) and
:class:`ClientResponseError` (raised by callers for statuses they retry,
and by :meth:`Response.json` for a body that is not JSON), both
:class:`ClientError`; a request past its ``timeout`` raises
``asyncio.TimeoutError``.
"""

import asyncio
import gzip
import json as _json
import re
import zlib
from collections import deque
from typing import Any, Deque, Dict, Iterable, Optional, Tuple
from urllib.parse import urlencode, urlsplit

__all__ = [
    "ClientConnectionError",
    "ClientError",
    "ClientResponseError",
    "Headers",
    "Response",
    "ServerDisconnectedError",
    "Session",
]

_JSON_TYPE = re.compile(r"^application/(?:[\w.+-]+?\+)?json")  # aiohttp's test of a JSON body
_MAX_HEADER_LINES = 256


class ClientError(Exception):
    """Base of the client's errors."""


class ClientConnectionError(ClientError):
    """The connection failed: refused, reset, or closed mid-answer."""


class ServerDisconnectedError(ClientConnectionError):
    """The server closed the connection before its answer began."""


class ClientResponseError(ClientError):
    """An answer its caller treats as an error (``status``, ``message``,
    ``headers``), worded as aiohttp words it."""

    def __init__(self, status: int, message: str = "", headers: Optional["Headers"] = None, url: str = ""):
        super().__init__(f"{status}, message={message!r}, url={url!r}")
        self.status = status
        self.message = message
        self.headers = headers
        self.url = url


class Headers(dict):
    """Header fields keyed case-insensitively; a repeated field's values
    are joined with ``", "``."""

    def __init__(self, items: Iterable[Tuple[str, str]] = ()):
        super().__init__()
        for key, value in items:
            key = key.lower()
            super().__setitem__(key, f"{super().get(key)}, {value}" if key in self else value)

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(key.lower())

    def __contains__(self, key) -> bool:
        return super().__contains__(key.lower())

    def get(self, key: str, default=None):
        return super().get(key.lower(), default)


class Response:
    """A whole answer: ``status``, ``headers``, ``content_type`` and the
    decoded body (:meth:`read`, :meth:`text`, :meth:`json`)."""

    __slots__ = ("status", "headers", "url", "_body")

    def __init__(self, status: int, headers: Headers, body: bytes, url: str):
        self.status = status
        self.headers = headers
        self.url = url
        self._body = body

    @property
    def content_type(self) -> str:
        """The media type without parameters, ``application/octet-stream``
        when the answer names none (aiohttp's default)."""
        raw = self.headers.get("Content-Type", "")
        return raw.split(";", 1)[0].strip().lower() or "application/octet-stream"

    @property
    def charset(self) -> Optional[str]:
        for param in self.headers.get("Content-Type", "").split(";")[1:]:
            key, _, value = param.partition("=")
            if key.strip().lower() == "charset":
                return value.strip().strip('"') or None
        return None

    def read(self) -> bytes:
        return self._body

    def text(self) -> str:
        return self._body.decode(self.charset or "utf-8", "replace")

    def json(self) -> Any:
        """The body as JSON; None for an empty body. A body of another
        content type raises :class:`ClientResponseError`, as aiohttp's
        ``ContentTypeError`` does."""
        if not _JSON_TYPE.match(self.content_type):
            raise ClientResponseError(
                self.status, f"Attempt to decode JSON with unexpected mimetype: {self.content_type}",
                self.headers, self.url)
        text = self.text().strip()
        return _json.loads(text) if text else None


class _Conn:
    __slots__ = ("reader", "writer")

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    def usable(self) -> bool:
        return not (self.writer.is_closing() or self.reader.at_eof())

    def close(self) -> None:
        self.writer.close()


class _NoAnswer(Exception):
    """The connection ended before the first byte of an answer."""


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    line = await reader.readline()
    if not line.endswith(b"\n"):
        raise asyncio.IncompleteReadError(line, None)
    return line


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    parts = []
    while True:
        size = int((await _read_line(reader)).split(b";", 1)[0].strip(), 16)
        if size == 0:
            while (await _read_line(reader)).strip():  # trailer fields, then the blank line
                pass
            return b"".join(parts)
        parts.append(await reader.readexactly(size))
        await reader.readexactly(2)  # the chunk's CRLF


async def _read_answer(reader: asyncio.StreamReader, method: str, url: str) -> Tuple[Response, bool]:
    """(the answer, whether the connection may carry another request)."""
    line = await reader.readline()
    if not line:
        raise _NoAnswer()
    try:
        version, status = line.decode("latin-1").split(" ", 2)[:2]
        status = int(status)
    except ValueError:
        raise ClientConnectionError(f"malformed status line {line[:100]!r} from {url}") from None
    fields = []
    while True:
        raw = await _read_line(reader)
        if raw in (b"\r\n", b"\n"):
            break
        if len(fields) >= _MAX_HEADER_LINES:
            raise ClientConnectionError(f"more than {_MAX_HEADER_LINES} header lines from {url}")
        key, _, value = raw.decode("latin-1").partition(":")
        fields.append((key.strip(), value.strip()))
    headers = Headers(fields)
    connection = headers.get("Connection", "").lower()
    keep = "close" not in connection if version == "HTTP/1.1" else "keep-alive" in connection
    if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
        body = b""
    elif "chunked" in headers.get("Transfer-Encoding", "").lower():
        body = await _read_chunked(reader)
    elif "Content-Length" in headers:
        body = await reader.readexactly(int(headers["Content-Length"]))
    else:
        body = await reader.read()
        keep = False
    coding = headers.get("Content-Encoding", "").lower()
    if coding == "gzip":
        body = gzip.decompress(body)
    elif coding == "deflate":  # zlib's format, or raw deflate as some servers send it (aiohttp reads both)
        try:
            body = zlib.decompress(body)
        except zlib.error:
            body = zlib.decompress(body, -zlib.MAX_WBITS)
    return Response(status, headers, body, url), keep


class Session:
    """A keep-alive HTTP/1.1 client session (the part of
    ``aiohttp.ClientSession`` the bulk client uses).

    ``limit``: requests on the wire at once, and idle sockets kept an
    address; ``timeout``: seconds a request may take whole;
    ``unix_path``: send every request to this Unix socket (the URL's path
    and ``Host`` still travel, as with ``aiohttp.UnixConnector``)."""

    def __init__(self, *, limit: int = 100, timeout: float = 600.0, unix_path: Optional[str] = None):
        self.limit = int(limit)
        self.timeout = timeout
        self.unix_path = unix_path
        self._sem = asyncio.Semaphore(self.limit)
        self._idle: Dict[Tuple, Deque[_Conn]] = {}
        self._closed = False

    async def __aenter__(self) -> "Session":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        """Close the idle sockets; a request still on the wire closes its
        own when it ends."""
        self._closed = True
        for pool in self._idle.values():
            while pool:
                pool.popleft().close()
        self._idle.clear()

    async def get(self, url: str, **kwargs) -> Response:
        return await self.request("GET", url, **kwargs)

    async def post(self, url: str, **kwargs) -> Response:
        return await self.request("POST", url, **kwargs)

    async def request(self, method: str, url: str, *, data: Optional[bytes] = None, json: Any = None,
                      headers: Optional[Dict[str, str]] = None,
                      params: Optional[Dict[str, str]] = None) -> Response:
        """Send one request and read its whole answer."""
        if self._closed:
            raise RuntimeError("Session is closed")
        if json is not None and data is not None:
            raise ValueError("data and json parameters can not be used at the same time")
        send_headers = dict(headers or {})
        if json is not None:
            data = _json.dumps(json).encode("utf-8")
            send_headers.setdefault("Content-Type", "application/json")
        return await asyncio.wait_for(
            self._request(method.upper(), url, data, send_headers, params), self.timeout)

    def _target(self, url: str, params) -> Tuple[Tuple, str, str, bytes]:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported URL scheme {parts.scheme!r}: {url}")
        target = parts.path or "/"
        query = parts.query
        if params:
            query = f"{query}&{urlencode(params)}" if query else urlencode(params)
        if query:
            target = f"{target}?{query}"
        port = parts.port or (443 if parts.scheme == "https" else 80)
        key = ("unix", self.unix_path) if self.unix_path else (parts.scheme, parts.hostname, port)
        return key, parts.netloc, target, parts.scheme

    async def _open(self, key) -> _Conn:
        try:
            if key[0] == "unix":
                reader, writer = await asyncio.open_unix_connection(key[1])
            else:
                reader, writer = await asyncio.open_connection(key[1], key[2], ssl=key[0] == "https" or None)
        except OSError as exc:
            raise ClientConnectionError(f"Cannot connect to {key[1]}:{key[2]} [{exc}]"
                                        if key[0] != "unix" else f"Cannot connect to unix socket {key[1]} [{exc}]"
                                        ) from exc
        return _Conn(reader, writer)

    def _release(self, key, conn: _Conn) -> None:
        pool = self._idle.setdefault(key, deque())
        if self._closed or len(pool) >= self.limit or not conn.usable():
            conn.close()
        else:
            pool.append(conn)

    async def _request(self, method: str, url: str, data: Optional[bytes], headers: Dict[str, str],
                       params) -> Response:
        key, netloc, target, _ = self._target(url, params)
        lines = [f"{method} {target} HTTP/1.1", f"Host: {netloc}"]
        given = {k.lower() for k in headers}
        if "accept" not in given:
            lines.append("Accept: */*")
        if "accept-encoding" not in given:
            lines.append("Accept-Encoding: gzip, deflate")
        lines.extend(f"{k}: {v}" for k, v in headers.items() if k.lower() != "content-length")
        body = data or b""
        if data is not None or method in ("POST", "PUT", "PATCH"):
            lines.append(f"Content-Length: {len(body)}")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        async with self._sem:
            for _ in range(2):
                pool = self._idle.get(key)
                conn = None
                while pool and conn is None:
                    conn = pool.popleft()
                    if not conn.usable():
                        conn.close()
                        conn = None
                reused = conn is not None
                if conn is None:
                    conn = await self._open(key)
                keep = False
                try:
                    conn.writer.write(head)
                    conn.writer.write(body)
                    await conn.writer.drain()
                    resp, keep = await _read_answer(conn.reader, method, url)
                    return resp
                except _NoAnswer:
                    if reused:
                        continue  # the server closed the idle socket: once more on a new one
                    raise ServerDisconnectedError(f"Server disconnected ({url})") from None
                except (OSError, asyncio.IncompleteReadError, EOFError, zlib.error) as exc:
                    if reused and isinstance(exc, (ConnectionResetError, BrokenPipeError)):
                        continue
                    raise ClientConnectionError(f"{type(exc).__name__}: {exc} ({url})") from exc
                finally:
                    if keep:
                        self._release(key, conn)
                    else:
                        conn.close()
        raise ServerDisconnectedError(f"Server disconnected ({url})")
