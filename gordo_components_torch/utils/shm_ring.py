"""Shared-memory scoring ring: the transport for a producer on the
server's host (``GORDO_SHM_RING``).

Counterpart of ``gordo_components_tpu/utils/shm_ring.py``, with the same
segment and slot layout, states and envelope, so a ring either package
makes the other reads byte for byte. One named segment
(``multiprocessing.shared_memory``) is a ring of request/response slots.
The producer writes a ``GTNS`` tensor body (``utils/wire.py``) into a slot
once; the server parses it with ``np.frombuffer`` views over the mapped
pages, so the rows cross no socket.

Slot protocol (RPC in place; all integers little-endian)::

    segment := HEADER(64) | slot * SLOTS
    HEADER  := MAGIC(4)=b"GRNG" | VERSION(u8)=1 | pad(3) | SLOTS(u32)
             | SLOT_SIZE(u64)
    slot    := STATE(u32) | pad(4) | REQ_LEN(u64) | RESP_STATUS(u32)
             | pad(4) | RESP_LEN(u64) | pad to 64 | PAYLOAD

    STATE: 0=FREE -> 1=WRITING (producer claimed) -> 2=REQ (request
    ready) -> 3=BUSY (server scoring) -> 4=RESP (response ready) ->
    0=FREE (producer consumed)

A request's payload is a small envelope (target name and endpoint code)
followed by the unmodified ``GTNS`` body: the bytes a TCP or Unix-socket
POST carries. A response's payload is the bytes the HTTP tensor path
answers (status 200: a ``GTNS`` body; errors: the JSON error document
with its status).

Ordering: payload and length words are written before the STATE word
flips (the flip publishes them). One producer process a ring and one
server poll thread: the producer may multiplex many threads over the
ring (slot claims serialize on a lock), but two processes must not share
a producer ring. Polling backs off to ``_IDLE_SLEEP_MAX``, so an idle
ring costs next to nothing.
"""

import contextlib
import struct
import time
from typing import Tuple

from multiprocessing import shared_memory

__all__ = [
    "DEFAULT_SLOTS",
    "DEFAULT_SLOT_MB",
    "ShmRing",
    "ShmRingClient",
    "ShmRingError",
    "pack_envelope",
    "unpack_envelope",
]

RING_MAGIC = b"GRNG"
RING_VERSION = 1
HEADER_SIZE = 64
SLOT_HEADER_SIZE = 64

# slot states
FREE, WRITING, REQ, BUSY, RESP = 0, 1, 2, 3, 4

DEFAULT_SLOTS = 8
DEFAULT_SLOT_MB = 4.0

# endpoint codes in the request envelope
ENDPOINTS = {"prediction": 0, "anomaly": 1}
ENDPOINT_NAMES = {v: k for k, v in ENDPOINTS.items()}

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_U16 = struct.Struct("<H")

# producer/server poll backoff: start hot (a scoring round trip is
# sub-ms), decay to a sleep an idle core doesn't feel
_IDLE_SLEEP_MIN = 20e-6
_IDLE_SLEEP_MAX = 2e-3


class ShmRingError(RuntimeError):
    """Ring-level failure: bad segment layout, timeout, closed ring."""


def pack_envelope(target: str, endpoint: str, body: bytes) -> bytes:
    """Request envelope: what HTTP carries in the URL (target, endpoint)
    prefixed to the unmodified ``GTNS`` body."""
    code = ENDPOINTS.get(endpoint)
    if code is None:
        raise ShmRingError(
            f"endpoint must be one of {sorted(ENDPOINTS)}, got {endpoint!r}"
        )
    name_b = target.encode("utf-8")
    if not 0 < len(name_b) < 65536:
        raise ShmRingError(f"target {target!r} must encode to 1..65535 bytes")
    return _U16.pack(len(name_b)) + name_b + bytes([code]) + body


def unpack_envelope(payload: memoryview) -> Tuple[str, str, memoryview]:
    """-> (target, endpoint, gtns_body_view). The body comes back as a
    VIEW into the mapped segment — the zero-copy handoff to
    ``unpack_frames``."""
    if len(payload) < 3:
        raise ShmRingError("request payload shorter than its envelope")
    (name_len,) = _U16.unpack_from(payload, 0)
    if len(payload) < 2 + name_len + 1:
        raise ShmRingError("request envelope truncated")
    target = bytes(payload[2 : 2 + name_len]).decode("utf-8")
    code = payload[2 + name_len]
    endpoint = ENDPOINT_NAMES.get(code)
    if endpoint is None:
        raise ShmRingError(f"unknown endpoint code {code}")
    return target, endpoint, payload[2 + name_len + 1 :]


# segment names CREATED by this process: an in-process attach (a server
# and its producer in one process) must not untrack them — the creator's unlink() is the
# one legitimate unregister, and a second one makes the tracker complain
_OWNED_NAMES: set = set()


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """Detach this handle from the resource tracker: on 3.10 an ATTACHED
    (create=False) segment still registers (bpo-39959), so a producer
    process exiting would unlink the server's live ring out from under
    it."""
    with contextlib.suppress(Exception):
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001


class ShmRing:
    """One mapped segment, slot accessors shared by both ends."""

    def __init__(
        self, shm: shared_memory.SharedMemory, owner: bool,
        slots: int, slot_size: int,
    ):
        self.shm = shm
        self.owner = owner
        self.slots = int(slots)
        self.slot_size = int(slot_size)
        self.buf: memoryview = shm.buf
        self.payload_max = self.slot_size - SLOT_HEADER_SIZE
        self._closed = False

    # ------------------------------ lifecycle ------------------------- #

    @classmethod
    def create(
        cls,
        name: str,
        slots: int = DEFAULT_SLOTS,
        slot_mb: float = DEFAULT_SLOT_MB,
    ) -> "ShmRing":
        slots = max(1, int(slots))
        slot_size = SLOT_HEADER_SIZE + int(slot_mb * 1024**2)
        size = HEADER_SIZE + slots * slot_size
        try:
            shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        except FileExistsError:
            # an existing segment under this name: almost always a stale
            # ring from a crashed server (nothing unlinked it). Refuse
            # to reclaim a segment that is not a gordo ring at all —
            # that is an operator pointing two unrelated systems at one
            # name — and WARN on reclaim, because create() cannot
            # distinguish "crashed" from "still serving": two servers
            # configured with the same GORDO_SHM_RING would split-brain
            # their producers here (one ring name per server).
            stale = shared_memory.SharedMemory(name=name)
            is_ring = bytes(stale.buf[: len(RING_MAGIC)]) == RING_MAGIC
            stale.close()
            if not is_ring:
                raise ShmRingError(
                    f"segment {name!r} exists and is not a gordo scoring "
                    "ring; refusing to destroy it — pick another "
                    "GORDO_SHM_RING name"
                )
            import logging

            logging.getLogger(__name__).warning(
                "reclaiming existing shm ring %r (stale ring from a "
                "crashed server, or ANOTHER LIVE SERVER sharing the "
                "name — ensure one server per ring)", name,
            )
            stale2 = shared_memory.SharedMemory(name=name)
            stale2.close()
            stale2.unlink()
            shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        buf = shm.buf
        buf[: len(RING_MAGIC)] = RING_MAGIC
        buf[len(RING_MAGIC)] = RING_VERSION
        _U32.pack_into(buf, 8, slots)
        _U64.pack_into(buf, 16, slot_size)
        _OWNED_NAMES.add(shm.name)
        ring = cls(shm, owner=True, slots=slots, slot_size=slot_size)
        for i in range(slots):
            ring.set_state(i, FREE)
        return ring

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        shm = shared_memory.SharedMemory(name=name, create=False)
        if shm.name not in _OWNED_NAMES:
            _untrack(shm)
        buf = shm.buf
        if bytes(buf[: len(RING_MAGIC)]) != RING_MAGIC:
            shm.close()
            raise ShmRingError(f"segment {name!r} is not a gordo scoring ring")
        version = buf[len(RING_MAGIC)]
        if version != RING_VERSION:
            shm.close()
            raise ShmRingError(
                f"ring {name!r} speaks version {version}, this end speaks "
                f"{RING_VERSION}"
            )
        (slots,) = _U32.unpack_from(buf, 8)
        (slot_size,) = _U64.unpack_from(buf, 16)
        return cls(shm, owner=False, slots=slots, slot_size=slot_size)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # release exported views before closing the mapping (lingering
        # np.frombuffer views over slots — e.g. a just-scored request's
        # arrays awaiting gc — would make close() raise BufferError)
        self.buf = None
        import gc

        gc.collect()
        try:
            self.shm.close()
        except BufferError:
            # a scored request's np.frombuffer view is still reachable
            # somewhere (e.g. a not-yet-collected result object): the
            # mapping cannot unmap while it lives. Detach the handle so
            # the stdlib __del__ doesn't retry (and noisily fail) at gc
            # time — the OS reclaims the mapping at process exit, and
            # the segment itself is still unlinked below.
            self.shm._mmap = None  # noqa: SLF001
        if self.owner:
            with contextlib.suppress(Exception):
                self.shm.unlink()
            _OWNED_NAMES.discard(self.shm.name)

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------ slot I/O -------------------------- #

    def _slot_off(self, i: int) -> int:
        return HEADER_SIZE + i * self.slot_size

    def state(self, i: int) -> int:
        return _U32.unpack_from(self.buf, self._slot_off(i))[0]

    def set_state(self, i: int, state: int) -> None:
        _U32.pack_into(self.buf, self._slot_off(i), state)

    def write_request(self, i: int, payload: bytes) -> None:
        """Payload + length first, STATE=REQ last (the publication)."""
        if len(payload) > self.payload_max:
            raise ShmRingError(
                f"request of {len(payload)} bytes exceeds the "
                f"{self.payload_max}-byte slot payload (raise "
                f"GORDO_SHM_SLOT_MB or shrink the chunk)"
            )
        off = self._slot_off(i)
        self.buf[
            off + SLOT_HEADER_SIZE : off + SLOT_HEADER_SIZE + len(payload)
        ] = payload
        _U64.pack_into(self.buf, off + 8, len(payload))
        self.set_state(i, REQ)

    def request_view(self, i: int) -> memoryview:
        off = self._slot_off(i)
        (req_len,) = _U64.unpack_from(self.buf, off + 8)
        if req_len > self.payload_max:
            raise ShmRingError(f"slot {i} declares an oversized request")
        return self.buf[off + SLOT_HEADER_SIZE : off + SLOT_HEADER_SIZE + req_len]

    def write_response(self, i: int, status: int, payload: bytes) -> None:
        off = self._slot_off(i)
        if len(payload) > self.payload_max:
            # can't deliver the real body; deliver a named failure the
            # producer can act on instead of a truncated tensor
            import json

            payload = json.dumps(
                {
                    "error": f"response of {len(payload)} bytes exceeds the "
                    f"{self.payload_max}-byte slot payload "
                    "(raise GORDO_SHM_SLOT_MB or shrink the chunk)"
                }
            ).encode()
            status = 413
        self.buf[
            off + SLOT_HEADER_SIZE : off + SLOT_HEADER_SIZE + len(payload)
        ] = payload
        _U32.pack_into(self.buf, off + 16, status)
        _U64.pack_into(self.buf, off + 24, len(payload))
        self.set_state(i, RESP)

    def read_response(self, i: int) -> Tuple[int, bytes]:
        off = self._slot_off(i)
        (status,) = _U32.unpack_from(self.buf, off + 16)
        (resp_len,) = _U64.unpack_from(self.buf, off + 24)
        if resp_len > self.payload_max:
            raise ShmRingError(f"slot {i} declares an oversized response")
        data = bytes(
            self.buf[off + SLOT_HEADER_SIZE : off + SLOT_HEADER_SIZE + resp_len]
        )
        return status, data


class ShmRingClient:
    """Producer end: claim a slot, write the envelope + ``GTNS`` body,
    spin-wait (with backoff) for the response. Thread-safe within one
    process — concurrent chunks claim different slots and proceed in
    parallel; the claim itself serializes on a short lock."""

    def __init__(self, name: str):
        import threading

        self.ring = ShmRing.attach(name)
        self._claim_lock = threading.Lock()
        # slots whose waiter timed out mid-flight: the server still owns
        # them (flipping FREE under it would race a new writer), so they
        # are reaped here once their late response lands
        self._abandoned: set = set()

    def close(self) -> None:
        self.ring.close()

    def _claim(self, deadline: float) -> int:
        sleep = _IDLE_SLEEP_MIN
        while True:
            with self._claim_lock:
                for i in list(self._abandoned):
                    if self.ring.state(i) == RESP:
                        self.ring.set_state(i, FREE)
                        self._abandoned.discard(i)
                for i in range(self.ring.slots):
                    if self.ring.state(i) == FREE:
                        self.ring.set_state(i, WRITING)
                        return i
            if time.monotonic() >= deadline:
                raise ShmRingError(
                    f"no free slot within the timeout "
                    f"({self.ring.slots} slots all busy)"
                )
            time.sleep(sleep)
            sleep = min(sleep * 2, _IDLE_SLEEP_MAX)

    def request(
        self,
        target: str,
        body: bytes,
        endpoint: str = "anomaly",
        timeout: float = 60.0,
    ) -> Tuple[int, bytes]:
        """One scoring round trip. Returns ``(status, response_bytes)``
        — the exact bytes the HTTP tensor path would have answered."""
        if self.ring.closed:
            raise ShmRingError("ring is closed")
        deadline = time.monotonic() + timeout
        i = self._claim(deadline)
        try:
            self.ring.write_request(i, pack_envelope(target, endpoint, body))
        except Exception:
            self.ring.set_state(i, FREE)
            raise
        sleep = _IDLE_SLEEP_MIN
        while True:
            state = self.ring.state(i)
            if state == RESP:
                break
            if time.monotonic() >= deadline:
                # abandon the slot to the server: it still owns it, so
                # never flip it FREE here (the server would race a new
                # writer) — a later _claim reaps it once RESP lands
                with self._claim_lock:
                    self._abandoned.add(i)
                raise ShmRingError(
                    f"no response within {timeout}s (slot {i} state {state})"
                )
            time.sleep(sleep)
            sleep = min(sleep * 2, _IDLE_SLEEP_MAX)
        try:
            return self.ring.read_response(i)
        finally:
            self.ring.set_state(i, FREE)
