"""Gang state: builder heartbeats on a shared volume.

Counterpart of ``gordo_components_tpu/workflow/gang_state.py``, writing
and reading the same JSON, so either package reads the other's files. The
fleet builder publishes one heartbeat a gang, rewritten atomically through
every phase (starting -> loading -> training -> building -> done, partial
or failed, with the trainer's epoch counters): an operator, or a watchman,
reads the directory and sees a gang that stalled or failed.

File protocol: ``<state_dir>/<gang_id>.json`` with at least ``gang_id``,
``ts`` (unix seconds of the last write), ``phase`` and free-form progress
fields. Writes go through a temporary file and a rename, so a reader never
sees a torn file.
"""

import json
import logging
import os
import socket
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def default_gang_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


class GangHeartbeat:
    """Atomically publishes one gang's progress to ``state_dir``.

    Heartbeats are best-effort: a full state volume or permission error
    must never kill the training job it is reporting on.
    """

    def __init__(self, state_dir: str, gang_id: Optional[str] = None):
        self.state_dir = os.path.abspath(state_dir)
        self.gang_id = gang_id or default_gang_id()
        self._fields: Dict[str, Any] = {}
        self._disabled = False
        try:
            os.makedirs(self.state_dir, exist_ok=True)
        except OSError:
            logger.warning(
                "gang state dir %s not writable; heartbeats disabled",
                self.state_dir,
                exc_info=True,
            )
            self._disabled = True

    @property
    def path(self) -> str:
        return os.path.join(self.state_dir, f"{self.gang_id}.json")

    def update(self, **fields: Any) -> None:
        if self._disabled:
            return
        self._fields.update(fields)
        payload = {
            "gang_id": self.gang_id,
            "ts": time.time(),
            "pid": os.getpid(),
            **self._fields,
        }
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError:
            logger.warning("gang heartbeat write failed (%s)", self.path, exc_info=True)

    def finish(self, status: str = "done", **fields: Any) -> None:
        self.update(phase=status, **fields)


# phases after which a gang is finished and can never be "stale", however
# old its last write: done (all built), failed (nothing built), partial
# (partial manifest shipped — some groups failed, the rest built)
TERMINAL_PHASES = ("done", "failed", "partial")


def read_gang_states(
    state_dir: str, stale_after: float = 120.0
) -> List[Dict[str, Any]]:
    """All gang heartbeats under ``state_dir``, each annotated with
    ``stale`` (no write for ``stale_after`` seconds while not finished) —
    the operator signal for a hung or OOM-killed gang the platform hasn't
    restarted yet."""
    out: List[Dict[str, Any]] = []
    if not os.path.isdir(state_dir):
        return out
    now = time.time()
    for entry in sorted(os.listdir(state_dir)):
        if not entry.endswith(".json"):
            continue
        path = os.path.join(state_dir, entry)
        try:
            with open(path) as f:
                state = json.load(f)
            if not isinstance(state, dict):
                raise ValueError(f"expected a JSON object, got {type(state).__name__}")
            age = now - float(state.get("ts", 0))
            state["age_seconds"] = round(age, 1)
            state["stale"] = bool(
                age > stale_after and state.get("phase") not in TERMINAL_PHASES
            )
        except Exception:
            # a malformed state file (foreign writer, manual edits) must
            # not take the whole watchman snapshot down
            logger.warning("unreadable gang state file %s", path, exc_info=True)
            continue
        out.append(state)
    return out
