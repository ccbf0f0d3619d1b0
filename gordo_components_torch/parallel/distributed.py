"""The serving mesh's identity: which replica this process is, and which
members it boots owning.

Counterpart of the serving half of
``gordo_components_tpu/parallel/distributed.py``: :func:`process_member_slice`,
:func:`partition_members`, :class:`MeshIdentity`,
:func:`serving_mesh_identity` and :func:`bootstrap_serving_mesh`. Each
serving replica owns a disjoint partition of the members; the cross-replica
plane is HTTP (the watchman's routing table, the mesh acquire and release
routes), never collectives, because a scoring request needs one replica's
device alone.

``GORDO_MESH_DISTRIBUTED=1`` asks for a process group across the replicas,
whose counterpart is the training half's ``initialize_distributed``
(``torch.distributed``): not ported yet, it raises ``NotImplementedError``
(ROADMAP.md A12b).
"""

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


def process_member_slice(n_members: int, process_id: int, process_count: int) -> Tuple[int, int]:
    """The contiguous ``[start, stop)`` member range of ``process_id`` of
    ``process_count``, balanced to within one member: the first
    ``n_members % process_count`` take one extra."""
    if not 0 <= process_id < process_count:
        raise ValueError(f"process_id {process_id} not in [0, {process_count})")
    base, extra = divmod(n_members, process_count)
    start = process_id * base + min(process_id, extra)
    stop = start + base + (1 if process_id < extra else 0)
    return start, stop


def partition_members(names: Sequence[str], process_id: int, process_count: int) -> List[str]:
    """The member names ``process_id`` owns: its slice of the sorted names,
    so every process computes the same split without communicating."""
    ordered = sorted(names)
    start, stop = process_member_slice(len(ordered), process_id, process_count)
    return ordered[start:stop]


@dataclass(frozen=True)
class MeshIdentity:
    """This serving process's place in the mesh."""

    replica_id: int
    replica_count: int
    coordinator: Optional[str] = None
    distributed: bool = False  # a process group across the replicas is up

    def partition(self, names: Sequence[str]) -> List[str]:
        """The members this replica boots owning; acquire and release
        change its ownership afterwards."""
        return partition_members(names, self.replica_id, self.replica_count)


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None


def serving_mesh_identity(replica_id: Optional[int] = None,
                          replica_count: Optional[int] = None) -> Optional[MeshIdentity]:
    """This process's identity, or None outside mesh mode. Each field is
    the keyword's, else ``GORDO_MESH_REPLICA_ID`` / ``GORDO_MESH_REPLICAS``;
    mesh mode needs both (one without the other raises: the partition
    would be wrong)."""
    if replica_id is None:
        replica_id = _env_int("GORDO_MESH_REPLICA_ID")
    if replica_count is None:
        replica_count = _env_int("GORDO_MESH_REPLICAS")
    if replica_id is None and replica_count is None:
        return None
    if replica_id is None or replica_count is None:
        raise ValueError("mesh mode needs BOTH GORDO_MESH_REPLICA_ID and "
                         f"GORDO_MESH_REPLICAS (got replica_id={replica_id}, replicas={replica_count})")
    if replica_count < 1:
        raise ValueError(f"GORDO_MESH_REPLICAS must be >= 1, got {replica_count}")
    if not 0 <= replica_id < replica_count:
        raise ValueError(f"GORDO_MESH_REPLICA_ID {replica_id} not in [0, {replica_count})")
    return MeshIdentity(replica_id=replica_id, replica_count=replica_count,
                        coordinator=os.environ.get("GORDO_MESH_COORDINATOR") or None)


def bootstrap_serving_mesh(replica_id: Optional[int] = None,
                           replica_count: Optional[int] = None) -> Optional[MeshIdentity]:
    """The serving mesh's start (``build_app`` calls it once): the resolved
    identity, or None outside mesh mode. ``GORDO_MESH_DISTRIBUTED=1`` raises
    ``NotImplementedError``: the process group is the training half's
    ``initialize_distributed``, not ported yet."""
    identity = serving_mesh_identity(replica_id, replica_count)
    if identity is None:
        return None
    if os.environ.get("GORDO_MESH_DISTRIBUTED", "0") in ("1", "true", "yes"):
        raise NotImplementedError(
            "GORDO_MESH_DISTRIBUTED=1: a process group across the serving replicas needs "
            "initialize_distributed over torch.distributed, which is not ported yet (ROADMAP.md A12b)")
    logger.info("serving mesh: replica %d of %d", identity.replica_id, identity.replica_count)
    return identity
