"""Gang scheduler: machines -> TPU sub-mesh gangs.

Counterpart of ``gordo_components_tpu/workflow/scheduler.py``; its gangs
are the fleet compiler's buckets, so the port compiles the same DAG.

The reference's workflow generator emits one Argo builder pod per machine
(SURVEY.md §1 layer 8). The TPU-native inversion gang-schedules *model
batches onto sub-meshes* (BASELINE.json north star): machines are bucketed
by feature count (vmap homogeneity — SURVEY.md §7 hard part 1) and chunked
into gangs; each gang is one builder job running ``FleetTrainer`` over its
machines on one TPU slice. 10k machines become ~tens of jobs instead of 10k
pods.
"""

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

from gordo_components_torch.workflow.config import Machine


@dataclass
class Gang:
    gang_id: str
    machines: List[Machine]
    n_features: int
    devices: int  # devices requested for this gang's slice

    def machine_names(self) -> List[str]:
        return [m.name for m in self.machines]

    def to_manifest_payload(self) -> Dict[str, Any]:
        """JSON payload mounted into the gang's builder job."""
        return {
            "gang_id": self.gang_id,
            "n_features": self.n_features,
            "machines": [m.to_dict() for m in self.machines],
        }


def _feature_count(machine: Machine) -> int:
    tags = machine.dataset.get("tag_list") or machine.dataset.get("tags") or []
    return len(tags)


def schedule_gangs(
    machines: List[Machine],
    models_per_gang: int = 1024,
    devices_per_gang: int = 8,
) -> List[Gang]:
    """Bucket by feature count, then chunk each bucket into gangs.

    ``models_per_gang`` bounds per-job HBM footprint and blast radius on
    preemption; ``devices_per_gang`` is the slice size each builder job
    requests (the fleet engine shards its models over those devices).
    """
    if models_per_gang < 1 or devices_per_gang < 1:
        raise ValueError("models_per_gang and devices_per_gang must be >= 1")
    buckets: Dict[int, List[Machine]] = {}
    for m in machines:
        buckets.setdefault(_feature_count(m), []).append(m)

    gangs: List[Gang] = []
    for n_features in sorted(buckets):
        bucket = buckets[n_features]
        for i in range(0, len(bucket), models_per_gang):
            chunk = bucket[i : i + models_per_gang]
            gangs.append(
                Gang(
                    gang_id=f"gang-f{n_features}-{i // models_per_gang}",
                    machines=chunk,
                    n_features=n_features,
                    devices=devices_per_gang,
                )
            )
    return gangs
