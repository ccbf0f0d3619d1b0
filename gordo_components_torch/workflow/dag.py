"""Typed fleet-deployment DAG.

Counterpart of ``gordo_components_tpu/workflow/dag.py``: the same steps,
content keys and JSON, byte for byte.

The reference's workflow generator fans one declarative fleet spec out
into an Argo Workflow — a dependency DAG of per-machine build pods
(PAPER.md §0–1). This module is the jax_graft inversion's data model:
one :class:`FleetDAG` of typed :class:`Step` nodes

    build/<machine>  ->  bucket/<gang>  ->  place/fleet
                                        ->  canary/fleet  ->  promote/fleet

compiled by workflow/compiler.py and executed by workflow/executor.py.
Structuring the rollout as an explicit dependency DAG (rather than the
seed era's flat manifest list) follows the concurrency-structuring
argument of "Exploring the limits of Concurrency in ML Training on
Google TPUs" (PAPERS.md #3): the schedulable unit is the edge set, not
the job list.

Every step carries a **content-digest key** over exactly the inputs that
determine its work (its payload plus its dependencies' keys). Two
consequences the executor builds on:

- *Determinism*: compiling the same spec twice yields byte-identical
  ``to_json()`` output — the golden-DAG test in tests/test_fleet_compiler.py
  asserts this, and it is what makes the DAG a reviewable artifact.
- *Incremental recompile*: editing one machine's config changes that
  machine's build key, its bucket's key, and the place/canary/promote
  keys downstream — and nothing else. :meth:`FleetDAG.stale_steps`
  computes exactly that subgraph against a previous run's recorded keys,
  so a 100k-member fleet edit re-executes one machine's chain, not the
  fleet.
"""

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

SCHEMA = "gordo.fleet-dag/v1"

# execution phases in dependency order; used only as a deterministic
# tiebreak in topological ordering (edges are the real constraint)
KINDS = ("build", "bucket", "place", "canary", "gameday", "promote")
_KIND_ORDER = {k: i for i, k in enumerate(KINDS)}


def content_key(payload: Any, deps: Iterable[str] = ()) -> str:
    """Content digest of a step's inputs: its canonicalized payload plus
    its dependencies' keys (sorted — dep ORDER is a rendering detail,
    dep CONTENT is an input). 24 hex chars, same width as the build
    register cache keys."""
    doc = {"payload": payload, "deps": sorted(deps)}
    raw = json.dumps(doc, sort_keys=True, default=str, separators=(",", ":"))
    return hashlib.sha256(raw.encode()).hexdigest()[:24]


@dataclass(frozen=True)
class Step:
    """One node: ``step_id`` names it, ``kind`` selects the executor
    handler, ``key`` is the content digest its staleness is judged by,
    ``deps`` are upstream step ids, ``payload`` is the JSON-serializable
    parameter block the handler receives (self-contained: the executor
    never needs the original YAML)."""

    step_id: str
    kind: str
    key: str
    deps: Tuple[str, ...] = ()
    payload: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in _KIND_ORDER:
            raise ValueError(f"unknown step kind {self.kind!r} (expected one of {KINDS})")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.step_id,
            "kind": self.kind,
            "key": self.key,
            "deps": sorted(self.deps),
            "payload": self.payload,
        }


class FleetDAG:
    """An immutable-after-validate dependency DAG of fleet rollout steps."""

    def __init__(
        self,
        steps: Iterable[Step],
        project: str = "fleet",
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.project = project
        self.meta: Dict[str, Any] = dict(meta or {})
        self.steps: Dict[str, Step] = {}
        for step in steps:
            if step.step_id in self.steps:
                raise ValueError(f"duplicate step id {step.step_id!r}")
            self.steps[step.step_id] = step
        for step in self.steps.values():
            for dep in step.deps:
                if dep not in self.steps:
                    raise ValueError(
                        f"step {step.step_id!r} depends on unknown step {dep!r}"
                    )
        self._order = self._toposort()

    # ------------------------------------------------------------------ #
    # structure
    # ------------------------------------------------------------------ #

    def _toposort(self) -> List[str]:
        """Deterministic Kahn topological order: among ready steps, the
        (kind-phase, id) sort breaks ties, so the order is a pure
        function of the DAG's content — never of dict insertion history."""
        indegree = {sid: len(s.deps) for sid, s in self.steps.items()}
        dependents: Dict[str, List[str]] = {sid: [] for sid in self.steps}
        for sid, step in self.steps.items():
            for dep in step.deps:
                dependents[dep].append(sid)
        ready = sorted(
            (sid for sid, n in indegree.items() if n == 0),
            key=self._sort_key,
        )
        out: List[str] = []
        while ready:
            sid = ready.pop(0)
            out.append(sid)
            changed = False
            for nxt in dependents[sid]:
                indegree[nxt] -= 1
                if indegree[nxt] == 0:
                    ready.append(nxt)
                    changed = True
            if changed:
                ready.sort(key=self._sort_key)
        if len(out) != len(self.steps):
            cyclic = sorted(sid for sid in self.steps if sid not in out)
            raise ValueError(f"dependency cycle among steps {cyclic}")
        return out

    def _sort_key(self, sid: str) -> Tuple[int, str]:
        return (_KIND_ORDER[self.steps[sid].kind], sid)

    def order(self) -> List[Step]:
        """Steps in deterministic topological order."""
        return [self.steps[sid] for sid in self._order]

    def by_kind(self, kind: str) -> List[Step]:
        return [s for s in self.order() if s.kind == kind]

    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in KINDS}
        for step in self.steps.values():
            out[step.kind] += 1
        return {k: v for k, v in out.items() if v}

    # ------------------------------------------------------------------ #
    # staleness (incremental recompile)
    # ------------------------------------------------------------------ #

    def stale_steps(self, previous_keys: Mapping[str, str]) -> Dict[str, str]:
        """Which steps must re-execute against a previous run's recorded
        ``step_id -> key`` map, and why: ``"new"`` (no prior record),
        ``"changed"`` (content key differs), or ``"dep:<id>"`` (an input
        step is stale, so this one's cached result describes inputs that
        no longer exist). Everything NOT returned is safely reusable —
        this is the incremental-recompile contract the acceptance test
        asserts by step-key digests."""
        stale: Dict[str, str] = {}
        for step in self.order():
            prior = previous_keys.get(step.step_id)
            if prior is None:
                stale[step.step_id] = "new"
            elif prior != step.key:
                stale[step.step_id] = "changed"
            else:
                for dep in step.deps:
                    if dep in stale:
                        stale[step.step_id] = f"dep:{dep}"
                        break
        return stale

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA,
            "project": self.project,
            "meta": self.meta,
            "counts": self.counts(),
            "steps": [s.to_dict() for s in self.order()],
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        """Deterministic JSON: topo-ordered steps, sorted keys — the
        golden-DAG artifact. Byte-identical for identical specs."""
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True, default=str)

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "FleetDAG":
        if doc.get("schema") != SCHEMA:
            raise ValueError(f"not a {SCHEMA} document (schema={doc.get('schema')!r})")
        steps = [
            Step(
                step_id=s["id"],
                kind=s["kind"],
                key=s["key"],
                deps=tuple(s.get("deps", ())),
                payload=dict(s.get("payload", {})),
            )
            for s in doc.get("steps", ())
        ]
        return cls(steps, project=doc.get("project", "fleet"), meta=doc.get("meta"))

    def keys(self) -> Dict[str, str]:
        """``step_id -> content key`` (what executor state records)."""
        return {sid: s.key for sid, s in self.steps.items()}
