"""Local fleet-DAG scheduler: execute build -> bucket -> place -> canary
-> promote against a live serving fleet.

Counterpart of ``gordo_components_tpu/workflow/executor.py``: the same
steps, state file, events and counters. Builds run on ``device`` (the
card unless the caller asks for the CPU), and the control plane's HTTP
goes over urllib with the JAX timeouts.

Where the reference handed its generated Argo Workflow to a cluster
scheduler, this executes the compiled :class:`FleetDAG` in-process,
reusing the substrate the repo already ships instead of inventing a new
deployment path:

- **build** steps run through :func:`builder.fleet_build.build_fleet` —
  gang training, register-cache hits, bounded-retry isolation, and
  the partial-build manifest (one poisoned machine degrades its bucket,
  never the run);
- **place** steps compute the member -> replica assignment and evaluate
  :func:`placement.planner.plan_fleet` over the fleet's observed loads
  and health (the cross-replica planner, demoted to advisor when
  the fleet is a single replica);
- **canary** steps land the new generation on the traffic slice through
  the server's ``POST /reload`` — the zero-downtime double-buffered
  swap, so the landing itself has no 5xx window — then judge it with
  workflow/canary.py on ``GET /slo`` burn state and goodput deltas, and
  **auto-rollback** (restore incumbent artifacts + swap again) on fast
  burn, goodput regression, or any mid-canary exception (the
  ``workflow.canary`` chaos site fires inside the judge poll loop);
- **promote** steps land the remaining replicas and record the
  promotion.

Execution is incremental: every step's content key (workflow/dag.py) is
recorded in ``<state_dir>/fleet_state.json`` on success, and a re-run
executes only the stale subgraph — editing one machine in a 100k-member
spec re-runs that machine's build, its bucket, and the rollout tail,
with everything else served from state. A canary verdict of *no signal*
(zero-traffic window) records the step as ``held``: neither promoted nor
rolled back, and deliberately NOT cached, so the next run re-judges over
a fresh window.
"""

import json
import logging
import math
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from gordo_components_torch.gameday.gate import json_request
from gordo_components_torch.observability import get_registry
from gordo_components_torch.observability.events import get_event_log
from gordo_components_torch.workflow.canary import (
    NO_SIGNAL,
    PROMOTE,
    ROLLBACK,
    CanaryConfig,
    CanaryHistory,
    CanarySignal,
    CanaryVerdict,
    _FP_CANARY,
    judge_canary_window,
    signal_delta,
    slo_fast_burn,
)
from gordo_components_torch.workflow.config import Machine
from gordo_components_torch.workflow.dag import FleetDAG

logger = logging.getLogger(__name__)

STATE_SCHEMA = "gordo.fleet-run.state/v1"
_CACHEABLE = ("ok",)  # statuses a later run may reuse


def _fleet_counters():
    reg = get_registry()
    return {
        "steps": reg.counter(
            "gordo_fleet_steps_total",
            "Fleet-DAG steps by kind and terminal status",
            ("kind", "status"),
        ),
        "verdicts": reg.counter(
            "gordo_fleet_canary_verdicts_total",
            "Canary judge verdicts", ("decision",),
        ),
        "rollbacks": reg.counter(
            "gordo_fleet_rollbacks_total",
            "Canary auto-rollbacks (fast burn, goodput regression, or "
            "mid-canary failure)",
        ),
    }


class FleetExecutor:
    """Execute one compiled :class:`FleetDAG`, incrementally.

    ``replicas`` is the serving fleet: a list of ``(base_url,
    collection_dir)`` pairs — the URL is where ``/reload``, ``/slo`` and
    ``/healthz`` live, the directory is the collection that replica
    serves (a generation lands by staging artifacts there and POSTing
    ``/reload``). ``server_url``/``collection_dir`` are the single-replica
    shorthand. With NO replicas the executor runs in plan-only mode:
    builds and bucket manifests are real, place/canary/promote record
    their plans without touching a server (the compile-side smoke path
    bench and the offline tests use).

    ``traffic_hook``, if given, is called as ``hook(base_url)`` on every
    canary poll — a convenience for demos/tests that want scoring
    traffic in the judge window without managing their own thread.

    ``device`` is where the builds train and score: ``"cuda"`` (the
    default) or ``"cpu"``, as every entry point of the port takes it.
    """

    def __init__(
        self,
        dag: FleetDAG,
        state_dir: str,
        server_url: Optional[str] = None,
        collection_dir: Optional[str] = None,
        replicas: Optional[Sequence[Tuple[str, str]]] = None,
        project: Optional[str] = None,
        register_dir: Optional[str] = None,
        canary: Optional[CanaryConfig] = None,
        traffic_hook: Optional[Callable[[str], None]] = None,
        http_timeout: float = 30.0,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        gang_state_dir: Optional[str] = None,
        device="cuda",
    ):
        self.dag = dag
        self.device = device
        self.state_dir = os.path.abspath(
            state_dir or os.environ.get("GORDO_FLEET_STATE_DIR", ".fleet-state")
        )
        self.project = project or dag.project
        if replicas is None:
            if server_url is not None:
                if not collection_dir:
                    raise ValueError(
                        "server_url requires collection_dir (where that "
                        "server's artifacts live)"
                    )
                replicas = [(server_url.rstrip("/"), collection_dir)]
            else:
                replicas = []
        self.replicas: List[Tuple[str, str]] = [
            (url.rstrip("/"), os.path.abspath(cdir)) for url, cdir in replicas
        ]
        if not self.replicas and (dag.meta.get("fleet") or {}).get(
            "replica_urls"
        ):
            # the spec names replica URLs but the local executor can only
            # land generations where it also knows each replica's
            # collection dir — be loud about running plan-only rather
            # than silently ignoring declared policy
            logger.warning(
                "fleet spec declares replica URLs %s but no (url, "
                "collection_dir) replicas were configured: running "
                "plan-only (builds + placement plan, no canary/promote "
                "landing)",
                (dag.meta["fleet"] or {}).get("replica_urls"),
            )
        self.artifact_dir = os.path.join(self.state_dir, "artifacts")
        self.register_dir = register_dir or os.path.join(self.state_dir, "register")
        # re-resolve the canary policy from the spec's RAW block (only
        # explicitly-set keys): GORDO_FLEET_* env fills the rest at run
        # time without having influenced any compiled step key
        fleet_meta = dag.meta.get("fleet") or {}
        self.canary_config = canary or CanaryConfig.from_spec(
            fleet_meta.get("canary_spec", fleet_meta.get("canary"))
        )
        self.traffic_hook = traffic_hook
        self.http_timeout = http_timeout
        self._sleep = sleep
        self._clock = clock
        self._counters = _fleet_counters()
        self._heartbeat = None
        if gang_state_dir:
            # the fleet run publishes the same heartbeat schema builder
            # gangs do (workflow/gang_state.py), so watchman's existing
            # gang-state aggregation shows rollout phases for free
            from gordo_components_torch.workflow.gang_state import GangHeartbeat

            self._heartbeat = GangHeartbeat(
                gang_state_dir, f"fleet-{self.project}"
            )

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    @property
    def state_path(self) -> str:
        return os.path.join(self.state_dir, "fleet_state.json")

    def load_state(self) -> Dict[str, Any]:
        try:
            with open(self.state_path) as f:
                state = json.load(f)
            if state.get("schema") == STATE_SCHEMA:
                return state
            logger.warning(
                "fleet state at %s has schema %r (want %s); starting fresh",
                self.state_path, state.get("schema"), STATE_SCHEMA,
            )
        except FileNotFoundError:
            pass
        except Exception:
            logger.warning(
                "unreadable fleet state at %s; starting fresh",
                self.state_path, exc_info=True,
            )
        return {"schema": STATE_SCHEMA, "steps": {}, "generation": 0}

    def _save_state(self, state: Dict[str, Any]) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=2, default=str)
        os.replace(tmp, self.state_path)

    def refit_due(self, state: Optional[Dict[str, Any]] = None) -> bool:
        """Whether the spec's ``schedules.refit_every`` cadence has
        elapsed since the last promotion — the caller's cue to refresh
        the machines' data windows and recompile: the advanced
        ``train_end_date`` changes every build key, so the refit
        re-enters the DAG as an ordinary stale subgraph (warm starts
        come from the builder's checkpoint/register reuse)."""
        every = (self.dag.meta.get("fleet") or {}).get("refit_every_s")
        if not every:
            return False
        state = state if state is not None else self.load_state()
        promoted_at = state.get("promoted_at")
        if promoted_at is None:
            return True
        return (time.time() - float(promoted_at)) >= float(every)

    # ------------------------------------------------------------------ #
    # HTTP (sync; the executor is a control-plane process, not a server)
    # ------------------------------------------------------------------ #

    def _url(self, base: str, endpoint: str) -> str:
        return f"{base}/gordo/v0/{self.project}/{endpoint}"

    def _get_json(self, base: str, endpoint: str) -> Dict[str, Any]:
        return json_request(self._url(base, endpoint), "GET", self.http_timeout)

    def _post_json(self, base: str, endpoint: str) -> Dict[str, Any]:
        return json_request(self._url(base, endpoint), "POST", self.http_timeout)

    def _reload(self, base: str) -> Dict[str, Any]:
        """Land whatever is staged in the replica's collection dir via
        the zero-downtime swap: the replacement bank builds and
        warms off the request path, one generation-pointer flip
        moves serving over, in-flight batches drain on the old bank."""
        return self._post_json(base, "reload")

    # ------------------------------------------------------------------ #
    # run
    # ------------------------------------------------------------------ #

    def run(self) -> Dict[str, Any]:
        t0 = self._clock()
        os.makedirs(self.artifact_dir, exist_ok=True)
        state = self.load_state()
        prev_keys = {
            sid: rec["key"]
            for sid, rec in state["steps"].items()
            if rec.get("status") in _CACHEABLE
        }
        stale = self.dag.stale_steps(prev_keys)
        # a cached build whose artifact vanished from disk is stale no
        # matter what its key says — the state must never outlive bytes
        for step in self.dag.by_kind("build"):
            if step.step_id in stale:
                continue
            rec = state["steps"].get(step.step_id, {})
            artifact = (rec.get("result") or {}).get("artifact")
            if not artifact or not os.path.isdir(artifact):
                stale[step.step_id] = "artifact missing"
        # re-propagate transitively (topo order, so one pass suffices):
        # a build forced stale above must drag its whole dependent chain
        for s in self.dag.order():
            if s.step_id not in stale:
                hit = next((d for d in s.deps if d in stale), None)
                if hit is not None:
                    stale[s.step_id] = f"dep:{hit}"

        report: Dict[str, Any] = {
            "project": self.project,
            "steps": {},
            "executed": [],
            "cached": [],
            "failed": [],
            "blocked": [],
            "canary": None,
            "promoted": False,
            "rolled_back": False,
        }
        status: Dict[str, str] = {}
        built_this_run: Dict[str, Dict[str, Any]] = {}
        if self._heartbeat is not None:
            self._heartbeat.update(
                phase="starting", n_steps=len(self.dag.steps),
                stale=len(stale),
            )

        for step in self.dag.order():
            sid = step.step_id
            if sid not in stale:
                status[sid] = "cached"
                report["cached"].append(sid)
                report["steps"][sid] = {
                    "kind": step.kind, "status": "cached", "key": step.key,
                }
                continue
            blocked_by = [
                d for d in step.deps if status.get(d) in ("failed", "blocked", "held")
            ]
            if blocked_by:
                status[sid] = "blocked"
                report["blocked"].append(sid)
                report["steps"][sid] = {
                    "kind": step.kind, "status": "blocked", "key": step.key,
                    "reason": f"upstream {blocked_by[0]} is "
                              f"{status[blocked_by[0]]}",
                }
                state["steps"].pop(sid, None)
                self._counters["steps"].labels(step.kind, "blocked").inc()
                continue

            handler = getattr(self, f"_exec_{step.kind}")
            try:
                result = handler(step, state, report, built_this_run)
                step_status = result.pop("_status", "ok")
            except Exception as exc:
                logger.error(
                    "fleet step %s FAILED: %s", sid, exc, exc_info=True
                )
                result = {"error": f"{type(exc).__name__}: {exc}"}
                step_status = "failed"
            status[sid] = step_status
            report["steps"][sid] = {
                "kind": step.kind, "status": step_status, "key": step.key,
                "reason": stale.get(sid), **result,
            }
            self._counters["steps"].labels(step.kind, step_status).inc()
            if step_status in _CACHEABLE:
                report["executed"].append(sid)
                state["steps"][sid] = {
                    "key": step.key, "status": step_status,
                    "result": result, "at": time.time(),
                }
            else:
                if step_status == "failed":
                    report["failed"].append(sid)
                # held/failed steps are never served from state: the next
                # run must re-execute them
                state["steps"].pop(sid, None)
            if self._heartbeat is not None:
                self._heartbeat.update(phase=step.kind, step=sid)

        total = len(self.dag.steps)
        report["counts"] = self.dag.counts()
        report["total_steps"] = total
        report["incremental_ratio"] = (
            round(len(report["cached"]) / total, 6) if total else None
        )
        report["generation"] = state.get("generation", 0)
        report["duration_s"] = round(self._clock() - t0, 3)
        state["last_run"] = {
            "at": time.time(),
            "executed": len(report["executed"]),
            "cached": len(report["cached"]),
            "failed": len(report["failed"]),
            "promoted": report["promoted"],
            "rolled_back": report["rolled_back"],
        }
        self._save_state(state)
        # the compiled DAG snapshot lands next to the state: the reviewed
        # artifact this run executed, for the operator and the next diff
        with open(os.path.join(self.state_dir, "fleet_dag.json"), "w") as f:
            f.write(self.dag.to_json())
        if self._heartbeat is not None:
            phase = (
                "done" if not report["failed"]
                else ("partial" if report["executed"] else "failed")
            )
            self._heartbeat.finish(
                phase, executed=len(report["executed"]),
                failed_members=len(report["failed"]),
            )
        return report

    # ------------------------------------------------------------------ #
    # step handlers
    # ------------------------------------------------------------------ #

    def _exec_build(self, step, state, report, built_this_run) -> Dict[str, Any]:
        """Build steps execute as their bucket's gang: the first stale
        member triggers one :func:`build_fleet` over every stale member
        of that bucket (one fleet fit per hparam group), and the
        remaining members find their result here."""
        name = step.payload["machine"]["name"]
        if name not in built_this_run:
            bucket = next(
                b for b in self.dag.by_kind("bucket")
                if step.step_id in b.deps
            )
            self._run_bucket_gang(bucket, state, built_this_run)
        entry = built_this_run[name]
        if entry.get("error"):
            raise RuntimeError(f"build failed: {entry['error']}")
        return {"artifact": entry["artifact"]}

    def _run_bucket_gang(self, bucket_step, state, built_this_run) -> None:
        from gordo_components_torch.builder.fleet_build import build_fleet

        prev = {
            sid: rec["key"]
            for sid, rec in state["steps"].items()
            if rec.get("status") in _CACHEABLE
        }
        stale_members = []
        for dep in bucket_step.deps:
            dstep = self.dag.steps[dep]
            mname = dstep.payload["machine"]["name"]
            rec = state["steps"].get(dep)
            artifact = ((rec or {}).get("result") or {}).get("artifact")
            if (
                prev.get(dep) == dstep.key
                and artifact
                and os.path.isdir(artifact)
            ):
                continue  # the run loop will serve it as cached
            stale_members.append(dstep.payload["machine"])
        machines = []
        for md in stale_members:
            kwargs = dict(
                name=md["name"],
                dataset=dict(md.get("dataset") or {}),
                metadata=dict(md.get("metadata") or {}),
                evaluation=dict(md.get("evaluation") or {}),
            )
            if md.get("model"):
                kwargs["model"] = md["model"]
            machines.append(Machine(**kwargs))
        if not machines:
            return
        logger.info(
            "fleet bucket %s: building %d stale member(s)",
            bucket_step.payload["gang_id"], len(machines),
        )
        results = build_fleet(
            machines,
            self.artifact_dir,
            model_register_dir=self.register_dir,
            device=self.device,
        )
        for m in machines:
            if m.name in results:
                built_this_run[m.name] = {
                    "artifact": os.path.join(self.artifact_dir, m.name)
                }
            else:
                built_this_run[m.name] = {
                    "error": results.failed.get(m.name, "not built")
                }

    def _exec_bucket(self, step, state, report, built_this_run) -> Dict[str, Any]:
        """Assemble the bucket manifest from its member build outcomes —
        the partial-build record (who shipped, who failed) one level up,
        written where the place step and the operator read it."""
        built: Dict[str, str] = {}
        failed: Dict[str, str] = {}
        for dep in step.deps:
            name = self.dag.steps[dep].payload["machine"]["name"]
            entry = built_this_run.get(name)
            if entry is None:  # cached build: artifact from state
                rec = state["steps"].get(dep) or {}
                built[name] = (rec.get("result") or {}).get("artifact", "")
            elif entry.get("error"):
                failed[name] = entry["error"]
            else:
                built[name] = entry["artifact"]
        manifest = {
            "schema": "gordo.fleet-bucket.manifest/v1",
            "gang_id": step.payload["gang_id"],
            "n_features": step.payload["n_features"],
            "devices": step.payload["devices"],
            "built": built,
            "failed": failed,
        }
        bdir = os.path.join(self.state_dir, "buckets")
        os.makedirs(bdir, exist_ok=True)
        with open(
            os.path.join(bdir, f"{step.payload['gang_id']}.json"), "w"
        ) as f:
            json.dump(manifest, f, indent=2)
        if not built:
            raise RuntimeError(
                f"bucket {step.payload['gang_id']}: no member built "
                f"({len(failed)} failed)"
            )
        return {"n_built": len(built), "n_failed": len(failed)}

    def _members_for_rollout(self, state) -> Dict[str, str]:
        """name -> artifact dir for every member whose build is current
        (executed this run or cached) — the generation the rollout tail
        lands."""
        out: Dict[str, str] = {}
        for step in self.dag.by_kind("build"):
            rec = state["steps"].get(step.step_id)
            if rec and rec.get("status") in _CACHEABLE:
                artifact = (rec.get("result") or {}).get("artifact")
                if artifact and os.path.isdir(artifact):
                    out[step.payload["machine"]["name"]] = artifact
        return out

    def _exec_place(self, step, state, report, built_this_run) -> Dict[str, Any]:
        """Member -> replica assignment plus the fleet planner's advisory
        verdict over live loads/health (plan_fleet)."""
        from gordo_components_torch.placement.planner import plan_fleet

        members = sorted(self._members_for_rollout(state))
        if not members:
            raise RuntimeError("no built members to place")
        n = max(1, len(self.replicas) or int(step.payload.get("n_replicas", 1)))
        assignment: Dict[int, List[str]] = {i: [] for i in range(n)}
        for i, name in enumerate(members):
            assignment[i % n].append(name)

        loads: Dict[str, float] = {}
        health: Dict[int, str] = {}
        for idx, (url, _cdir) in enumerate(self.replicas):
            try:
                body = self._get_json(url, "placement")
                for bucket in (body.get("buckets") or {}).values():
                    for mname, rows in (bucket.get("member_rows") or {}).items():
                        loads[mname] = loads.get(mname, 0.0) + float(rows)
                health[idx] = "ok"
            except Exception:
                health[idx] = "unreachable"
        plan = plan_fleet(assignment, loads, replica_health=health or None)
        if plan.should_apply:
            for move in plan.moves:
                if move.member in assignment.get(move.src, ()):
                    assignment[move.src].remove(move.member)
                    assignment[move.dst].append(move.member)
        result = {
            "assignment": {str(k): sorted(v) for k, v in assignment.items()},
            "n_members": len(members),
            "plan": plan.summary(),
        }
        state["placement"] = result["assignment"]
        if not self.replicas:
            # "planned" (not "ok"): a plan-only result must NOT cache —
            # a later run WITH replicas configured has identical step
            # keys (replica wiring is constructor state, not spec
            # content) and must re-execute the rollout tail for real
            # instead of silently serving the dry run from state
            result.update({"_status": "planned", "mode": "plan_only"})
        return result

    # ------------------------------------------------------------------ #
    # canary / promote
    # ------------------------------------------------------------------ #

    def _canary_replica_count(self) -> int:
        return max(
            1,
            math.ceil(self.canary_config.traffic_slice * len(self.replicas)),
        )

    @staticmethod
    def _backup_marker(backup_dir: str, name: str) -> str:
        return os.path.join(backup_dir, f"{name}.backed")

    def _land_replica(
        self, url: str, cdir: str, members: Dict[str, str],
        backup_dir: Optional[str],
    ) -> Dict[str, Any]:
        """Stage ``members``' artifacts into one replica's collection dir
        (incumbent dirs saved to ``backup_dir`` first) and swap via
        ``/reload``.

        The backup is PER-MEMBER idempotent via a ``<name>.backed``
        marker written after the member's incumbent is snapshotted (or
        noted absent) and strictly BEFORE its collection dir is
        replaced. A re-landing of the same generation — a held canary
        re-judged on the next run, or a retry after a mid-loop crash —
        skips marked members, so the canary's own bytes can never
        overwrite the only copy of the true incumbent, no matter where
        a previous attempt stopped."""
        for name, src in sorted(members.items()):
            dst = os.path.join(cdir, name)
            if backup_dir is not None:
                marker = self._backup_marker(backup_dir, name)
                if not os.path.exists(marker):
                    if os.path.isdir(dst):
                        saved = os.path.join(backup_dir, name)
                        if os.path.isdir(saved):
                            shutil.rmtree(saved)
                        shutil.copytree(dst, saved)
                    # marker exists == backup valid (an absent saved dir
                    # then means "member had no incumbent")
                    with open(marker, "w") as f:
                        f.write("incumbent snapshot complete\n")
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            shutil.copytree(src, dst)
        return self._reload(url)

    def _restore_replica(
        self, url: str, cdir: str, members: Dict[str, str], backup_dir: str
    ) -> None:
        """Rollback: put the incumbent bytes back and swap again — the
        same zero-downtime primitive, pointed backwards. Only members
        whose backup marker exists are touched (an unmarked member was
        never landed, so its collection dir is already the incumbent);
        marked members without a saved dir had no incumbent (new in
        this generation) and are removed."""
        for name in sorted(members):
            if not os.path.exists(self._backup_marker(backup_dir, name)):
                continue
            dst = os.path.join(cdir, name)
            saved = os.path.join(backup_dir, name)
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            if os.path.isdir(saved):
                shutil.copytree(saved, dst)
        self._reload(url)

    def _rollback_landed(
        self, landed: List[Tuple[str, str, Dict[str, str], str]]
    ) -> List[str]:
        """Restore every landed replica's incumbent, with per-replica
        isolation (one failed restore must not strand the rest of the
        slice on the condemned generation). Returns the URLs whose
        restore FAILED — those replicas still hold canary bytes and the
        caller must report the rollback as incomplete."""
        failures: List[str] = []
        for url, cdir, slice_members, backup in landed:
            try:
                self._restore_replica(url, cdir, slice_members, backup)
            except Exception:
                failures.append(url)
                logger.error(
                    "canary rollback of %s FAILED (replica still holds "
                    "the condemned generation's bytes; restore manually "
                    "from %s and POST /reload)", url, backup, exc_info=True,
                )
        return failures

    def _sample_signal(self, url: str) -> Tuple[CanarySignal, Dict[str, Any]]:
        body = self._get_json(url, "slo?refresh=1")
        return CanarySignal.from_goodput_snapshot(body.get("goodput")), body

    def _exec_canary(self, step, state, report, built_this_run) -> Dict[str, Any]:
        cfg = self.canary_config
        members = self._members_for_rollout(state)
        if not self.replicas:
            verdict = CanaryVerdict(
                PROMOTE, "plan-only run (no replicas configured)", {}
            )
            report["canary"] = verdict.to_dict()
            return {
                "_status": "planned",
                "verdict": verdict.to_dict(),
                "mode": "plan_only",
            }

        n_canary = self._canary_replica_count()
        slice_replicas = self.replicas[:n_canary]
        assignment = state.get("placement") or {}
        backup_root = os.path.join(
            self.state_dir, "incumbent", f"gen{state.get('generation', 0)}"
        )
        landed: List[Tuple[str, str, Dict[str, str], str]] = []
        verdict: Optional[CanaryVerdict] = None
        burning: Optional[str] = None
        try:
            # sample the incumbent BEFORE the slice swaps: its cumulative
            # ratios are the judge's baseline
            baseline, _ = self._sample_signal(slice_replicas[0][0])
            for idx, (url, cdir) in enumerate(slice_replicas):
                names = assignment.get(str(idx)) if assignment else None
                slice_members = (
                    {n: members[n] for n in names if n in members}
                    if names is not None else members
                )
                backup = os.path.join(backup_root, f"replica{idx}")
                os.makedirs(backup, exist_ok=True)
                # tracked BEFORE the landing call: a replica that fails
                # mid-stage (or whose /reload dies) already holds canary
                # bytes, and the rollback below must cover it — the
                # per-member restore markers make restoring a partial
                # landing safe
                landed.append((url, cdir, slice_members, backup))
                self._land_replica(url, cdir, slice_members, backup)
            at_swap, _ = self._sample_signal(slice_replicas[0][0])
            history = CanaryHistory(at_swap)

            deadline = self._clock() + cfg.window_s
            while True:
                _FP_CANARY.fire()
                if self.traffic_hook is not None:
                    self.traffic_hook(slice_replicas[0][0])
                latest, slo_body = self._sample_signal(slice_replicas[0][0])
                hot = slo_fast_burn(slo_body)
                if hot is not None and (
                    signal_delta(at_swap, latest).requests_total
                    < cfg.min_requests
                ):
                    # a burn observed before the canary window carried
                    # traffic is pre-window history (e.g. the burn the
                    # previous generation caused), not evidence against
                    # this canary — recorded as not-burning
                    hot = None
                history.add(self._clock(), latest, hot)
                burn_count, burning = history.consecutive_burning()
                if burn_count >= cfg.burn_polls:
                    # the burn PERSISTED for the required consecutive
                    # polls: stop observing early, the window judge
                    # rolls back on it (one hot poll no longer does)
                    break
                if self._clock() >= deadline:
                    break
                self._sleep(min(cfg.poll_s, max(0.0, deadline - self._clock())))
            verdict = judge_canary_window(baseline, history, cfg)
            report["canary_window"] = history.describe()
        except Exception as exc:
            # ANY mid-canary failure (including the workflow.canary chaos
            # fault) rolls the slice back to the incumbent before the
            # error is recorded: a judging crash must never strand a
            # half-landed generation
            restore_failures = self._rollback_landed(landed)
            if landed:
                # the rollback counter's contract (docs/observability.md)
                # is "restored the incumbent": a failure BEFORE anything
                # landed restored nothing and must not page as one
                self._counters["rollbacks"].inc()
            # honest only if every landed replica actually restored — a
            # replica whose /reload died still serves (or will serve on
            # restart) the condemned bytes, and the operator must know
            report["rolled_back"] = bool(landed) and not restore_failures
            verdict = CanaryVerdict(
                ROLLBACK,
                f"mid-canary failure: {type(exc).__name__}: {exc}",
                {
                    "failure": True,
                    "landed_replicas": len(landed),
                    "restore_failures": restore_failures,
                },
            )
            report["canary"] = verdict.to_dict()
            if landed:
                self._counters["verdicts"].labels(ROLLBACK).inc()
                get_event_log().emit(
                    "fleet.rollback",
                    severity="error",
                    generation=int(state.get("generation", 0)),
                    reason=verdict.reason,
                    restore_failures=restore_failures,
                )
            raise RuntimeError(
                f"canary failed mid-window"
                f"{' (rolled back)' if landed else ' (nothing landed)'}: "
                f"{exc}"
            ) from exc

        self._counters["verdicts"].labels(verdict.decision).inc()
        report["canary"] = verdict.to_dict()
        # verdicts are structured events (process-default log — the
        # executor has no app), so the watchman's /incidents can attribute
        # a rollback to its burn
        get_event_log().emit(
            "canary.verdict",
            severity="warning" if verdict.decision == ROLLBACK else "info",
            generation=int(state.get("generation", 0)),
            decision=verdict.decision,
            reason=verdict.reason,
            samples=history.n_samples,
        )
        if verdict.decision == ROLLBACK:
            restore_failures = self._rollback_landed(landed)
            self._counters["rollbacks"].inc()
            report["rolled_back"] = not restore_failures
            logger.warning("canary ROLLED BACK: %s", verdict.reason)
            get_event_log().emit(
                "fleet.rollback",
                severity="error",
                generation=int(state.get("generation", 0)),
                reason=verdict.reason,
                restore_failures=restore_failures,
            )
            return {
                "_status": "failed",
                "verdict": verdict.to_dict(),
                "restore_failures": restore_failures,
            }
        if verdict.decision == NO_SIGNAL:
            # hold: the canary stays on its slice, unpromoted; the step is
            # NOT cacheable, so the next run re-judges a fresh window
            logger.info("canary HELD (no signal): %s", verdict.reason)
            return {"_status": "held", "verdict": verdict.to_dict()}
        return {
            "verdict": verdict.to_dict(),
            "slice_replicas": [url for url, *_ in landed],
            "backup": backup_root,
        }

    def _exec_gameday(self, step, state, report, built_this_run) -> Dict[str, Any]:
        """Pre-promotion game-day gate (gameday/gate.py): run the
        spec's declared gate-mode drills against the canary replica
        that just served its window. A failed drill fails the step,
        which blocks promote through ordinary dep propagation — the
        same containment shape as a canary rollback, minus the
        rollback (the slice stays landed for triage; the next run
        re-drills because ``failed`` is not cacheable)."""
        from gordo_components_torch.gameday.gate import run_promotion_gate

        scenario_names = step.payload.get("scenarios")
        if not self.replicas:
            return {
                "_status": "planned",
                "mode": "plan_only",
                "scenarios": list(scenario_names or []),
            }
        base_url = self.replicas[0][0]
        doc = run_promotion_gate(
            base_url,
            self.project,
            scenarios=scenario_names,
            traffic=self.traffic_hook,
            http_timeout=self.http_timeout,
        )
        report["gameday_gate"] = doc
        failures = [
            f"{name}: {f}"
            for name, v in doc["scenarios"].items()
            for f in v.get("failures", [])
        ]
        get_event_log().emit(
            "gameday.gate",
            severity="error" if failures else "info",
            generation=int(state.get("generation", 0)),
            scenarios=sorted(doc["scenarios"]),
            passed=bool(doc["passed"]),
            failures=failures,
        )
        if not doc["passed"]:
            logger.warning(
                "gameday gate BLOCKED promotion of %s: %s",
                base_url, "; ".join(failures),
            )
            return {"_status": "failed", "gate": doc, "failures": failures}
        logger.info(
            "gameday gate passed on %s (%s)",
            base_url, ", ".join(sorted(doc["scenarios"])),
        )
        return {"gate": doc}

    def _exec_promote(self, step, state, report, built_this_run) -> Dict[str, Any]:
        members = self._members_for_rollout(state)
        result: Dict[str, Any] = {}
        if not self.replicas:
            # plan-only: nothing landed, so no generation to record —
            # and not cached, so a later live run executes for real
            return {
                "_status": "planned",
                "mode": "plan_only",
                "n_members": len(members),
            }
        else:
            n_canary = self._canary_replica_count()
            rest = self.replicas[n_canary:]
            assignment = state.get("placement") or {}
            backup_root = os.path.join(
                self.state_dir, "incumbent", f"gen{state.get('generation', 0)}"
            )
            swaps = []
            for idx, (url, cdir) in enumerate(rest, start=n_canary):
                names = assignment.get(str(idx)) if assignment else None
                rep_members = (
                    {n: members[n] for n in names if n in members}
                    if names is not None else members
                )
                backup = os.path.join(backup_root, f"replica{idx}")
                os.makedirs(backup, exist_ok=True)
                body = self._land_replica(url, cdir, rep_members, backup)
                swaps.append({"url": url, "swap": body.get("swap")})
            result["promoted_replicas"] = len(self.replicas)
            if swaps:
                result["swaps"] = swaps
        state["generation"] = int(state.get("generation", 0)) + 1
        state["promoted_at"] = time.time()
        report["promoted"] = True
        result["generation"] = state["generation"]
        get_event_log().emit(
            "fleet.promote",
            generation=state["generation"],
            members=len(members),
            replicas=len(self.replicas),
        )
        logger.info(
            "fleet generation %d promoted (%d member(s), %d replica(s))",
            state["generation"], len(members), len(self.replicas),
        )
        return result
