"""Workflow generator: the fleet DAG's Kubernetes manifest view.

Counterpart of ``gordo_components_tpu/workflow/generator.py``. It renders
its own copy of ``templates/tpu-workflow.yaml.j2`` with the standard
library's subset of Jinja2 (``utils/template_subset.py``: strict names,
the trailing newline kept, ``{%-`` stripping, ``indent`` and ``tojson``),
and :data:`DEFAULTS` are the JAX generator's, so both packages render the
same bytes for the same DAG.

Reference parity: gordo_components/workflow/workflow_generator.py +
templates/ — pure in-process templating from normalized machine config
to manifests on stdout.
Where the reference renders an Argo Workflow with one builder pod per
machine, this renders gang-scheduled TPU builder Jobs, one collection
model-server Deployment per project, Ambassador mappings, and a
Watchman deployment.

Since the fleet compiler landed (workflow/compiler.py) there is exactly
ONE fleet-spec format: this module no longer buckets machines itself —
it compiles the spec through :func:`compile_fleet` and renders the
resulting DAG's ``bucket`` steps, so the manifests are a *view of the
same DAG* the local executor runs. A spec that compiles identically
deploys identically, whichever back end executes it; two divergent
fleet-spec formats can never ship.
"""

import json
import os
from typing import Any, Dict, Optional, Union

from gordo_components_torch.workflow.config import NormalizedConfig
from gordo_components_torch.utils.template_subset import Template
from gordo_components_torch.workflow.dag import FleetDAG

_TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "templates")

DEFAULTS: Dict[str, Any] = {
    "namespace": "gordo",
    "builder_image": "gordo-components-tpu/builder:latest",
    "server_image": "gordo-components-tpu/server:latest",
    "tpu_accelerator": "tpu-v5-lite-podslice",
    "tpu_topology": "2x4",
    "server_tpu_topology": "2x4",
    "server_devices": 8,
    "server_replicas": 1,
    "builder_retries": 3,
    # host-staging engine for builder pods (utils/staging.py): gang
    # builders on multi-core k8s hosts want the process pool for the
    # CPU-bound resample/join; "auto" sizes/selects per host
    "load_workers": "auto",
    "load_mode": "auto",
    "artifact_root": "/gordo/models",
    "artifact_pvc": "gordo-models",
    "models_per_gang": 1024,
    "devices_per_gang": 8,
}


def dag_manifest_view(dag: FleetDAG) -> list:
    """The gang context the manifest template renders, read from a
    compiled DAG's ``bucket`` steps (members reconstructed from each
    bucket's ``build`` deps — the DAG is the single source of truth for
    who builds with whom)."""
    out = []
    for bucket in dag.by_kind("bucket"):
        # payload["members"] is the canonical member ORDER — deps are
        # sorted on serialization, so a DAG round-tripped through JSON
        # must render identically to a freshly compiled one
        machines = [
            dag.steps[f"build/{name}"].payload["machine"]
            for name in bucket.payload["members"]
        ]
        payload = {
            "gang_id": bucket.payload["gang_id"],
            "n_features": bucket.payload["n_features"],
            "machines": machines,
        }
        out.append(
            {
                "gang_id": bucket.payload["gang_id"],
                "devices": bucket.payload["devices"],
                # sort_keys: machine dicts reach here insertion-ordered
                # from a fresh compile but key-sorted after a JSON
                # round-trip — canonicalize so both render identically
                "payload_json": json.dumps(payload, default=str, sort_keys=True),
            }
        )
    return out


def generate_workflow(
    config: Union[NormalizedConfig, FleetDAG],
    project_name: str,
    **overrides: Any,
) -> str:
    """Render the full multi-document manifest YAML for a project.

    Accepts either a :class:`NormalizedConfig` (compiled to a
    :class:`FleetDAG` first) or an already-compiled DAG — the manifests
    are the DAG's k8s view either way."""
    if isinstance(config, FleetDAG):
        if "models_per_gang" in overrides or "devices_per_gang" in overrides:
            # a compiled DAG's buckets are fixed — silently rendering the
            # old gang sizing while the caller believes the override took
            # would deploy at the wrong HBM/blast-radius bound
            raise ValueError(
                "models_per_gang/devices_per_gang cannot be overridden "
                "when rendering an already-compiled FleetDAG; recompile "
                "the spec with the override instead"
            )
        dag = config
        # globals.runtime rode into the DAG meta at compile time, so a
        # DAG loaded from fleet_dag.json renders with the same knobs as
        # the original spec
        runtime: Dict[str, Any] = dict(
            (dag.meta.get("fleet") or {}).get("runtime") or {}
        )
    else:
        from gordo_components_torch.workflow.compiler import compile_fleet

        runtime = config.runtime or {}
        # bucket-sizing flows to the compiler ONLY as an explicit CALLER
        # override: FleetSpec itself already resolves the spec's own
        # precedence (fleet.models_per_bucket > globals.runtime >
        # default), so re-injecting runtime here would flip it and make
        # `workflow generate` disagree with `workflow compile`
        compile_kw = {
            k: int(v)
            for k in ("models_per_gang", "devices_per_gang")
            if (v := overrides.get(k)) is not None
        }
        dag = compile_fleet(config, project_name, **compile_kw)
    params = {**DEFAULTS, **runtime, **overrides}
    # staging knobs deploy to EVERY builder pod: a typo here would
    # crashloop the whole fleet at stage time, so fail at generation
    if str(params["load_mode"]) not in ("auto", "thread", "process", "sync"):
        raise ValueError(
            f"load_mode must be auto|thread|process|sync, got {params['load_mode']!r}"
        )
    lw = str(params["load_workers"])
    if lw != "auto" and not lw.isdigit():
        raise ValueError(
            f"load_workers must be 'auto' or an integer, got {params['load_workers']!r}"
        )
    # server_devices lands in every server replica's GORDO_SERVER_DEVICES
    # (and its TPU resource request) — same crashloop blast radius
    if not str(params["server_devices"]).isdigit():
        raise ValueError(
            f"server_devices must be an integer, got {params['server_devices']!r}"
        )
    with open(os.path.join(_TEMPLATE_DIR, "tpu-workflow.yaml.j2"), encoding="utf-8") as f:
        template = Template(f.read())
    gang_ctx = dag_manifest_view(dag)
    # the spec's declared SLO policy (fleet.slo, already validated by the
    # compiler) deploys as every server replica's burn-engine config —
    # the same objectives the canary judge reads back via GET /slo
    fleet_meta = dag.meta.get("fleet") or {}
    slo_objectives = fleet_meta.get("slo_objectives")
    slo_windows = fleet_meta.get("slo_windows")
    return template.render(
        project_name=project_name,
        n_machines=len(dag.by_kind("build")),
        gangs=gang_ctx,
        slo_objectives_json=(
            json.dumps(
                [
                    # quantile must survive the render when declared: a
                    # p99_latency_ms objective with an explicit 0.95
                    # quantile deploys exactly as reviewed, never the
                    # name-derived default
                    {
                        k: o[k]
                        for k in ("name", "target", "quantile")
                        if k in o
                    }
                    for o in slo_objectives
                ],
                sort_keys=True,
            )
            if slo_objectives
            else None
        ),
        slo_windows=(
            ",".join(str(w[0]) for w in slo_windows) if slo_windows else None
        ),
        **{k: v for k, v in params.items() if k not in ("models_per_gang", "devices_per_gang")},
    )
