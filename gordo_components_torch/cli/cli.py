"""``gordo-components-torch`` command-line interface.

Counterpart of ``gordo_components_tpu/cli/cli.py``, on argparse, with the
same options, environment variables and exit codes:

- ``build``: one model (``provide_saved_model``); 81 when a config does
  not parse (JSON first, then the port's YAML reader), 82 on
  ``ValueError``, ``ImportError`` or ``FileNotFoundError``, 83 on any other
  error;
- ``build-fleet``: a machines file (a list of machines, or
  ``{machines: [...]}``) built by ``build_fleet``, its manifest written to
  ``build_manifest.json`` and printed; 0 when every machine built, 84 when
  some failed, 83 when none built or the build raised, 81 for an empty
  payload;
- ``checkpoint-prune``: delete the fleet checkpoints under
  ``--checkpoint-dir`` untouched for ``--older-than-days`` and print
  ``Pruned N stale checkpoint(s)``;
- ``run-server``: serve a model directory until SIGINT or SIGTERM;
- ``run-watchman``: the fleet-health service over a server
  (``watchman/server.py``) until SIGINT or SIGTERM, with the JAX options:
  ``--project`` (``PROJECT_NAME``), ``--server-base-url``
  (``SERVER_BASE_URL``), ``--targets`` (``TARGET_NAMES``, a JSON list;
  discovered when omitted), ``--gang-state-dir`` (``GANG_STATE_DIR``),
  ``--full-metadata`` (``WATCHMAN_FULL_METADATA``), ``--host`` and
  ``--port`` (5556); a watchman over several replicas is built with
  ``run_watchman(metrics_urls=...)``, as in the JAX package;
- ``client predict START END``: score a time range for every machine of a
  project (or each ``--target``) with :class:`~gordo_components_torch.client.Client`,
  forwarding to ``--parquet-dir``; prints ``k/n machines scored
  successfully``, each failure on stderr, and exits 1 when one failed;
- ``client metadata``: every model's metadata as JSON (``metadata-all``,
  else a request a target);
- ``client download-model TARGET DEST``: the route's bytes written to
  ``DEST`` as they arrive (urllib);
- ``workflow compile``: a fleet spec compiled to the typed DAG's
  deterministic JSON (``compile_fleet``), printed or written to
  ``--output-file``; 81 when the spec does not parse or validate;
- ``workflow generate``: the spec's Kubernetes manifests
  (``generate_workflow``), the JAX generator's bytes; 81 likewise;
- ``workflow run``: a fleet spec compiled and executed by
  :class:`~gordo_components_torch.workflow.FleetExecutor` (build, bucket,
  place, canary, the game-day gate, promote) against the live replicas
  named by ``--server-url`` and ``--collection-dir`` (``SERVER_BASE_URL``,
  ``MODEL_COLLECTION_DIR``; none: a plan-only run), its state in
  ``--state-dir`` (``GORDO_FLEET_STATE_DIR``), its report printed as JSON;
  81 for a spec that does not parse or validate, 84 when some step failed
  and others executed, 83 when every executed step failed. Each of the two
  options may be given once a replica, paired in order (the JAX CLI takes
  one replica); the builds run on ``--device``.

``--device`` (default ``cuda``) is the counterpart of the JAX ``--platform``:
the commands run on the card, and without CUDA they fail through
``resolve_device`` unless ``--device cpu`` asks for the CPU. A set
``GORDO_FAULTS`` arms the fault points before any command runs
(``resilience/faults.py``), and ``--profile-dir`` sets
``GORDO_PROFILE_DIR``, under which builds and traced bank groups write
profiler captures (``utils/profiling.py``). Refused with exit code 2:
``--compile-cache-dir`` (the XLA compile cache has no counterpart in the
port); ``build-fleet --distributed`` exits 83. The client commands,
``workflow compile`` and ``workflow generate`` move no tensor and ignore
``--device``; so does ``run-watchman``.
"""

import argparse
import json
import logging
import os
import signal
import sys
from typing import List, Optional

from gordo_components_torch.utils.yaml_subset import YAMLSubsetError, safe_load

logger = logging.getLogger(__name__)

EXIT_OK = 0
EXIT_CONFIG_ERROR = 81
EXIT_DATA_ERROR = 82
EXIT_BUILD_ERROR = 83
# a partial fleet build: some machines shipped, the failed ones are in the
# manifest (a retry reruns those alone)
EXIT_PARTIAL_BUILD = 84

_TRUE = ("1", "true", "t", "yes", "y", "on")
_FALSE = ("0", "false", "f", "no", "n", "off", "")


def _env(name: str, default=None):
    return os.environ.get(name, default)


def _env_flag(name: str) -> bool:
    value = os.environ.get(name, "").strip().lower()
    if value not in _TRUE + _FALSE:
        raise SystemExit(f"{name}={os.environ[name]!r} is not a boolean")
    return value in _TRUE


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    try:
        return default if value is None else int(value)
    except ValueError:
        raise SystemExit(f"{name}={value!r} is not an integer") from None


def _parser() -> argparse.ArgumentParser:
    """The parser; option defaults read the environment when it is built."""
    p = argparse.ArgumentParser(
        prog="gordo-components-torch",
        description="Build, serve and score fleets of anomaly detectors on an NVIDIA card.")
    p.add_argument("--log-level", default=_env("LOG_LEVEL", "INFO"))
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'; never chosen on its own")
    p.add_argument("--profile-dir", default=_env("GORDO_PROFILE_DIR"),
                   help="write torch.profiler captures of builds and traced bank groups here")
    p.add_argument("--compile-cache-dir", default=_env("GORDO_COMPILE_CACHE_DIR"), help="not ported")
    sub = p.add_subparsers(dest="command", metavar="COMMAND")
    sub.required = True

    b = sub.add_parser("build", help="Build one model (the builder pod's entry point).")
    b.add_argument("--name", default=_env("MACHINE_NAME"))
    b.add_argument("--model-config", default=_env("MODEL_CONFIG"), help="JSON/YAML model definition")
    b.add_argument("--data-config", default=_env("DATA_CONFIG"), help="JSON/YAML dataset config")
    b.add_argument("--metadata", default=_env("METADATA", "{}"))
    b.add_argument("--output-dir", default=_env("OUTPUT_DIR", "./model-output"))
    b.add_argument("--model-register-dir", default=_env("MODEL_REGISTER_DIR"))
    b.add_argument("--evaluation-config", default=_env("EVALUATION_CONFIG", "{}"),
                   help='JSON/YAML evaluation block: {"cv_mode": "full_build"|"cross_val_only", '
                        '"cross_validation": true, "n_splits": 3}')
    b.add_argument("--print-cv-scores", action="store_true")

    f = sub.add_parser("build-fleet", help="Build a gang of machines in one process.")
    f.add_argument("--machines-file", default=_env("MACHINES_FILE"),
                   help="JSON/YAML file: a list of machines or {machines: [...]}")
    f.add_argument("--output-dir", default=_env("OUTPUT_DIR", "./model-output"))
    f.add_argument("--model-register-dir", default=_env("MODEL_REGISTER_DIR"))
    f.add_argument("--checkpoint-dir", default=_env("CHECKPOINT_DIR"),
                   help="Checkpoint fleet training here and resume a preempted gang")
    f.add_argument("--checkpoint-every", type=int, default=_env_int("CHECKPOINT_EVERY", 1),
                   help="Epochs between fleet checkpoints")
    f.add_argument("--distributed", action="store_true", default=_env_flag("GORDO_DISTRIBUTED"),
                   help="not ported")
    f.add_argument("--state-dir", default=_env("GANG_STATE_DIR"),
                   help="Publish the gang's heartbeat (phase and progress) here")
    f.add_argument("--gang-id", default=_env("GANG_ID"), help="Heartbeat identity (default: hostname-pid)")

    k = sub.add_parser("checkpoint-prune", help="Delete stale fleet checkpoints.")
    k.add_argument("--checkpoint-dir", default=_env("CHECKPOINT_DIR"))
    k.add_argument("--older-than-days", type=float, default=7.0,
                   help="Delete bucket checkpoints untouched for this long")

    s = sub.add_parser("run-server", help="Serve the model collection under a directory.")
    s.add_argument("--model-dir", default=_env("MODEL_COLLECTION_DIR"))
    s.add_argument("--host", default=_env("SERVER_HOST", "0.0.0.0"))
    s.add_argument("--port", type=int, default=_env_int("SERVER_PORT", 5555))
    s.add_argument("--devices", type=int, default=_env_int("GORDO_SERVER_DEVICES", None),
                   help="Shard the model bank over an N-device models-axis mesh (0/unset = all available "
                        "devices when more than one is present).")

    wm = sub.add_parser("run-watchman", help="Fleet health aggregation service.")
    wm.add_argument("--project", default=_env("PROJECT_NAME"))
    wm.add_argument("--server-base-url", default=_env("SERVER_BASE_URL"))
    wm.add_argument("--targets", default=_env("TARGET_NAMES"),
                    help="JSON list; discovered from the server when omitted")
    wm.add_argument("--gang-state-dir", default=_env("GANG_STATE_DIR"),
                    help="Aggregate builder-gang heartbeats from this directory")
    wm.add_argument("--full-metadata", action="store_true", default=_env_flag("WATCHMAN_FULL_METADATA"),
                    help="Aggregate FULL per-target metadata instead of the bounded digest")
    wm.add_argument("--host", default="0.0.0.0")
    wm.add_argument("--port", type=int, default=5556)

    c = sub.add_parser("client", help="Bulk prediction client.")
    csub = c.add_subparsers(dest="client_command", metavar="CLIENT_COMMAND")
    csub.required = True
    cp = csub.add_parser("predict", help="Bulk anomaly scoring over a time range.")
    cp.add_argument("start")
    cp.add_argument("end")
    cm = csub.add_parser("metadata", help="Print every model's metadata as JSON.")
    cd = csub.add_parser("download-model", help="Download a model artifact.")
    cd.add_argument("target")
    cd.add_argument("dest")
    for q in (cp, cm, cd):
        q.add_argument("--project", default=_env("PROJECT_NAME"))
        q.add_argument("--base-url", default="http://localhost:5555")
    cp.add_argument("--target", action="append", default=[], help="Limit to specific machines")
    cp.add_argument("--parquet-dir", default=None, help="Forward results to parquet files")
    cp.add_argument("--batch-size", type=int, default=1000)
    cp.add_argument("--body-encoding", default=_env("GORDO_CLIENT_ENCODING", "auto"),
                    help="Scoring POST body encoding (auto, json or parquet): auto negotiates parquet when the "
                         "server advertises it, json/parquet force one")

    w = sub.add_parser("workflow", help="Workflow generation.")
    wsub = w.add_subparsers(dest="workflow_command", metavar="WORKFLOW_COMMAND")
    wsub.required = True
    wc = wsub.add_parser("compile", help="Compile a fleet spec into the typed build/place/canary/promote DAG.")
    wr = wsub.add_parser("run", help="Compile AND execute a fleet spec: build -> bucket -> place -> canary -> "
                                     "promote, goodput-judged with auto-rollback.")
    wg = wsub.add_parser("generate", help="Render gang-scheduled manifests from a fleet config.")
    for q in (wc, wr, wg):
        q.add_argument("--machine-config", "-f", required=True)
        q.add_argument("--project-name", "-p", required=True)
    for q in (wc, wg):
        q.add_argument("--output-file", "-o", default=None)
    wc.add_argument("--models-per-bucket", type=int, default=None)
    wc.add_argument("--devices-per-bucket", type=int, default=None)
    wg.add_argument("--models-per-gang", type=int, default=None)
    wg.add_argument("--devices-per-gang", type=int, default=None)
    wr.add_argument("--state-dir", default=_env("GORDO_FLEET_STATE_DIR", ".fleet-state"),
                    help="Executor state (step keys, artifacts, incumbent backups); re-runs execute only the "
                         "stale subgraph")
    wr.add_argument("--server-url", action="append", default=None,
                    help="A live replica to roll the fleet onto (canary + promote through its zero-downtime "
                         "/reload swap), once a replica; omitted = plan-only run (build + plan, no landing)")
    wr.add_argument("--collection-dir", action="append", default=None,
                    help="Each --server-url's artifact dir, in the same order")
    wr.add_argument("--model-register-dir", default=_env("MODEL_REGISTER_DIR"))
    return p


_BODY_ENCODINGS = {"auto": "auto", "json": False, "parquet": True}

_REQUIRED = {
    "build": (("name", "MACHINE_NAME"), ("model_config", "MODEL_CONFIG"), ("data_config", "DATA_CONFIG")),
    "build-fleet": (("machines_file", "MACHINES_FILE"),),
    "checkpoint-prune": (("checkpoint_dir", "CHECKPOINT_DIR"),),
    "run-server": (("model_dir", "MODEL_COLLECTION_DIR"),),
    "run-watchman": (("project", "PROJECT_NAME"), ("server_base_url", "SERVER_BASE_URL")),
    "client": (("project", "PROJECT_NAME"),),
    "workflow": (),
}


def _load_json_or_yaml(value: str):
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return safe_load(value)


def _build(args) -> int:
    from gordo_components_torch import serializer
    from gordo_components_torch.builder import provide_saved_model

    try:
        model_config = _load_json_or_yaml(args.model_config)
        data_config = _load_json_or_yaml(args.data_config)
        metadata = _load_json_or_yaml(args.metadata) or {}
        evaluation_config = _load_json_or_yaml(args.evaluation_config) or {}
    except YAMLSubsetError as exc:
        print(f"Config parse error: {exc}", file=sys.stderr)
        return EXIT_CONFIG_ERROR
    try:
        path = provide_saved_model(
            args.name, model_config, data_config, metadata,
            output_dir=args.output_dir, model_register_dir=args.model_register_dir,
            evaluation_config=evaluation_config, device=args.device,
        )
    except (ValueError, ImportError, FileNotFoundError) as exc:
        print(f"Build failed (config/data): {exc}", file=sys.stderr)
        return EXIT_DATA_ERROR
    except Exception as exc:
        print(f"Build failed: {exc}", file=sys.stderr)
        return EXIT_BUILD_ERROR
    if args.print_cv_scores:
        cv = serializer.load_metadata(path).get("model", {}).get("cross-validation", {})
        print(json.dumps(cv.get("explained-variance", {})))
    print(path)
    return EXIT_OK


def _build_fleet(args) -> int:
    from gordo_components_torch.builder import build_fleet
    from gordo_components_torch.workflow import Machine

    # globals are not merged here: the entries are machines as they stand
    with open(args.machines_file) as f:
        payload = safe_load(f.read())
    if isinstance(payload, dict):
        entries = payload.get("machines", [])
    elif isinstance(payload, list):
        entries = payload
    else:
        entries = []
    machines = []
    for e in entries:
        kwargs = dict(
            name=e["name"],
            dataset=e.get("dataset", {}),
            metadata=e.get("metadata", {}) or {},
            evaluation=e.get("evaluation", {}) or {},
        )
        if e.get("model"):  # absent: the default model config
            kwargs["model"] = e["model"]
        machines.append(Machine(**kwargs))
    if not machines:
        print("No machines in payload", file=sys.stderr)
        return EXIT_CONFIG_ERROR
    try:
        results = build_fleet(
            machines, args.output_dir, model_register_dir=args.model_register_dir,
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
            distributed=args.distributed, state_dir=args.state_dir, gang_id=args.gang_id,
            device=args.device,
        )
    except Exception as exc:
        print(f"Fleet build failed: {exc}", file=sys.stderr)
        return EXIT_BUILD_ERROR
    # the manifest lists built and failed machines, beside the artifacts
    manifest = results.manifest()
    try:
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "build_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
    except OSError as exc:
        print(f"warning: could not write build_manifest.json: {exc}", file=sys.stderr)
    print(json.dumps(manifest, indent=2))
    if results.failed and not results:
        return EXIT_BUILD_ERROR
    if results.failed:
        return EXIT_PARTIAL_BUILD
    return EXIT_OK


def _checkpoint_prune(args) -> int:
    from gordo_components_torch.parallel.checkpoint import prune_stale_checkpoints

    n = prune_stale_checkpoints(args.checkpoint_dir, args.older_than_days)
    print(f"Pruned {n} stale checkpoint(s)")
    return EXIT_OK


def _run_server(args) -> int:
    from gordo_components_torch.server import run_server

    def stop(signum, frame):
        raise KeyboardInterrupt

    previous = signal.signal(signal.SIGTERM, stop)
    try:
        run_server(args.model_dir, host=args.host, port=args.port, device=args.device, devices=args.devices)
    except KeyboardInterrupt:
        logger.info("Server stopped")
    finally:
        signal.signal(signal.SIGTERM, previous)
    return EXIT_OK


def _run_watchman(args) -> int:
    from gordo_components_torch.watchman import run_watchman

    def stop(signum, frame):
        raise KeyboardInterrupt

    target_list = json.loads(args.targets) if args.targets else None
    previous = signal.signal(signal.SIGTERM, stop)
    try:
        run_watchman(args.project, args.server_base_url, target_list, host=args.host, port=args.port,
                     gang_state_dir=args.gang_state_dir, full_metadata=args.full_metadata)
    except KeyboardInterrupt:
        logger.info("Watchman stopped")
    finally:
        signal.signal(signal.SIGTERM, previous)
    return EXIT_OK


def _client_predict(args) -> int:
    from gordo_components_torch.client import Client, ForwardPredictionsIntoParquet
    from gordo_components_torch.dataset.times import to_ns

    try:  # up front, as pd.Timestamp refuses a time before any request
        to_ns(args.start), to_ns(args.end)
    except ValueError as exc:
        print(f"Invalid time: {exc}", file=sys.stderr)
        return 1
    forwarder = ForwardPredictionsIntoParquet(args.parquet_dir) if args.parquet_dir else None
    client = Client(args.project, base_url=args.base_url, forwarder=forwarder, batch_size=args.batch_size,
                    use_parquet=_BODY_ENCODINGS[args.body_encoding])
    results = client.predict(args.start, args.end, targets=list(args.target) or None)
    ok = sum(1 for r in results if r.ok)
    print(f"{ok}/{len(results)} machines scored successfully")
    for r in results:
        if not r.ok:
            print(f"  FAILED {r.name}: {r.error_messages[:1]}", file=sys.stderr)
    return 1 if ok < len(results) else EXIT_OK


def _client_metadata(args) -> int:
    import asyncio

    from gordo_components_torch.client.http import Session
    from gordo_components_torch.client.io import fetch_json, fetch_metadata_all

    base_url, project = args.base_url, args.project

    async def go():
        async with Session() as session:
            # one metadata-all request; a request a target for a foreign server
            batched = await fetch_metadata_all(session, base_url, project)
            if batched is not None:
                return {name: entry.get("endpoint-metadata", {})
                        for name, entry in batched["targets"].items() if isinstance(entry, dict)}
            targets = (await fetch_json(session, f"{base_url}/gordo/v0/{project}/models"))["models"]
            out = {}
            for t in targets:
                body = await fetch_json(session, f"{base_url}/gordo/v0/{project}/{t}/metadata")
                out[t] = body.get("endpoint-metadata", {})
            return out

    print(json.dumps(asyncio.run(go()), indent=2, default=str))
    return EXIT_OK


def _client_download_model(args) -> int:
    import shutil
    import urllib.error
    import urllib.request

    url = f"{args.base_url}/gordo/v0/{args.project}/{args.target}/download-model"
    try:
        with urllib.request.urlopen(url, timeout=120) as resp, open(args.dest, "wb") as f:
            shutil.copyfileobj(resp, f)
    except urllib.error.HTTPError as exc:
        print(f"Download failed: HTTP {exc.code} from {url}", file=sys.stderr)
        return 1
    print(args.dest)
    return EXIT_OK


def _client(args) -> int:
    return {"predict": _client_predict, "metadata": _client_metadata,
            "download-model": _client_download_model}[args.client_command](args)


def _write_or_print(text: str, output_file: Optional[str]) -> None:
    """``text`` into ``output_file`` (its path printed), else printed."""
    if output_file:
        with open(output_file, "w") as f:
            f.write(text)
        print(output_file)
    else:
        print(text)


def _workflow_compile(args) -> int:
    from gordo_components_torch.workflow import compile_fleet

    overrides = {}
    if args.models_per_bucket:
        overrides["models_per_bucket"] = args.models_per_bucket
    if args.devices_per_bucket:
        overrides["devices_per_bucket"] = args.devices_per_bucket
    try:
        with open(args.machine_config) as f:
            dag = compile_fleet(safe_load(f.read()), args.project_name, **overrides)
    except (ValueError, YAMLSubsetError) as exc:
        print(f"Invalid fleet spec: {exc}", file=sys.stderr)
        return EXIT_CONFIG_ERROR
    doc = dag.to_json()
    _write_or_print(doc + "\n" if args.output_file else doc, args.output_file)
    return EXIT_OK


def _workflow_generate(args) -> int:
    from gordo_components_torch.workflow import NormalizedConfig, generate_workflow

    try:
        config = NormalizedConfig.from_yaml_file(args.machine_config)
    except (ValueError, YAMLSubsetError) as exc:
        print(f"Invalid machine config: {exc}", file=sys.stderr)
        return EXIT_CONFIG_ERROR
    overrides = {}
    if args.models_per_gang:
        overrides["models_per_gang"] = args.models_per_gang
    if args.devices_per_gang:
        overrides["devices_per_gang"] = args.devices_per_gang
    try:
        # generating compiles the spec, so a spec error exits as compile's does
        manifest = generate_workflow(config, args.project_name, **overrides)
    except ValueError as exc:
        print(f"Invalid fleet spec: {exc}", file=sys.stderr)
        return EXIT_CONFIG_ERROR
    _write_or_print(manifest, args.output_file)
    return EXIT_OK


def _workflow_run(args) -> int:
    from gordo_components_torch.workflow import FleetExecutor, compile_fleet

    urls = args.server_url or ([os.environ["SERVER_BASE_URL"]] if os.environ.get("SERVER_BASE_URL") else [])
    cdirs = args.collection_dir or (
        [os.environ["MODEL_COLLECTION_DIR"]] if os.environ.get("MODEL_COLLECTION_DIR") else [])
    try:
        with open(args.machine_config) as f:
            dag = compile_fleet(safe_load(f.read()), args.project_name)
        if len(urls) > 1 or len(cdirs) > 1:
            if len(urls) != len(cdirs):
                raise ValueError(f"{len(urls)} --server-url against {len(cdirs)} --collection-dir: give one "
                                 "artifact dir a replica, in the same order")
            executor = FleetExecutor(dag, args.state_dir, replicas=list(zip(urls, cdirs)),
                                     register_dir=args.model_register_dir, device=args.device)
        else:
            executor = FleetExecutor(dag, args.state_dir, server_url=urls[0] if urls else None,
                                     collection_dir=cdirs[0] if cdirs else None,
                                     register_dir=args.model_register_dir, device=args.device)
    except (ValueError, YAMLSubsetError) as exc:
        print(f"Invalid fleet spec: {exc}", file=sys.stderr)
        return EXIT_CONFIG_ERROR
    report = executor.run()
    print(json.dumps(report, indent=2, default=str))
    if report["failed"]:
        return EXIT_PARTIAL_BUILD if report["executed"] else EXIT_BUILD_ERROR
    return EXIT_OK


def _workflow(args) -> int:
    return {"compile": _workflow_compile, "generate": _workflow_generate,
            "run": _workflow_run}[args.workflow_command](args)


_COMMANDS = {"build": _build, "build-fleet": _build_fleet, "checkpoint-prune": _checkpoint_prune,
             "run-server": _run_server, "run-watchman": _run_watchman, "client": _client,
             "workflow": _workflow}


def main(argv: Optional[List[str]] = None) -> int:
    """Run one command; returns its exit code."""
    parser = _parser()
    args = parser.parse_args(argv)
    for attr, env in _REQUIRED[args.command]:
        if getattr(args, attr) is None:
            parser.error(f"{args.command}: --{attr.replace('_', '-')} (or {env}) is required")
    if args.compile_cache_dir:
        parser.error("--compile-cache-dir (GORDO_COMPILE_CACHE_DIR): the XLA compile cache has "
                     "no counterpart in the port")
    if args.command == "client" and args.client_command == "predict" and args.body_encoding not in _BODY_ENCODINGS:
        parser.error(f"--body-encoding (GORDO_CLIENT_ENCODING): {args.body_encoding!r} is not one of "
                     f"{', '.join(_BODY_ENCODINGS)}")
    if args.command == "workflow":
        if not os.path.exists(args.machine_config):
            parser.error(f"--machine-config / -f: path {args.machine_config!r} does not exist")
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if args.profile_dir:
        os.environ["GORDO_PROFILE_DIR"] = args.profile_dir
    if os.environ.get("GORDO_FAULTS"):
        # before any subsystem runs: specs for sites not imported yet wait
        # for their registration
        from gordo_components_torch.resilience import configure_from_env

        configure_from_env()
    return _COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
