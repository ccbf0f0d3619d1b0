"""Mesh-scale game days of the port: break the multi-process mesh ON
PURPOSE, judge every failure with the SLO/incident stack.

Counterpart of ``gordo_components_tpu/gameday/``. A
:class:`~gameday.harness.GamedayMesh` boots the REAL multi-process mesh
(N ``gameday/replica.py`` server subprocesses + a live watchman), puts
it under scoring load, injects a mesh-class failure from the scenario
catalog (``scenarios.py``), and judges the whole loop end to end:

- **detect** — watchman's routing plane, SLO rollup and ``/incidents``
  correlation must see the failure (detection latency, burn peak,
  causal event ordering);
- **contain** — routing/hedging/quarantine must bound the blast radius
  (non-200s vs a DECLARED budget, no traffic to dead or gray replicas);
- **recover** — burn returns to zero, the routing version converges,
  subscribers re-attach.

Verdicts share the replay harness's envelope (``replay/verdict.py``:
``failures``/``passed``), and the gate-capable scenarios gate fleet
promotion (``gameday/gate.py`` + the ``gameday`` step kind in
``workflow/compiler.py``, run by ``workflow/executor.py``).

Fault injection over subprocess boundaries rides the ``GORDO_FAULTS``
env (``resilience/faults.py``); in-process injection uses the same
registry directly.
"""

from gordo_components_torch.gameday.scenarios import GATE_DEFAULT, SCENARIOS, GamedayScenario, known_scenarios

__all__ = ["GATE_DEFAULT", "SCENARIOS", "GamedayScenario", "known_scenarios"]
