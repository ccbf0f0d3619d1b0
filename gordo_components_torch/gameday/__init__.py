"""Game days of the port: the scenario catalog (``scenarios.py``).

Counterpart of ``gordo_components_tpu/gameday/``. The catalog and its
judge are ported, so the fleet compiler validates a spec's
``fleet.gameday.gate`` against the same scenarios; the drills that boot a
multi-process mesh and inject its failures (``gate.py``, ``harness.py``,
``replica.py``) are not ported yet. Verdicts share the replay harness's
envelope (``replay/verdict.py``).
"""

from gordo_components_torch.gameday.scenarios import GATE_DEFAULT, SCENARIOS, GamedayScenario, known_scenarios

__all__ = ["GATE_DEFAULT", "SCENARIOS", "GamedayScenario", "known_scenarios"]
