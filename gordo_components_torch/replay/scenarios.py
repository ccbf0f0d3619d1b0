"""The standard incident-scenario library — ``make replay``'s
regression set.

Counterpart of ``gordo_components_tpu/replay/scenarios.py``, field for
field: the port's replay is judged by the same bounds.

Each entry backtests one failure-mode class against the full ingest ->
drift -> recalibrate -> refit -> hot-swap loop, with bounds asserted by
``Scenario.judge``. Durations are EVENT time (hours of replayed sensor
history); at the engine's default compression they each run in seconds
of wall time.

The scenario set mirrors the incident taxonomy of the replay harness:
calibration drift (mean shift, variance inflation — singly and
correlated fleet-wide), sensor pathologies (dropout, flatline),
delivery pathologies (late + duplicated rows), the seasonal
false-positive bait, and the fault co-fire (refit failure mid-incident
riding a ``faultpoint``). Tuning knobs (thresholds, EWMA alpha,
refit epochs) are judged BY these backtests — tune against `make
replay`, not vibes.
"""

from typing import Dict, List, Tuple

from gordo_components_torch.replay.incidents import Incident, Scenario

__all__ = ["default_fleet", "standard_scenarios"]

_H = 3600.0

TAGS3 = tuple(f"tag-{i}" for i in range(3))
TAGS5 = tuple(f"tag-{i}" for i in range(5))


def default_fleet() -> Dict[str, List[str]]:
    """A small heterogeneous fleet (two feature counts -> two bank
    buckets) — big enough that adaptation must route through real
    bucket programs, small enough to train in seconds."""
    return {
        "m3-0": list(TAGS3),
        "m3-1": list(TAGS3),
        "m5-0": list(TAGS5),
        "m5-1": list(TAGS5),
    }


def standard_scenarios() -> Tuple[Scenario, ...]:
    shifted = ("m3-1", "m5-0")  # one drifted member per bucket
    return (
        Scenario(
            name="mean_shift",
            description=(
                "The PR 9 acceptance replayed: a sustained mean shift on "
                "one member per bucket; detection must flag exactly the "
                "shifted members and recalibration must collapse the "
                "false-positive rate"
            ),
            duration_s=9 * _H,
            incidents=(
                Incident(
                    kind="mean_shift", start_s=3 * _H,
                    members=shifted, mean_shift=4.0,
                ),
            ),
            refit_targets=(shifted[0],),
            bounds={
                "max_detection_latency_s": 3.5 * _H,
                "fp_drop_factor_min": 2.0,
                "fp_after_max": 0.35,
                "require_adapted": True,
            },
        ),
        Scenario(
            name="variance_inflation",
            description=(
                "Sensor noise inflates 400x (0.1 -> 2.0 sigma) on one "
                "member: the error ratio must flag it and threshold "
                "recalibration on the noisy window must absorb it. "
                "(Measured: the autoencoder denoises smaller inflations "
                "back under the train-time max threshold — backtesting "
                "is how that detection floor was found.)"
            ),
            duration_s=9 * _H,
            incidents=(
                Incident(
                    kind="variance_inflation", start_s=3 * _H,
                    members=("m3-0",), var_inflation=400.0,
                ),
            ),
            bounds={
                "max_detection_latency_s": 3.5 * _H,
                "fp_drop_factor_min": 2.0,
                "require_adapted": True,
            },
        ),
        Scenario(
            name="sensor_dropout",
            description=(
                "A third of all sensor cells go NaN fleet-wide: the "
                "clean-window contract must keep scoring/drift on the "
                "surviving rows with NO phantom drift flag and no 5xx"
            ),
            duration_s=6 * _H,
            incidents=(
                Incident(
                    kind="sensor_dropout", start_s=2 * _H,
                    dropout_p=0.35, expect_detect=False,
                ),
            ),
            bounds={"forbid_detection": True},
        ),
        Scenario(
            name="flatline",
            description=(
                "One sensor freezes at its last value (looks alive, "
                "carries no information): reconstruction error on the "
                "stuck channel must flag the member"
            ),
            duration_s=10 * _H,
            incidents=(
                Incident(
                    kind="flatline", start_s=3 * _H,
                    members=("m5-1",), flatline_tags=("tag-1",),
                ),
            ),
            bounds={
                "max_detection_latency_s": 5 * _H,
                "require_adapted": True,
            },
        ),
        Scenario(
            name="late_duplicate",
            description=(
                "A flaky gateway delivers a quarter of rows late and "
                "re-sends a quarter verbatim: dedup + lateness "
                "accounting must absorb both with no drift skew"
            ),
            duration_s=6 * _H,
            incidents=(
                Incident(
                    kind="late_duplicate", start_s=1 * _H,
                    late_fraction=0.25, duplicate_p=0.25,
                    expect_detect=False,
                ),
            ),
            bounds={"forbid_detection": True, "min_duplicates": 100},
        ),
        Scenario(
            name="seasonal_cycle",
            description=(
                "A slow seasonal swing rides every mean, well inside "
                "the healthy band: the detector must NOT alarm — "
                "phantom refits are the cost the EWMA exists to avoid"
            ),
            duration_s=12 * _H,
            incidents=(
                Incident(
                    kind="seasonal_cycle", start_s=0.0,
                    season_amp=0.2, season_period_s=8 * _H,
                    expect_detect=False,
                ),
            ),
            bounds={"forbid_detection": True},
        ),
        Scenario(
            name="correlated_failure",
            description=(
                "Every machine shifts at once (plant-wide process "
                "change): fleet-wide detection, fleet-wide "
                "recalibration, zero non-200 through the swaps"
            ),
            duration_s=9 * _H,
            incidents=(
                Incident(
                    kind="correlated_shift", start_s=3 * _H,
                    members=None, mean_shift=4.0,
                ),
            ),
            bounds={
                "max_detection_latency_s": 3.5 * _H,
                "fp_drop_factor_min": 2.0,
                "require_adapted": True,
            },
        ),
        Scenario(
            name="refit_fault_mid_incident",
            description=(
                "The mean-shift incident co-fires a stream.refit "
                "fault: the first refit must roll back (serving "
                "generation untouched, verdict records the "
                "degradation), recalibration must still land, and the "
                "data plane must never 5xx"
            ),
            duration_s=9 * _H,
            incidents=(
                Incident(
                    kind="mean_shift_refit_fault", start_s=3 * _H,
                    members=shifted, mean_shift=4.0,
                    faults=({"site": "stream.refit", "times": 1},),
                ),
            ),
            refit_targets=(shifted[0],),
            bounds={
                "max_detection_latency_s": 3.5 * _H,
                "expect_rolled_back": True,
                "require_adapted": True,
            },
        ),
    )
