"""Simulated live-stream provider (drift-injectable).

Counterpart of ``gordo_components_tpu/dataset/data_provider/streaming.py``
without pandas: times are int64 ns (a start may be an ISO 8601 string, a
``datetime64``, a datetime or ns), and :meth:`SimulatedLiveProvider.frame`
answers a :class:`~gordo_components_torch.dataset.base.ResultFrame`, its
values bitwise the JAX frame's. Every number is the JAX provider's.

The serving side's streaming plane (``gordo_components_torch/streaming/``)
needs a deterministic live source to drive tests and the smoke's stream
phase without a broker.

:class:`SimulatedLiveProvider` wraps :class:`RandomDataProvider`'s
per-tag sine generator (so data "streamed" for a time range is the same
distribution a model trained on that generator saw) and adds the failure
modes the concept-drift scenario family needs, each injectable at a
point in event time:

- **mean shift** — a constant offset on selected tags;
- **variance inflation** — the NOISE component scaled up around the
  clean (noise-free) signal;
- **sensor dropout** — per-cell NaNs at a seeded probability;
- **late data** — a seeded fraction of rows is withheld and delivered
  out of order (behind the watermark), exercising the ingestor's
  late-row accounting;
- **duplicated delivery** — a seeded fraction of rows is re-sent
  verbatim (same timestamp, same values), the at-least-once-transport
  failure mode the ingestor's dedup counter exists for.

Determinism is per ROW, not per batch: every random decision (a dropout
cell, a late row, a duplicate) is a pure hash of ``(provider seed, the
row's global index, the tag)`` — so equal ``(seed, injection schedule)``
yields bitwise-identical streams **regardless of how the range is
chunked into batches**. That property is what makes replay runs
reproducible and lets :meth:`stream` re-chunk months of history at
whatever batch size the harness wants.
"""

import hashlib
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from gordo_components_torch.dataset.base import ResultFrame
from gordo_components_torch.dataset.data_provider.base import GordoBaseDataProvider, Series
from gordo_components_torch.dataset.data_provider.providers import RandomDataProvider
from gordo_components_torch.dataset.sensor_tag import SensorTag, normalize_sensor_tags
from gordo_components_torch.dataset.times import resolution_ns, to_ns
from gordo_components_torch.utils import capture_args

# one splitmix64 pass: the standard 64-bit finalizer — enough avalanche
# to decorrelate consecutive row indices, fully vectorized
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x + _SM_GAMMA
        x = (x ^ (x >> np.uint64(30))) * _SM_M1
        x = (x ^ (x >> np.uint64(27))) * _SM_M2
        return x ^ (x >> np.uint64(31))


def _hash_uniform(key: int, idx: np.ndarray) -> np.ndarray:
    """Stateless uniforms in [0, 1): one per entry of ``idx``, a pure
    function of ``(key, idx)`` — no RNG state, so any chunking of the
    index space draws identical values."""
    z = _splitmix64(idx.astype(np.uint64) ^ np.uint64(key))
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _start_ns(start) -> int:
    """ns since the epoch (UTC) of a start: an int is ns already (as
    ``pd.Timestamp`` reads one), anything else goes through ``to_ns``."""
    if isinstance(start, (int, np.integer)):
        return int(start)
    return to_ns(start)


class SimulatedLiveProvider(GordoBaseDataProvider):
    """Deterministic synthetic live stream over the RandomDataProvider
    signal family, with drift injection.

    ``load_series`` serves the (undrifted) base signal, so a
    ``TimeSeriesDataset`` over this provider trains on exactly the
    healthy distribution the stream later drifts away from. ``batch``
    produces one live delivery: (event timestamps, values) at ``freq``
    with the currently injected drift applied; ``stream`` produces a
    chunk-invariant arrival sequence over a long range."""

    io_bound = False  # pure host compute, like RandomDataProvider

    @capture_args
    def __init__(self, freq: str = "10s", noise: float = 0.1, seed: int = 0):
        self.freq = freq
        self.noise = float(noise)
        self.seed = int(seed)
        self._base = RandomDataProvider(freq=freq, noise=noise, seed=seed)
        # the clean reference (same sine params, zero noise): variance
        # inflation scales the residual around THIS, which keeps it a
        # pure function of event time (chunk-invariant) instead of the
        # batch mean
        self._clean = RandomDataProvider(freq=freq, noise=0.0, seed=seed)
        # injected drift state (None = healthy). Tags is None = all tags.
        self._drift: Optional[dict] = None

    # ------------------------- provider contract ----------------------- #

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return True

    def load_series(
        self,
        from_ns: int,
        to_ns: int,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        """The HEALTHY base signal (training-side view): drift is a
        property of the live stream, never of the training range."""
        return self._base.load_series(from_ns, to_ns, tag_list, dry_run)

    # --------------------------- drift control ------------------------- #

    def inject(
        self,
        mean_shift: float = 0.0,
        var_inflation: float = 1.0,
        dropout_p: float = 0.0,
        late_fraction: float = 0.0,
        duplicate_p: float = 0.0,
        tags: Optional[List[str]] = None,
    ) -> None:
        """Arm drift for subsequent ``batch``/``stream`` calls. ``tags``
        restricts mean shift / variance inflation to the named tags
        (dropout, lateness, and duplication are row/cell-level and apply
        to the whole stream)."""
        self._drift = {
            "mean_shift": float(mean_shift),
            "var_inflation": float(var_inflation),
            "dropout_p": float(dropout_p),
            "late_fraction": float(late_fraction),
            "duplicate_p": float(duplicate_p),
            "tags": None if tags is None else set(tags),
        }

    def clear(self) -> None:
        self._drift = None

    # ------------------------ per-row randomness ----------------------- #

    def _purpose_key(self, purpose: str) -> int:
        digest = hashlib.sha256(f"{self.seed}|{purpose}".encode()).digest()
        return int.from_bytes(digest[:8], "little")

    def _row_indices(self, event_ts: np.ndarray) -> np.ndarray:
        """A row's GLOBAL index on the provider's sampling grid — the
        identity every per-row random decision hashes, so the decision
        does not depend on which batch the row arrived in."""
        step_s = resolution_ns(self.freq) / 1e9
        return np.round(np.asarray(event_ts, np.float64) / step_s).astype(
            np.int64
        )

    # ----------------------------- the stream -------------------------- #

    def _event_rows(
        self, start, n_rows: int, tags: List[SensorTag]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Rows in EVENT-TIME order with the value-space drift (mean
        shift, variance inflation, seeded dropout) applied — no arrival
        effects (late/duplicate) yet."""
        start = _start_ns(start)
        end = start + resolution_ns(self.freq) * n_rows
        series = list(self._base.load_series(start, end, tags))
        values = np.stack(
            [np.asarray(s.values[:n_rows], np.float32) for s in series], axis=1
        )
        index = np.asarray(series[0].index[:n_rows], np.int64)
        event_ts = index.astype(np.float64) / 1e9

        drift = self._drift
        if drift is not None:
            cols = [
                i
                for i, t in enumerate(tags)
                if drift["tags"] is None or t.name in drift["tags"]
            ]
            if drift["var_inflation"] != 1.0 and cols:
                clean = np.stack(
                    [
                        np.asarray(s.values[:n_rows], np.float32)
                        for s in self._clean.load_series(start, end, tags)
                    ],
                    axis=1,
                )
                values[:, cols] = clean[:, cols] + (
                    values[:, cols] - clean[:, cols]
                ) * np.float32(np.sqrt(drift["var_inflation"]))
            if drift["mean_shift"] and cols:
                values[:, cols] += np.float32(drift["mean_shift"])
            if drift["dropout_p"] > 0:
                row_idx = self._row_indices(event_ts)
                # cell identity = (row grid index, tag name): the same
                # cell drops out no matter the batching or tag subset
                tag_keys = np.array(
                    [
                        int.from_bytes(
                            hashlib.sha256(t.name.encode()).digest()[:8],
                            "little",
                        )
                        for t in tags
                    ],
                    dtype=np.uint64,
                )
                with np.errstate(over="ignore"):
                    cell_idx = (
                        row_idx.astype(np.uint64)[:, None] * _SM_M1
                        ^ tag_keys[None, :]
                    )
                u = _hash_uniform(self._purpose_key("dropout"), cell_idx)
                values[u < drift["dropout_p"]] = np.nan
        return event_ts, values

    def _arrival_flags(
        self, event_ts: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(late_mask, duplicate_mask) per event row — pure hashes of
        the row's grid index."""
        drift = self._drift
        n = len(event_ts)
        if drift is None:
            z = np.zeros(n, bool)
            return z, z
        row_idx = self._row_indices(event_ts)
        late = (
            _hash_uniform(self._purpose_key("late"), row_idx)
            < drift["late_fraction"]
            if drift["late_fraction"] > 0
            else np.zeros(n, bool)
        )
        dup = (
            _hash_uniform(self._purpose_key("duplicate"), row_idx)
            < drift["duplicate_p"]
            if drift["duplicate_p"] > 0
            else np.zeros(n, bool)
        )
        return late, dup

    def batch(
        self,
        start,
        n_rows: int,
        tag_list: List,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One live batch: ``(event_ts, values)`` where ``event_ts`` is
        (n,) float epoch seconds and ``values`` (n, n_tags) float32 with
        NaNs for dropped-out sensor cells.

        Rows are emitted in ARRIVAL order: with ``late_fraction`` armed,
        the seeded late rows are withheld and appended at the end of the
        batch with their original (old) event timestamps — the ingestor
        sees them as out-of-order/late rows behind its watermark,
        exactly like a flaky field gateway flushing its buffer. With
        ``duplicate_p`` armed, the seeded rows are RE-SENT verbatim at
        the very end (same stamp, same values) — the at-least-once
        redelivery the ingestor deduplicates. For arrival sequences
        that must not depend on the batching, use :meth:`stream`."""
        tags = normalize_sensor_tags(list(tag_list))
        event_ts, values = self._event_rows(start, n_rows, tags)
        late, dup = self._arrival_flags(event_ts)
        if dup.any():
            # the duplicate is a copy of the row as DELIVERED (post-
            # drift, post-dropout): a re-send carries identical bytes
            event_ts = np.concatenate([event_ts, event_ts[dup]])
            values = np.concatenate([values, values[dup]])
            late = np.concatenate([late, np.zeros(int(dup.sum()), bool)])
        if late.any() and len(event_ts) > 1:
            order = np.concatenate(
                [np.flatnonzero(~late), np.flatnonzero(late)]
            )
            values = values[order]
            event_ts = event_ts[order]
        return event_ts, values

    def stream(
        self,
        start,
        n_rows: int,
        tag_list: List,
        chunk_rows: int = 256,
        late_delay_rows: int = 8,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The chunk-invariant arrival sequence: yields ``(event_ts,
        values)`` chunks of ``chunk_rows`` (the tail may be smaller)
        covering ``n_rows`` of event time from ``start``.

        Late rows are withheld and re-inserted ``late_delay_rows``
        source rows later; duplicates are re-sent ``late_delay_rows``
        rows after their original. Because every decision is a per-row
        hash and the withhold/release bookkeeping advances per SOURCE
        row, the concatenated arrival sequence is bitwise-identical for
        any ``chunk_rows`` — the reproducibility contract replay runs
        assert on."""
        if n_rows <= 0:
            return
        tags = normalize_sensor_tags(list(tag_list))
        chunk_rows = max(1, int(chunk_rows))
        delay = max(1, int(late_delay_rows))
        step = resolution_ns(self.freq)
        start = _start_ns(start)
        # (release_at_source_row, seq, ts, row) — seq keeps releases of
        # equal rank in their scheduling order
        pending: List[Tuple[int, int, float, np.ndarray]] = []
        out_ts: List[float] = []
        out_rows: List[np.ndarray] = []
        seq = 0
        # generate in fixed internal blocks (vectorized), schedule per row
        BLOCK = 4096
        for block_start in range(0, n_rows, BLOCK):
            m = min(BLOCK, n_rows - block_start)
            ts, vals = self._event_rows(start + step * block_start, m, tags)
            late, dup = self._arrival_flags(ts)
            for j in range(m):
                i = block_start + j
                if late[j]:
                    pending.append((i + delay, seq, ts[j], vals[j]))
                    seq += 1
                else:
                    out_ts.append(ts[j])
                    out_rows.append(vals[j])
                if dup[j]:
                    pending.append((i + delay, seq, ts[j], vals[j].copy()))
                    seq += 1
                if pending:
                    due = [p for p in pending if p[0] <= i]
                    if due:
                        due.sort(key=lambda p: (p[0], p[1]))
                        pending = [p for p in pending if p[0] > i]
                        for _, _, pts, prow in due:
                            out_ts.append(pts)
                            out_rows.append(prow)
                while len(out_ts) >= chunk_rows:
                    yield (
                        np.asarray(out_ts[:chunk_rows], np.float64),
                        np.stack(out_rows[:chunk_rows]),
                    )
                    del out_ts[:chunk_rows], out_rows[:chunk_rows]
        # flush: releases scheduled past the end, in release order
        pending.sort(key=lambda p: (p[0], p[1]))
        for _, _, pts, prow in pending:
            out_ts.append(pts)
            out_rows.append(prow)
        while out_ts:
            yield (
                np.asarray(out_ts[:chunk_rows], np.float64),
                np.stack(out_rows[:chunk_rows]),
            )
            del out_ts[:chunk_rows], out_rows[:chunk_rows]

    def frame(self, start, n_rows: int, tag_list: List) -> ResultFrame:
        """Convenience: one batch as a tag-columned frame (arrival order;
        index = event time, ``datetime64[ns]``; values float32, as the JAX
        DataFrame holds them). Used to TRAIN matched-distribution
        detectors — fit on a healthy ``frame``, stream drifted ``batch``
        rows at the same resolution."""
        tags = normalize_sensor_tags(list(tag_list))
        ts, values = self.batch(start, n_rows, tags)
        index = (ts * 1e9).astype("int64").astype("datetime64[ns]")
        return ResultFrame(values, index, [t.name for t in tags])
