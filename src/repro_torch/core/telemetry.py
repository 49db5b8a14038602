"""Telemetry: per-step structured records, MFU accounting, drift monitor (a
copy of ``repro/core/telemetry.py``).

The paper's headline results are measurements: 38.38%/36.14%/31.96% GPU
throughput (MFU) for 22B/175B/1T, bubble fractions, comm volume, memory
footprints.  This module is the measurement layer of the port: a
:class:`Telemetry` recorder that turns a training run into a stream of
schema-tagged JSONL records (``SCHEMA``, the reference's, so either side's
``validate_record`` reads the other's) carrying

  * throughput: wall time, tokens/s, achieved FLOPs and **MFU** from the
    analytic per-family count (``core/costmodel.py:train_step_flops``;
    model FLOPs, remat's recompute excluded, comparable to the paper's);
  * training signals: loss, grad_norm, loss_scale, grads_finite;
  * on a card, each rank's peak device memory of the step; under a mesh,
    the collective bytes the rank's step moved by kind
    (``runtime/collectives.py``'s counters, which stand in for the
    reference's ``analysis/hlo.py:comm_bytes`` on a compiled module); at
    pp > 1 the pipeline's measured idle share (each rank's time in stage
    applications over its sweep's time, ``runtime/pipeline.py``'s
    ``walk_reading``) beside the schedule's ``spmd_idle_fraction`` and the
    analytic ``bubble_fraction``;
  * one compile record: the world size, the backend, whether the kernels
    took their plain versions (CPU tensors), the per-rank state bytes
    (``runtime/train_loop.py:train_state_bytes``) and the time to the
    first step, builds included;
  * one ``request`` record per finished serving request (arrival,
    admission, first-token and done times on the engine clock, token
    counts, finish reason, evictions), from ``runtime/serve_engine.py``;
  * a **drift** block: the costmodel's predicted step time
    (``costmodel.predict_step``) next to the measured one, with a
    measured/predicted ratio and a rolling-window summary
    (:class:`DriftMonitor`); a threshold crossing warns once.

Every record goes through :func:`sanitize_record` and
:func:`validate_record`.  ``launch/train.py --log-jsonl`` writes the
stream (``launch/serve.py --log-jsonl`` the request records), ``analysis/report.py --telemetry`` renders it, and
``analysis/trace.py`` draws the pipeline timeline of the same run.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import IO, Any, Mapping

import torch

from repro_torch.core import costmodel as cm

SCHEMA = "repro.telemetry/1"

# machines the --machine flag can name (MFU denominators / drift anchors)
MACHINES: dict[str, cm.Machine] = {
    "h100": cm.H100,
    "frontier": cm.FRONTIER,
}

# required keys per record kind: the contract ``validate_record`` enforces
_STEP_KEYS = frozenset({
    "schema", "kind", "step", "wall_s", "tokens", "tokens_per_s",
    "flops_per_step", "tflops_per_device", "mfu", "loss", "loss_scale",
    "predicted", "drift",
})
_COMPILE_KEYS = frozenset({
    "schema", "kind", "arch", "family", "plan", "global_batch", "seq_len",
    "devices", "backend", "kernels_interpret_mode", "machine", "peak_flops",
    "flops_per_step", "predicted",
})
# per-request serving records (runtime/serve_engine.py emits one per
# finished request; launch/serve.py --log-jsonl writes them)
_REQUEST_KEYS = frozenset({
    "schema", "kind", "rid", "arch", "t_arrival", "t_admit",
    "t_first_token", "t_done", "n_prompt", "n_generated", "finish_reason",
    "evictions",
})


def sanitize_record(rec: Mapping[str, Any], *,
                    drop: tuple[str, ...] = ("traceback",)) -> dict:
    """JSON-safe copy of a record: ``drop`` keys removed at every nesting
    level, numpy and torch scalars coerced to Python floats/ints/bools."""
    def clean(x):
        if isinstance(x, Mapping):
            return {str(k): clean(v) for k, v in x.items() if k not in drop}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        if isinstance(x, (str, int, float, bool)) or x is None:
            return x
        if hasattr(x, "item") and getattr(x, "ndim", None) in (0, None):
            try:
                return x.item()      # numpy / 0-d torch scalar
            except Exception:
                pass
        if hasattr(x, "tolist"):
            return x.tolist()        # small arrays (e.g. loss curves)
        return str(x)
    return clean(dict(rec))


def mfu(flops_per_step: float, step_time_s: float, n_devices: int,
        peak_flops: float) -> float:
    """Model-FLOPs utilization: analytic step FLOPs over what the machine
    could have done in the measured wall time."""
    denom = step_time_s * max(n_devices, 1) * peak_flops
    return flops_per_step / denom if denom > 0 else 0.0


def step_fields(cfg, global_batch: int, seq_len: int, wall_s: float,
                n_devices: int, machine: cm.Machine | str = "h100") -> dict:
    """Throughput fields for one measured step: the fragment a benchmark
    merges into its records so they share the telemetry's accounting."""
    machine = MACHINES[machine] if isinstance(machine, str) else machine
    flops = cm.train_step_flops(cfg, global_batch, seq_len).total
    tokens = global_batch * seq_len
    return {
        "tokens_per_s": tokens / wall_s if wall_s > 0 else 0.0,
        "flops_per_step": flops,
        "tflops_per_device": (flops / (wall_s * max(n_devices, 1)) / 1e12
                              if wall_s > 0 else 0.0),
        "mfu": mfu(flops, wall_s, n_devices, machine.peak_flops),
        "machine": machine.name,
    }


@dataclasses.dataclass
class DriftMonitor:
    """Rolling measured/predicted ratio with a threshold warning.

    A ratio of 1.0 means the costmodel's calibration predicts this machine
    exactly; each record is a calibration sample for
    ``costmodel.calibrate_bandwidths``.  The warning fires once, when the
    *rolling* ratio (mean over ``window`` steps) crosses ``threshold`` or
    1/``threshold``: sustained drift, not a single straggler step."""
    threshold: float = 10.0
    window: int = 20
    _ratios: list[float] = dataclasses.field(default_factory=list)
    _warned: bool = dataclasses.field(default=False)

    def update(self, measured_s: float, predicted_s: float) -> dict:
        ratio = measured_s / predicted_s if predicted_s > 0 else float("inf")
        self._ratios.append(ratio)
        tail = self._ratios[-self.window:]
        rolling = sum(tail) / len(tail)
        warn = rolling > self.threshold or rolling < 1.0 / self.threshold
        if warn and not self._warned:
            self._warned = True
            warnings.warn(
                f"costmodel drift: rolling measured/predicted step-time "
                f"ratio {rolling:.2f} outside [1/{self.threshold:g}, "
                f"{self.threshold:g}] over the last {len(tail)} steps — "
                f"recalibrate with costmodel.calibrate_bandwidths",
                stacklevel=3)
        return {"step_time_ratio": ratio, "rolling_ratio": rolling,
                "window": len(tail), "warn": warn,
                "threshold": self.threshold}


class JsonlSink:
    """Append-only JSONL writer; every record goes through
    :func:`sanitize_record` and is flushed at once (a crash keeps the tail)."""

    def __init__(self, path: str):
        self.path = path
        self._f: IO[str] | None = open(path, "a")

    def write(self, rec: Mapping[str, Any]) -> None:
        if self._f is None:
            raise ValueError(f"sink {self.path} is closed")
        self._f.write(json.dumps(sanitize_record(rec)) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Telemetry:
    """Per-run recorder: one compile record, then one record per step.

    ``cfg`` is the ``ModelConfig`` trained, ``plan`` the ``ParallelPlan``.
    The analytic FLOPs and the costmodel prediction are computed once here;
    :meth:`step` only does O(1) bookkeeping on the metrics the executor
    returns.  A record that fails :func:`validate_record` raises."""

    def __init__(self, cfg, plan, global_batch: int, seq_len: int, *,
                 machine: cm.Machine | str = "h100",
                 jsonl: str | None = None,
                 drift_threshold: float = 10.0, drift_window: int = 20):
        self.cfg, self.plan = cfg, plan
        self.global_batch, self.seq_len = global_batch, seq_len
        self.machine = (MACHINES[machine] if isinstance(machine, str)
                        else machine)
        self.flops = cm.train_step_flops(cfg, global_batch, seq_len)
        try:
            self.prediction = cm.predict_step(cfg, plan, global_batch,
                                              seq_len, self.machine)
        except Exception:                   # a plan the model can't price
            self.prediction = None
        self.drift = DriftMonitor(threshold=drift_threshold,
                                  window=drift_window)
        self.sink = JsonlSink(jsonl) if jsonl else None
        self.step_walls: list[float] = []
        self.records: list[dict] = []

    def record_compile(self, *, device: torch.device, devices: int = 1,
                       state_bytes: dict | None = None,
                       compile_s: float | None = None,
                       extra: dict | None = None) -> dict:
        """The run's one-time record: ``devices`` is the world size, the
        backend the device's type; on CPU tensors every kernel takes its
        plain version (the reference's interpret mode).  ``state_bytes`` is
        the rank's ``train_state_bytes``, ``compile_s`` the time to the end
        of the first step, kernel builds included."""
        backend = torch.device(device).type
        rec: dict[str, Any] = {
            "schema": SCHEMA, "kind": "compile",
            "arch": self.cfg.name, "family": self.cfg.family,
            "plan": plan_dict(self.plan),
            "global_batch": self.global_batch, "seq_len": self.seq_len,
            "devices": devices,
            "backend": backend,
            "kernels_interpret_mode": backend == "cpu",
            "machine": self.machine.name,
            "peak_flops": self.machine.peak_flops,
            "flops_per_step": self.flops.total,
            "flops_breakdown": {"matmul": self.flops.matmul,
                                "attn": self.flops.attn,
                                "scan": self.flops.scan},
            "predicted": predicted_block(self.prediction),
        }
        if state_bytes is not None:
            rec["state_bytes"] = state_bytes
        if compile_s is not None:
            rec["compile_s"] = compile_s
        if extra:
            rec.update(extra)
        return self._emit(rec)

    def step(self, step: int, wall_s: float, metrics: Mapping[str, Any],
             *, tokens: int | None = None, peak_bytes: list[int] | None = None,
             comm_bytes: Mapping[str, int] | None = None,
             pipeline: Mapping[str, Any] | None = None) -> dict:
        """Record one optimizer step from its measured wall time and the
        executor's metrics; ``peak_bytes`` is each rank's peak device memory
        of the step (on a card), ``comm_bytes`` the collective bytes the
        rank's step moved by kind (under a mesh), ``pipeline`` the measured
        pipeline (at pp > 1: ``pipeline_fields``).  Returns the sanitized
        record."""
        tokens = tokens if tokens is not None else self.global_batch * self.seq_len
        n_dev = self.plan.n_devices
        self.step_walls.append(wall_s)
        rec: dict[str, Any] = {
            "schema": SCHEMA, "kind": "step", "step": step,
            "wall_s": wall_s, "tokens": tokens,
            "tokens_per_s": tokens / wall_s if wall_s > 0 else 0.0,
            "flops_per_step": self.flops.total,
            "tflops_per_device": (self.flops.total / (wall_s * n_dev) / 1e12
                                  if wall_s > 0 else 0.0),
            "mfu": mfu(self.flops.total, wall_s, n_dev, self.machine.peak_flops),
            "predicted": predicted_block(self.prediction),
        }
        for k in ("loss", "moe_aux", "moe_drop", "grad_norm", "loss_scale",
                  "grads_finite"):
            if k in metrics:
                rec[k] = metrics[k]
        if peak_bytes is not None:
            rec["peak_bytes"] = list(peak_bytes)
        if comm_bytes is not None:
            rec["comm_bytes"] = dict(comm_bytes)
        if pipeline is not None:
            rec["pipeline"] = dict(pipeline)
        predicted_s = (self.prediction.step_time_s
                       if self.prediction is not None else 0.0)
        rec["drift"] = self.drift.update(wall_s, predicted_s)
        return self._emit(rec)

    def _emit(self, rec: dict) -> dict:
        rec = sanitize_record(rec)
        validate_record(rec)
        self.records.append(rec)
        if self.sink is not None:
            self.sink.write(rec)
        return rec

    def console_line(self, rec: Mapping[str, Any], *,
                     window: int = 1, with_mfu: bool = True) -> str:
        """The launcher's step line: the prefix the launcher printed before
        telemetry, then ``mfu`` when ``with_mfu``.  ``window`` averages
        throughput over the last N recorded steps (the ``--log-every``
        cadence)."""
        walls = self.step_walls[-window:] or [rec["wall_s"]]
        dt = sum(walls)
        tok_s = self.global_batch * self.seq_len * len(walls) / dt if dt else 0.0
        line = (f"step {rec['step']:5d} loss {rec['loss']:.4f} grad_norm "
                f"{rec['grad_norm']:.4f} {tok_s:,.0f} tok/s")
        if with_mfu:
            w_mfu = mfu(self.flops.total * len(walls), dt, self.plan.n_devices,
                        self.machine.peak_flops)
            line += f" mfu {100.0 * w_mfu:.2f}%"
        return line

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


def pipeline_fields(p: int, m: int, v: int, walks: list[Mapping[str, float]]) -> dict:
    """The measured pipeline of a step at pp > 1: ``walks`` are the
    processes' ``runtime/pipeline.py:walk_reading`` (one a rank, or one
    process that ran every stage in turn).  ``idle_fraction`` is 1 - their
    summed time in stage applications over their summed sweep times: the
    share of the sweep the ranks spent waiting (for a neighbour, or
    between applications), beside the schedule's ``spmd_idle_fraction``
    and the analytic GPipe bubble.  One process running every stage waits
    for no neighbour: its idle share is only the gaps between
    applications."""
    from repro_torch.core import bubble
    from repro_torch.core.pipeline import spmd_idle_fraction

    busy = [float(w["busy_s"]) for w in walks]
    wall = [float(w["wall_s"]) for w in walks]
    return {"applications": sum(int(w["applications"]) for w in walks),
            "busy_s": busy, "wall_s": wall,
            "idle_fraction": 1.0 - sum(busy) / sum(wall) if sum(wall) > 0 else 0.0,
            "spmd_idle_fraction": spmd_idle_fraction(p, m, v),
            "bubble_fraction": bubble.bubble_fraction(p, m, v, schedule="gpipe")
            if v == 1 else bubble.wave_bubble_fraction(p, m, v)}


def predicted_block(prediction: cm.Prediction | None) -> dict:
    """Costmodel prediction as the record's ``predicted`` sub-dict: the
    fields the drift monitor and ``analysis/report.py`` compare against."""
    if prediction is None:
        return {}
    return {
        "step_time_s": prediction.step_time_s,
        "memory_per_gpu": prediction.memory_per_gpu,
        "comm_bytes": dict(prediction.comm_bytes),
        "bubble": prediction.bubble,
        "tflops_per_device": prediction.tflops_per_gpu,
        "moe_drop": prediction.moe_drop,
    }


def plan_dict(plan) -> dict:
    """JSON view of a ParallelPlan (duck-typed; only the schema fields)."""
    out = {}
    for k in ("dp", "tp", "pp", "ep", "node", "virtual_stages", "zero",
              "gas", "qcomm", "overlap", "comm_block", "precision", "remat",
              "kernels", "rules"):
        if hasattr(plan, k):
            out[k] = getattr(plan, k)
    return out


def timed_call(fn, *args):
    """Call ``fn`` and wait for the card to finish it; returns
    ``(outputs, wall_seconds)``: the launcher's per-step timing hook."""
    t0 = time.perf_counter()
    out = fn(*args)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Schema validation
# ---------------------------------------------------------------------------

def validate_record(rec: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` on a record that violates the schema contract."""
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"record schema {rec.get('schema')!r} != {SCHEMA!r}")
    kind = rec.get("kind")
    if kind == "step":
        missing = _STEP_KEYS - rec.keys()
    elif kind == "compile":
        missing = _COMPILE_KEYS - rec.keys()
    elif kind == "request":
        missing = _REQUEST_KEYS - rec.keys()
    else:
        raise ValueError(f"unknown record kind {kind!r}")
    if missing:
        raise ValueError(f"{kind} record missing keys: {sorted(missing)}")
    if kind == "request":
        if rec["n_generated"] < 0 or rec["n_prompt"] <= 0:
            raise ValueError("request record with non-positive token counts")
        t = [rec["t_arrival"], rec["t_admit"], rec["t_first_token"], rec["t_done"]]
        if any(x is None for x in t) or not all(a <= b + 1e-9 for a, b in zip(t, t[1:])):
            raise ValueError(f"request timestamps not monotone: {t}")
    if kind == "step":
        d = rec["drift"]
        for k in ("step_time_ratio", "rolling_ratio", "warn", "threshold"):
            if k not in d:
                raise ValueError(f"drift block missing {k!r}")
        if not (0.0 <= rec["mfu"] <= 1.0):
            raise ValueError(f"mfu {rec['mfu']} outside [0, 1]")
    if kind == "compile":
        if rec["kernels_interpret_mode"] != (rec["backend"] == "cpu"):
            raise ValueError("kernels_interpret_mode must equal "
                             "(backend == 'cpu')")


def validate_jsonl(path: str, *, require_step: bool = True) -> list[dict]:
    """Parse and validate a telemetry JSONL file; returns the records.  By
    default at least one step or request record is required (a run that
    never stepped or finished a request is not a telemetry artifact)."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            validate_record(rec)
            records.append(rec)
    if require_step and not any(r["kind"] in ("step", "request") for r in records):
        raise ValueError(f"{path}: no step or request records")
    return records
