"""Pipeline trace export: Chrome-trace/Perfetto JSON of the realized
schedule (a copy of ``repro/analysis/trace.py``).

The port's pipeline executor (``runtime/pipeline.py``) walks the tick
schedule of ``core/pipeline.py:schedule``, whose tick count is
``spmd_schedule``'s.  This module renders that schedule against *measured*
per-step wall times as a ``chrome://tracing`` / Perfetto-compatible
timeline: one thread lane per pipe rank, one "X" slice per stage
application (microbatch, logical stage, wave in ``args``), one step lane
marking optimizer steps.  Bubbles are the white gaps; by construction the
idle fraction integrated from the trace (:func:`trace_idle_fraction`)
equals the schedule's ``spmd_idle_fraction``, and therefore
``bubble.wave_bubble_fraction`` for ``virtual_stages > 1``: the check
``--check`` runs on real files.  The idle share each step measured (the
ranks' time in stage applications over their sweeps') is in the
telemetry records (``core/telemetry.py:pipeline_fields``).

Produced by ``launch/train.py --trace out.json``; view at
``chrome://tracing`` or https://ui.perfetto.dev.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Iterable, Mapping

from repro_torch.core import bubble
from repro_torch.core.pipeline import spmd_idle_fraction, spmd_schedule

US = 1e6  # chrome trace timestamps are microseconds


def stage_intervals(p: int, m: int, v: int = 1) -> list[dict]:
    """The realized schedule as ``(rank, tick)``-addressed unit intervals.

    v == 1: microbatch ``j`` occupies stage ``s`` (= rank ``s``) at tick
    ``j + s`` over ``m + p - 1`` ticks — the contiguous GPipe-style pass.

    v > 1: microbatches enter in waves of at most ``p``
    (``core/pipeline.py:schedule``'s interleaved path); within a wave starting at
    microbatch ``s0``, microbatch ``s0 + j`` runs logical stage ``l`` on
    rank ``l % p`` at tick ``offset + j + l``; each wave spans
    ``p*v + p - 1`` ticks and drains before the next injects.  Since a
    wave holds at most ``p`` microbatches, no (rank, tick) cell is ever
    double-booked.
    """
    out = []
    if v == 1:
        for j in range(m):
            for s in range(p):
                out.append({"rank": s, "stage": s, "micro": j,
                            "tick": j + s, "wave": 0})
        return out
    S = p * v
    wave_span = S + p - 1
    for w, s0 in enumerate(range(0, m, p)):
        width = min(p, m - s0)
        off = w * wave_span
        for j in range(width):
            for stage in range(S):
                out.append({"rank": stage % p, "stage": stage,
                            "micro": s0 + j, "tick": off + j + stage,
                            "wave": w})
    return out


def pipeline_events(p: int, m: int, v: int, tick_us: float, *,
                    t0_us: float = 0.0, step: int = 0,
                    pid: int = 0) -> list[dict]:
    """Chrome "X" (complete) events for one step's pipeline schedule."""
    events = []
    for iv in stage_intervals(p, m, v):
        events.append({
            "name": f"stage{iv['stage']}", "cat": "stage", "ph": "X",
            "ts": t0_us + iv["tick"] * tick_us, "dur": tick_us,
            "pid": pid, "tid": iv["rank"],
            "args": {"microbatch": iv["micro"], "stage": iv["stage"],
                     "wave": iv["wave"], "step": step},
        })
    return events


def build_trace(p: int, m: int, v: int, step_walls: Iterable[float], *,
                meta: Mapping[str, Any] | None = None) -> dict:
    """Full Chrome-trace object: the (p, m, v) schedule repeated once per
    measured step, each step's schedule scaled so its ticks span that
    step's wall time (measured timings set the time axis; the schedule
    shape is the executor's own).  Steps are laid end to end, so the
    integrated idle fraction of the whole trace equals the per-step one.
    """
    walls = list(step_walls)
    if not walls:
        raise ValueError("build_trace needs at least one measured step wall")
    ticks, _, _ = spmd_schedule(p, m, v)
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": f"pipeline p={p} m={m} v={v}"}},
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "optimizer steps"}},
    ]
    for r in range(p):
        events.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": r,
                       "args": {"name": f"pipe rank {r}"}})
    t0 = 0.0
    for i, wall in enumerate(walls):
        dur = wall * US
        events.append({"name": f"step {i}", "cat": "step", "ph": "X",
                       "ts": t0, "dur": dur, "pid": 1, "tid": 0,
                       "args": {"step": i, "wall_s": wall}})
        events.extend(pipeline_events(p, m, v, dur / ticks,
                                      t0_us=t0, step=i))
        t0 += dur
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "schema": "repro.trace/1",
            "pp": p, "gas": m, "virtual_stages": v,
            "steps": len(walls), "ticks_per_step": ticks,
            "idle_fraction_schedule": spmd_idle_fraction(p, m, v),
            "wave_bubble_fraction": bubble.wave_bubble_fraction(p, m, v),
            "bubble_fraction_gpipe": bubble.bubble_fraction(
                p, m, schedule="gpipe"),
        },
    }
    if meta:
        trace["metadata"].update(dict(meta))
    return trace


def trace_idle_fraction(trace: Mapping[str, Any]) -> float:
    """Idle fraction integrated from the trace's stage slices: 1 - busy
    time over (lanes x span).  The measurement side of the acceptance
    check against ``bubble.wave_bubble_fraction``."""
    all_x = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    evs = [e for e in all_x if e.get("cat") == "stage"]
    if not evs:
        raise ValueError("trace has no stage events")
    lanes = {(e["pid"], e["tid"]) for e in evs}
    # span over *all* complete events: the step lane covers the schedule's
    # trailing idle ticks (a partial last wave has no stage slice there,
    # but its ticks are in the schedule's count)
    start = min(e["ts"] for e in all_x)
    end = max(e["ts"] + e["dur"] for e in all_x)
    span = end - start
    busy = sum(e["dur"] for e in evs)
    if span <= 0:
        raise ValueError("trace span is empty")
    return 1.0 - busy / (len(lanes) * span)


def validate_trace(trace: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` unless ``trace`` is schema-valid Chrome JSON
    with the repro metadata block."""
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("traceEvents must be a non-empty list")
    for i, e in enumerate(evs):
        for k in ("name", "ph", "pid"):
            if k not in e:
                raise ValueError(f"traceEvents[{i}] missing {k!r}")
        if e["ph"] == "X":
            if "ts" not in e or "dur" not in e:
                raise ValueError(f"traceEvents[{i}]: X event needs ts + dur")
            if e["dur"] < 0 or e["ts"] < 0:
                raise ValueError(f"traceEvents[{i}]: negative ts/dur")
    md = trace.get("metadata", {})
    for k in ("schema", "pp", "gas", "virtual_stages",
              "wave_bubble_fraction"):
        if k not in md:
            raise ValueError(f"metadata missing {k!r}")
    if md["schema"] != "repro.trace/1":
        raise ValueError(f"unknown trace schema {md['schema']!r}")
    if not any(e.get("cat") == "stage" for e in evs):
        raise ValueError("trace has no stage events")


def write_trace(trace: Mapping[str, Any], path: str) -> None:
    validate_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f)


def check_trace_file(path: str, tol: float = 0.15) -> dict:
    """Load, schema-validate, and verify the integrated idle fraction
    against the analytic bubble; returns a summary dict (the CLI below
    calls this on real files)."""
    with open(path) as f:
        trace = json.load(f)
    validate_trace(trace)
    md = trace["metadata"]
    measured = trace_idle_fraction(trace)
    analytic = (md["wave_bubble_fraction"] if md["virtual_stages"] > 1
                else bubble.bubble_fraction(md["pp"], md["gas"],
                                            schedule="gpipe"))
    err = abs(measured - analytic) / max(analytic, 1e-12) \
        if analytic > 0 else abs(measured)
    if err > tol:
        raise ValueError(
            f"{path}: integrated idle fraction {measured:.4f} vs analytic "
            f"bubble {analytic:.4f} — relative error {err:.2%} > {tol:.0%}")
    return {"path": path, "idle_fraction": measured,
            "analytic_bubble": analytic, "relative_error": err,
            "events": len(trace["traceEvents"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", required=True, metavar="TRACE_JSON",
                    help="validate schema + idle-vs-analytic-bubble")
    ap.add_argument("--tol", type=float, default=0.15,
                    help="relative tolerance on the idle fraction")
    args = ap.parse_args()
    summary = check_trace_file(args.check, args.tol)
    print(f"{summary['path']}: {summary['events']} events, idle "
          f"{summary['idle_fraction']:.4f} vs analytic "
          f"{summary['analytic_bubble']:.4f} "
          f"(err {summary['relative_error']:.2%}) — OK")


if __name__ == "__main__":
    main()
