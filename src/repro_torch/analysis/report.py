"""Render a telemetry JSONL stream as a table (the ``telemetry_table`` of
``repro/analysis/report.py``; its roofline and hillclimb tables read the
outputs of ``launch/dryrun.py`` and ``launch/hillclimb.py``, which are not
ported yet: ROADMAP.md, Queue 1).

  PYTHONPATH=src python -m repro_torch.analysis.report --telemetry run.jsonl
"""
from __future__ import annotations

import argparse
import json


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:8.2f} s"
    return f"{x*1e3:7.2f} ms"


def _fmt_bytes(x: float | None) -> str:
    return "—" if x is None else f"{x / 2**30:.2f} GiB"


def telemetry_table(path: str) -> str:
    """A per-step table from a telemetry JSONL stream
    (``core/telemetry.py`` schema: one ``compile`` record, then ``step``
    records carrying tokens/s, MFU, the costmodel drift block and, on a
    card, the ranks' peak memory)."""
    recs = [json.loads(line) for line in open(path) if line.strip()]
    head = next((r for r in recs if r.get("kind") == "compile"), None)
    lines = []
    if head is not None:
        lines.append(
            f"telemetry: {head.get('arch','?')} plan={head.get('plan')} "
            f"gb={head.get('global_batch')} seq={head.get('seq_len')} "
            f"devices={head.get('devices')} backend={head.get('backend')}")
        lines.append("")
    lines += [
        "| step | wall | tokens/s | TFLOP/s/dev | MFU | loss | drift | peak mem |",
        "|---:|---:|---:|---:|---:|---:|---:|---:|",
    ]
    for r in recs:
        if r.get("kind") != "step":
            continue
        d = r.get("drift") or {}
        ratio = d.get("rolling_ratio", d.get("step_time_ratio"))
        drift = "—" if ratio is None else (
            f"{ratio:.2f}x" + (" ⚠" if d.get("warn") else ""))
        loss = r.get("loss")
        peak = max(r["peak_bytes"]) if r.get("peak_bytes") else None
        lines.append(
            f"| {r['step']} | {_fmt_s(r['wall_s'])} | "
            f"{r['tokens_per_s']:,.0f} | {r['tflops_per_device']:.3f} | "
            f"{r['mfu']*100:.2f}% | "
            f"{'—' if loss is None else f'{loss:.4f}'} | {drift} | {_fmt_bytes(peak)} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--telemetry", metavar="JSONL", required=True,
                    help="render a step/MFU/drift table from a telemetry "
                         "JSONL (launch/train.py --log-jsonl output)")
    args = ap.parse_args(argv)
    print(telemetry_table(args.telemetry))


if __name__ == "__main__":
    main()
