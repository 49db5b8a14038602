"""Tables from the records the port writes (the port of
``repro/analysis/report.py``): the dry run's roofline table
(``launch/dryrun.py --out``), the hillclimb's (``launch/hillclimb.py
--out``) and a telemetry JSONL stream's per-step table (``launch/train.py
--log-jsonl``).  The roofline and hillclimb tables render the reference's
records as well: the two tools write the same keys.

  PYTHONPATH=src python -m repro_torch.analysis.report        # both tables
  PYTHONPATH=src python -m repro_torch.analysis.report --telemetry run.jsonl
"""
from __future__ import annotations

import argparse
import json
import os

RESULTS = "results"
SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def _load(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    return [json.loads(line) for line in open(path) if line.strip()]


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:8.2f} s"
    return f"{x*1e3:7.2f} ms"


def _fmt_bytes(x: float | None) -> str:
    return "—" if x is None else f"{x / 2**30:.2f} GiB"


def roofline_table(path: str = os.path.join(RESULTS, "dryrun_single.json")) -> str:
    """The dry run's records (one JSON object a line) as a table: per
    (arch, shape) the three roofline terms, the dominant one and the useful
    FLOPs ratio."""
    recs = _load(path)
    lines = [
        "| arch | shape | compute | memory | collective | dominant | useful |",
        "|---|---|---:|---:|---:|---|---:|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9))):
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"*skipped: sub-quadratic path required* | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | |")
            continue
        t = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(t['compute_s'])} | "
            f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {(r['useful_flops_ratio'] or 0):.3f} |")
    return "\n".join(lines)


def hillclimb_table(path: str = os.path.join(RESULTS, "hillclimb.json")) -> str:
    """The hillclimb's records as a table: per (pair, variant) the roofline
    terms, or the refusal's first 40 characters."""
    recs = _load(path)
    lines = [
        "| pair | variant | compute | memory | collective | dominant | useful |",
        "|---|---|---:|---:|---:|---|---:|",
    ]
    for r in recs:
        if r.get("status") not in (None, "ok"):
            lines.append(f"| {r.get('pair','?')} | {r.get('variant','?')} | "
                         f"ERROR {r.get('error','')[:40]} | | | | |")
            continue
        t = r["roofline"]
        tag = r.get("tag", "")
        pair = tag.split(":")[0] if ":" in tag else r["arch"]
        lines.append(
            f"| {pair} | {r.get('variant','?')} | {_fmt_s(t['compute_s'])} | "
            f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
            f"{t['dominant']} | {(r['useful_flops_ratio'] or 0):.3f} |")
    return "\n".join(lines)


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
    ap.add_argument("--telemetry", metavar="JSONL", default=None,
                    help="render a step/MFU/drift table from a telemetry "
                         "JSONL (launch/train.py --log-jsonl output)")
    ap.add_argument("--dryrun", default=os.path.join(RESULTS, "dryrun_single.json"),
                    help="the dry run's records (launch/dryrun.py --out)")
    ap.add_argument("--hillclimb", default=os.path.join(RESULTS, "hillclimb.json"),
                    help="the hillclimb's records (launch/hillclimb.py --out)")
    args = ap.parse_args(argv)
    if args.telemetry:
        print(telemetry_table(args.telemetry))
        return
    print(roofline_table(args.dryrun))
    print()
    print(hillclimb_table(args.hillclimb))


if __name__ == "__main__":
    main()
