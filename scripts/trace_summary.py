"""Reduce a ``jax.profiler`` trace to device time per XLA program and per
named scope.

    python scripts/trace_summary.py TRACE_DIR [--hlo HLO_DUMP_DIR]

TRACE_DIR is what ``jax.profiler.trace`` wrote (``chip_smoke.py --trace``);
the newest ``*.xplane.pb`` under it is read.  Kernel events are those on
the device planes (``/device:GPU:N``) that carry an ``hlo_op`` stat; a
trace with no device plane is refused.  Attribution to the codec's
``jax.named_scope`` names (``dwt_quantize``, ``cut_search_eval``,
``decode_reconstruct``) needs the optimized HLO text of the same run
(``XLA_FLAGS="--xla_dump_to=DIR --xla_dump_hlo_as_text"``): each kernel's
``hlo_op`` is looked up there for its ``op_name`` metadata.

Prints one JSON object: the trace window, the device busy time (union of
kernel intervals), kernel time per program and per scope, and the lines
the kernels came from.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict

SCOPES = ("dwt_quantize", "cut_search_eval", "decode_reconstruct")

_INSTR = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*op_name="([^"]*)"')


def op_names(hlo_dir: str) -> dict:
    """(module name, instruction name) -> op_name, from XLA's text dumps."""
    out = {}
    for path in glob.glob(os.path.join(hlo_dir, "*after_optimizations.txt")):
        base = os.path.basename(path)
        m = re.match(r"module_\d+\.(.+?)\.(?:sm_[\d.]+_gpu_|cpu_)?"
                     r"after_optimizations\.txt$", base)
        if not m:
            continue
        module = m.group(1)
        with open(path) as f:
            for line in f:
                hit = _INSTR.match(line)
                if hit:
                    out[(module, hit.group(1))] = hit.group(2)
    return out


def kernel_events(xplane_path: str):
    """-> (events [(start_ns, dur_ns, module, op)], line names used)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    planes = list(pd.planes)
    dev = [p for p in planes if p.name.startswith("/device:")]
    if not dev:
        raise SystemExit(f"{xplane_path} has no /device: plane; planes: "
                         f"{sorted(p.name for p in planes)}")
    events, lines = [], defaultdict(int)
    for plane in dev:
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if "hlo_op" not in st:
                    continue
                events.append((ev.start_ns, ev.duration_ns,
                               st.get("hlo_module", "?"), st["hlo_op"]))
                lines[f"{plane.name} | {line.name}"] += 1
    return events, dict(lines)


def busy_ns(events) -> float:
    total, end = 0.0, None
    for s, d, _, _ in sorted(events):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(trace_dir: str, hlo_dir: str | None = None) -> dict:
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise SystemExit(f"no .xplane.pb under {trace_dir}")
    events, lines = kernel_events(paths[-1])
    if not events:
        raise SystemExit("trace holds no kernel events")
    names = op_names(hlo_dir) if hlo_dir else {}
    per_module = defaultdict(float)
    per_scope = defaultdict(float)
    unmapped = 0
    for _, d, module, op in events:
        per_module[module] += d
        name = names.get((module, op))
        if name is None:
            unmapped += 1
            continue
        scope = next((s for s in SCOPES if s in name), "other")
        per_scope[scope] += d
    t0 = min(s for s, _, _, _ in events)
    t1 = max(s + d for s, d, _, _ in events)
    ms = lambda ns: round(ns / 1e6, 3)
    return {
        "xplane": paths[-1],
        "kernel_window_ms": ms(t1 - t0),
        "device_busy_ms": ms(busy_ns(events)),
        "kernels": len(events),
        "kernel_ms_by_program": {k: ms(v) for k, v in sorted(
            per_module.items(), key=lambda kv: -kv[1])},
        "kernel_ms_by_scope": {k: ms(v) for k, v in per_scope.items()},
        "kernels_without_hlo_metadata": unmapped if hlo_dir else None,
        "lines": lines,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--hlo", help="XLA text dump directory of the same run")
    args = ap.parse_args(argv)
    print(json.dumps(summarize(args.trace_dir, args.hlo), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
