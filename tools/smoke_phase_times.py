#!/usr/bin/env python3
"""Seconds per phase of a ``chip_smoke.py`` run, for any checkout.

    python3 tools/smoke_phase_times.py [--repo DIR] [--label NAME] [--timeout S] [--log PATH]

Runs ``python3 -u DIR/chip_smoke.py`` from ``DIR`` (default: this
checkout), stamps each line of its output with the seconds since the start,
and writes the stamped log to ``PATH`` (default ``build/smoke_<label>.log``
in this checkout). Each phase runs from its header line (``phase 3b:
...``) to the next phase's header; phases 13 to 19 take their parts' lines
too (``13a``, ``13b``, ...). Prints
one JSON line: the label, the exit code, the whole run's seconds, the
seconds by phase in the order they ran, and the ``phase N ok in X s`` lines
the script printed (scripts that print none give an empty dict). Works on
a script that logs no seconds of its own, which is how a parent commit's
phases are timed. The exit code is the script's.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HEADER = re.compile(r"^phase (\d+)([a-e]?)[: ]")
OK = re.compile(r"^phase (\w+) ok in ([0-9.]+) s")
PARTS_FROM = 13   # phases whose letters name parts of one phase


def phase_of(line: str):
    """The phase a header line opens, or None."""
    m = HEADER.match(line)
    if m is None or " ok in " in line:
        return None
    n, sub = m.groups()
    return n if int(n) >= PARTS_FROM else n + sub


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="run")
    ap.add_argument("--timeout", type=float, default=1500)
    ap.add_argument("--log", default=None, help="the stamped log's path")
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    log_path = Path(args.log or Path(__file__).resolve().parents[1] / "build"
                    / f"smoke_{args.label}.log")
    log_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", str(repo / "chip_smoke.py")], cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    stamped = []
    with open(log_path, "w") as fh:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            stamped.append((t, line.rstrip("\n")))
            fh.write(f"{t:9.1f} {line}")
            fh.flush()
            if t > args.timeout:
                proc.kill()
                break
    rc = proc.wait()
    total = time.perf_counter() - t0
    seconds, ok, current, since = {}, {}, None, 0.0
    for t, line in stamped:
        m = OK.match(line)
        if m:
            ok[m.group(1)] = float(m.group(2))
        p = phase_of(line)
        if p is not None and p != current:
            if current is not None:
                seconds[current] = seconds.get(current, 0.0) + t - since
            current, since = p, t
    if current is not None:
        end = next((t for t, line in stamped if line.startswith("all phases ok")), total)
        seconds[current] = seconds.get(current, 0.0) + end - since
    print(json.dumps({"label": args.label, "rc": rc, "seconds": round(total, 1),
                      "by_phase": {k: round(v, 1) for k, v in seconds.items()},
                      "ok_lines": ok, "log": str(log_path)}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
