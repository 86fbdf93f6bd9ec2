#!/usr/bin/env python3
"""Model the wall time of a ``pytest -n W --dist loadfile`` run from the
``--durations=0`` report of an earlier run.

    python3 tools/tier1_schedule.py run.log                      # as it ran
    python3 tools/tier1_schedule.py run.log tests/test_x.py=0.5  # x at half

pytest-xdist's loadfile scheduler sends each test file whole to one worker,
in the order of the files' test counts, largest first (ties in collection
order, which this model takes as path order), and a worker takes the next
file when it is nearly idle. The model hands each file, in that order, to
the worker that frees first, and prints the makespan, the files that end
last, and each worker's chain of files of 20 s or more. ``FILE=FRACTION``
scales one file's time, to see how far a cut moves the whole run: a file
that is not on the last worker's chain moves it little.
"""
from __future__ import annotations

import argparse
import collections
import heapq
import re

LINE = re.compile(r"\s*([\d.]+)s (call|setup|teardown)\s+(\S+)")


def durations(path: str) -> tuple[dict, dict]:
    """Seconds and test count by file, from a ``--durations=0`` report."""
    secs, tests = collections.Counter(), collections.Counter()
    with open(path) as f:
        for line in f:
            m = LINE.match(line)
            if m:
                name = m.group(3).split("::")[0]
                secs[name] += float(m.group(1))
                tests[name] += m.group(2) == "call"
    return secs, tests


def schedule(files: list, secs: dict, workers: int) -> tuple[float, dict]:
    """(makespan, file -> (start, worker)) of files handed out in order."""
    free = [(0.0, w) for w in range(workers)]
    start = {}
    for name in files:
        t, w = heapq.heappop(free)
        start[name] = (t, w)
        heapq.heappush(free, (t + secs[name], w))
    return max(t for t, _ in free), start


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log", help="a pytest log with --durations=0")
    ap.add_argument("scale", nargs="*", help="FILE=FRACTION: scale one file's time")
    ap.add_argument("-n", "--workers", type=int, default=6)
    args = ap.parse_args()
    secs, tests = durations(args.log)
    files = sorted(secs, key=lambda f: (-tests[f], f))
    span, start = schedule(files, secs, args.workers)
    print(f"{len(files)} files, {sum(secs.values()):.1f} test-seconds over {args.workers} "
          f"workers: makespan {span:.1f} s")
    for name in sorted(files, key=lambda f: -(start[f][0] + secs[f]))[:5]:
        print(f"  ends {start[name][0] + secs[name]:7.1f}  starts {start[name][0]:7.1f}  "
              f"{secs[name]:6.1f} s  {tests[name]:3d} tests  worker {start[name][1]}  {name}")
    for w in range(args.workers):
        chain = [f"{name.rsplit('/', 1)[-1]} {secs[name]:.0f}" for name in files
                 if start[name][1] == w and secs[name] >= 20]
        print(f"  worker {w}: " + ", ".join(chain))
    if args.scale:
        scaled = dict(secs)
        for item in args.scale:
            name, frac = item.rsplit("=", 1)
            scaled[name] = secs[name] * float(frac)
        print(f"scaled: makespan {schedule(files, scaled, args.workers)[0]:.1f} s")


if __name__ == "__main__":
    main()
