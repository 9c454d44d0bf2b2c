"""What each test file costs the tier-1 run, and where that cost lands.

The tier-1 command (ROADMAP.md, "Tier-1 verify") runs the suite over 6
workers with ``--dist loadfile``.  The scheduler hands out whole files in
descending order of their test count (ties keep collection order), and a
worker takes its next file once 2 or fewer of its tests are pending.  So
two sums bound the wall time:

  * bound A: the worker-seconds handed out before ``tests/test_pipeline.py``
    (the JAX pipeline file, the suite's longest), over 6, plus that
    file's own seconds;
  * bound B: the worker-seconds handed out before ``tests/test_behavior.py``
    (one of the last two files handed out), which grows with the whole
    suite.

This script reads the junit XML of a run and, optionally, the collected
ids (the output of the same pytest command with ``--collect-only -q``),
a ``-v`` log of the run whose lines start with the seconds since the run
began, process snapshots taken during the run, and the machine's CPU
counters before and after it.  It runs nothing.

    python tests/torch_test_budget.py RUN.xml [--collect IDS.txt]
        [--log RUN.log] [--ps PS.txt] [--stat STAT.txt]

``PS.txt`` holds blocks of ``== <seconds>`` followed by one line per
process, ``<pid> <parent pid> <command line>``; a gloo rank is a process
started by ``multiprocessing``'s spawn (its command line holds
``spawn_main``).  ``STAT.txt`` holds the kernel's aggregate ``cpu``
counter line (user, nice, system, idle, iowait, irq, softirq, steal, in
clock ticks) taken before the run and again after it; the difference
gives the CPU seconds the host took from this machine (steal) and those
left idle, which move the wall between runs of the same tree.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import sys
import xml.etree.ElementTree as ET

WORKERS = 6
PIPELINE = "tests/test_pipeline.py"
BEHAVIOR = "tests/test_behavior.py"
PORT_PREFIX = "tests/test_torch_"


def _file_of(nodeid: str) -> str:
    return nodeid.split("::", 1)[0]


def junit_seconds(path: str) -> tuple[dict, dict]:
    """Per file: the summed seconds and the number of test cases."""
    secs, counts = collections.Counter(), collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname", "")
        # classname is the dotted module path, with a class appended when
        # the test sits in one
        parts = name.split(".")
        while parts and not parts[-1].startswith("test_"):
            parts.pop()
        path_ = "/".join(parts) + ".py"
        secs[path_] += float(case.get("time", 0.0))
        counts[path_] += 1
    return secs, counts


def collected_counts(path: str) -> dict:
    """Per file, in collection order: the number of collected ids."""
    counts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if "::" not in line or " " in line:
                continue
            counts[_file_of(line)] = counts.get(_file_of(line), 0) + 1
    return counts


def dispatch_order(counts: dict) -> list:
    """Files in the order the scheduler hands them out."""
    return sorted(counts, key=lambda f: -counts[f])


def timeline(path: str) -> dict:
    """Per file from a timestamped ``-v`` log: (worker, first second,
    last second)."""
    pat = re.compile(r"^\s*([0-9.]+)\s+(?:\[(gw\d+)\]\s+\[\s*\d+%\]\s+\w+\s+)?"
                     r"(tests/\S+?\.py)::")
    out = {}
    with open(path, errors="replace") as f:
        for line in f:
            if out and "=====" in line:
                break               # the summaries after the last test
            m = pat.match(line)
            if not m:
                continue
            t, worker, name = float(m.group(1)), m.group(2), m.group(3)
            w, t0, t1 = out.get(name, (None, t, t))
            out[name] = (w or worker, min(t0, t), max(t1, t))
    return out


def rank_processes(path: str) -> dict:
    """From process snapshots: the gloo ranks seen, the most alive at
    once, the most alive at once under one parent (one test worker, so one
    test module), and the most processes of any kind at once."""
    seen, most, most_one_parent, most_all = set(), 0, 0, 0
    snap = []

    def close():
        nonlocal most, most_one_parent, most_all
        ranks = [(pid, ppid) for pid, ppid, args in snap
                 if "spawn_main" in args]
        seen.update(pid for pid, _ in ranks)
        most = max(most, len(ranks))
        per_parent = collections.Counter(ppid for _, ppid in ranks)
        most_one_parent = max([most_one_parent, *per_parent.values()])
        most_all = max(most_all, len(snap))

    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("=="):
                close()
                snap = []
                continue
            parts = line.split(None, 2)
            if len(parts) == 3 and parts[0].isdigit():
                snap.append((int(parts[0]), int(parts[1]), parts[2]))
    close()
    return {"ranks_spawned": len(seen), "ranks_at_once": most,
            "ranks_at_once_one_module": most_one_parent,
            "processes_at_once": most_all}


def cpu_counters(path: str) -> dict:
    """Seconds of CPU stolen by the host and left idle between the first
    and the last ``cpu`` counter line in ``path``."""
    with open(path) as f:
        rows = [[int(v) for v in line.split()[1:]] for line in f
                if line.startswith("cpu ")]
    first, last = rows[0], rows[-1]
    hz = os.sysconf("SC_CLK_TCK")
    # fields: user nice system idle iowait irq softirq steal ...
    return {"cpu_stolen_s": (last[7] - first[7]) / hz,
            "cpu_idle_s": (last[3] - first[3]) / hz}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--collect", help="output of --collect-only -q")
    ap.add_argument("--log", help="-v log, each line led by its second")
    ap.add_argument("--ps", help="process snapshots taken during the run")
    ap.add_argument("--stat", help="the cpu counter line, before and after")
    args = ap.parse_args(argv)

    secs, junit_counts = junit_seconds(args.junit)
    counts = (collected_counts(args.collect) if args.collect
              else dict(sorted(junit_counts.items())))
    order = dispatch_order(counts)
    times = timeline(args.log) if args.log else {}

    print(f"{'pos':>4} {'tests':>5} {'junit_s':>9} {'worker':>6} "
          f"{'start':>7} {'end':>7}  file")
    for pos, name in enumerate(order, 1):
        w, t0, t1 = times.get(name, ("-", float("nan"), float("nan")))
        print(f"{pos:4d} {counts[name]:5d} {secs.get(name, 0.0):9.1f} "
              f"{w or '-':>6} {t0:7.1f} {t1:7.1f}  {name}")

    def before(target):
        if target not in order:
            return float("nan")
        return sum(secs.get(f, 0.0) for f in order[:order.index(target)])

    a, b = before(PIPELINE), before(BEHAVIOR)
    port = sum(s for f, s in secs.items() if f.startswith(PORT_PREFIX))
    print(f"junit sum, every file: {sum(secs.values()):.1f} s")
    print(f"junit sum, port files ({PORT_PREFIX}*): {port:.1f} s")
    print(f"bound A: {a:.1f} worker-s before {PIPELINE} "
          f"({a / WORKERS:.1f} s over {WORKERS} workers) + "
          f"{secs.get(PIPELINE, 0.0):.1f} s of its own = "
          f"{a / WORKERS + secs.get(PIPELINE, 0.0):.1f} s")
    print(f"bound B: {b:.1f} worker-s before {BEHAVIOR} "
          f"({b / WORKERS:.1f} s over {WORKERS} workers)")
    if times:
        print(f"log: last test line at "
              f"{max(t1 for _, _, t1 in times.values()):.1f} s")
    if args.ps:
        for key, val in rank_processes(args.ps).items():
            print(f"{key}: {val}")
    if args.stat:
        for key, val in cpu_counters(args.stat).items():
            print(f"{key}: {val:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
