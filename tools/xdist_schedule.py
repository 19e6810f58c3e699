"""Replay a test run's JUnit XML through pytest-xdist's ``--dist loadfile``
schedule, to see which files set the wall time of a parallel run.

``loadfile`` hands out whole files.  With its default ``--loadscope-reorder``
it queues them by their number of tests, most first, so a heavy file with few
tests starts last and sets the tail.  Each worker starts with two files and
takes the next one from the queue whenever two or fewer of its tests are
left.  This script runs that queue over the tests' recorded times (which
hold the run's contention, but no start-up or collection: an estimate) and
prints the simulated wall, each worker's end time and the files above
``--show`` seconds it ran.

``--merge SRC=DST`` counts file SRC's tests as DST's, and
``--split FILE:SUBSTR=NEW`` moves FILE's tests whose name holds SUBSTR into
file NEW (made if it is missing); both may repeat, so a split or a merge
can be tried before the tests are moved.  Run from the repo root:

    python tools/xdist_schedule.py run.xml --workers 6
    python tools/xdist_schedule.py run.xml \\
        --merge tests/test_b.py=tests/test_a.py
"""
from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def load(path: str) -> "collections.OrderedDict[str, list]":
    """file -> [(test name, seconds)], from a JUnit XML of pytest."""
    files: "collections.OrderedDict[str, list]" = collections.OrderedDict()
    for case in ET.parse(path).iter("testcase"):
        name = case.get("classname", "").replace(".", "/") + ".py"
        files.setdefault(name, []).append(
            (case.get("name"), float(case.get("time") or 0.0)))
    return files


def simulate(files, workers: int):
    """(wall, [(end time, [file, ...]) a worker]) of the loadfile queue."""
    queue = collections.deque(sorted(sorted(files),
                                     key=lambda f: -len(files[f])))
    nodes = [{"t": 0.0, "pending": collections.deque(), "files": []}
             for _ in range(workers)]

    def assign(node):
        if queue:
            name = queue.popleft()
            node["files"].append(name)
            node["pending"].extend(t for _, t in files[name])

    for node in nodes:
        assign(node)
    for node in nodes:
        if len(node["pending"]) <= 2:
            assign(node)
    while any(n["pending"] for n in nodes):
        node = min((n for n in nodes if n["pending"]), key=lambda n: n["t"])
        node["t"] += node["pending"].popleft()
        if len(node["pending"]) <= 2:
            assign(node)
    return (max(n["t"] for n in nodes),
            [(n["t"], n["files"]) for n in nodes])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--merge", action="append", default=[],
                    metavar="SRC=DST")
    ap.add_argument("--split", action="append", default=[],
                    metavar="FILE:SUBSTR=NEW")
    ap.add_argument("--show", type=float, default=60.0,
                    help="list a worker's files above this many seconds")
    args = ap.parse_args(argv)
    files = load(args.xml)
    for spec in args.merge:
        src, dst = spec.split("=")
        files.setdefault(dst, []).extend(files.pop(src))
    for spec in args.split:
        head, new = spec.split("=")
        name, sub = head.split(":", 1)
        files.setdefault(new, []).extend(
            t for t in files[name] if sub in t[0])
        files[name] = [t for t in files[name] if sub not in t[0]]
    total = sum(t for tests in files.values() for _, t in tests)
    wall, nodes = simulate(files, args.workers)
    print(f"simulated wall {wall:.1f} s; {total:.1f} s of test time over "
          f"{args.workers} workers ({total / args.workers:.1f} s each if "
          f"even); {len(files)} files")
    for end, names in nodes:
        big = [f"{n} ({sum(t for _, t in files[n]):.0f} s, "
               f"{len(files[n])} tests)" for n in names
               if sum(t for _, t in files[n]) > args.show]
        print(f"  worker ends {end:.1f} s: {', '.join(big)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
