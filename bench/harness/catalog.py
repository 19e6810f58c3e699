"""Everything the harness runs is found by name, in files of its own.

* ``BENCHMARK.json`` at the root: the cells (``workloads``), their
  configuration and traffic names, and the metrics each reports;
* ``bench/configs/<config>.json``: a configuration's sizes, its ``family``;
* ``bench/traffic/<traffic>.json``: a traffic mix's parameters;
* ``bench/arrivals/<arrival>.py``: an arrival process a mix names;
* ``bench/workloads/<cell>.json``: a cell's correctness check (sample size,
  limits) and its trace's spans;
* ``bench/metrics/<metric>.py``: one reader a metric (``read(run)``);
* ``bench/denoisers/<family>.py``, ``bench/reference/<family>.py``,
  ``bench/flops/<family>.py``: a family's program adapter, plain reference
  and FLOP formula.

Adding a configuration, a traffic mix, a cell or a metric adds files and
``BENCHMARK.json`` entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class Catalog:
    """The benchmark under ``root`` (a checkout, or a copy of its
    ``BENCHMARK.json`` and ``bench/``)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "bench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: Dict[str, object] = {}

    # -- names ----------------------------------------------------------

    @staticmethod
    def _check(name: str) -> str:
        if not _NAME.match(name):
            raise ValueError(f"not a benchmark name: {name!r}")
        return name

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{self._check(name)}.json")
                          .read_text())

    def module(self, kind: str, name: str):
        """``bench/<kind>/<name>.py``, loaded once from its path."""
        path = self.dir / kind / f"{self._check(name)}.py"
        key = str(path)
        if key not in self._modules:
            if not path.exists():
                raise FileNotFoundError(f"no {kind} module {path}")
            mod_name = "bench_" + kind + "_" + re.sub(r"\W", "_", name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module
            spec.loader.exec_module(module)
            self._modules[key] = module
        return self._modules[key]

    # -- cells ------------------------------------------------------------

    def cell(self, name: str) -> dict:
        """The cell's ``BENCHMARK.json`` entry merged with its own file."""
        for entry in self.spec["workloads"]:
            if entry["name"] == name:
                return {**self._json("workloads", name), **entry}
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        with ``trace`` 0, its per-layer metrics with 1.  A metric with a
        ``workloads`` list applies to those cells; one without applies to
        every cell (an end-to-end one), or to every cell that reports the
        end-to-end metric it ``moves`` (a per-layer one)."""
        def applies(m, own):
            return cell in m["workloads"] if "workloads" in m else own(m)

        e2e = [m for m in self.spec["end_to_end"]
               if applies(m, lambda _: True)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if applies(m, lambda m: m["moves"] in names)]

    def reader(self, metric: str):
        return self.module("metrics", metric)
