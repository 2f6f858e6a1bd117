"""`BENCHMARK.json` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, so a later change adds a cell by adding files and
entries, and edits none:

  <paths[0]>/configs/<config>.json   (the configuration's `file`)
  <paths[0]>/traffic/<traffic>.json  a traffic mix: parameters only
  <paths[0]>/metrics/<metric>.py     a reader: read(record) -> number or
                                     None (nothing to read: left out)

`validate` holds the manifest to the benchmark's contract as far as one
file can show it; `run.py` refuses a manifest that fails it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"host_clock", "device_trace"}
BOUND_MAX = 0.25


class Bench:
    """A parsed `BENCHMARK.json` under `root`, and its files by name."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.m = json.load(f)
        self.home = self.m["paths"][0]

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.root, *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for c in self.m["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.m["configs"] if c["name"] == name)
        return self._json(entry["file"])

    def traffic_path(self, name: str) -> str:
        return os.path.join(self.root, self.home, "traffic", f"{name}.json")

    def traffic(self, name: str) -> dict:
        return self._json(self.traffic_path(name))

    def reader_path(self, metric: str) -> str:
        return os.path.join(self.root, self.home, "metrics", f"{metric}.py")

    def reader(self, metric: str):
        """The `read` function of the metric's reader file."""
        path = self.reader_path(metric)
        spec = importlib.util.spec_from_file_location(
            f"_bench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', metric)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics `cell` reports."""
        return [m for m in self.m["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics `cell` reports: those that list it, and
        those that list no cells and move a metric the cell reports."""
        own = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.m["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in own)]


def _line(s, most: int = 200) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= most
            and "\n" not in s and "\t" not in s)


def validate(bench: Bench) -> list[str]:
    """What in the manifest breaks the contract; empty when nothing does."""
    m, root, bad = bench.m, bench.root, []

    def need(ok, what):
        if not ok:
            bad.append(what)

    need(set(m) == TOP_KEYS, f"top-level keys {sorted(m)}")
    paths = m.get("paths", [])
    need(1 <= len(paths) <= 16 and all(
        PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        for p in paths), f"paths {paths}")
    cmd = m.get("command", [])
    need(1 <= len(cmd) <= 32 and all(_line(w) for w in cmd),
         f"command {cmd}")
    rs = m.get("run_seconds")
    need(isinstance(rs, int) and 1 <= rs <= 51, f"run_seconds {rs}")

    def under_paths(p):
        return any(p.startswith(d.rstrip("/") + "/") for d in paths)

    names = [x.get("name") for k in ("configs", "workloads", "end_to_end",
                                     "per_layer") for x in m.get(k, [])]
    for n in names:
        need(isinstance(n, str) and NAME.fullmatch(n), f"name {n!r}")
    metric_names = [x["name"] for k in ("end_to_end", "per_layer")
                    for x in m.get(k, [])]
    need(len(set(metric_names)) == len(metric_names), "a metric name twice")

    configs = m.get("configs", [])
    need(1 <= len(configs) <= 24, "1 to 24 configs")
    need(len({c["name"] for c in configs}) == len(configs),
         "a config name twice")
    need(len({c["file"] for c in configs}) == len(configs),
         "a config file twice")
    for c in configs:
        need(set(c) == CONFIG_KEYS, f"config {c.get('name')} keys {sorted(c)}")
        need(_line(c.get("source")) and _line(c.get("why")),
             f"config {c['name']} source or why")
        f = c.get("file", "")
        need(under_paths(f) and os.path.isfile(os.path.join(root, f)),
             f"config {c['name']} file {f}")
        red = c.get("reduced", [])
        need(len(red) <= 16 and all(NAME.fullmatch(k) for k in red),
             f"config {c['name']} reduced {red}")

    cells = m.get("workloads", [])
    need(1 <= len(cells) <= 24, "1 to 24 workloads")
    need(len({c["name"] for c in cells}) == len(cells), "a cell name twice")
    need(len({(c["config"], c["traffic"]) for c in cells}) == len(cells),
         "a pair of config and traffic twice")
    need(sum(c.get("chips") == 4 for c in cells) <= max(1, len(cells) // 4),
         "too many four-chip cells")
    config_names = {c["name"] for c in configs}
    for c in cells:
        need(set(c) == CELL_KEYS, f"cell {c.get('name')} keys {sorted(c)}")
        need(c.get("chips") in (1, 4), f"cell {c['name']} chips")
        need(c.get("config") in config_names, f"cell {c['name']} config")
        need(NAME.fullmatch(c.get("traffic", "")) and os.path.isfile(
            bench.traffic_path(c["traffic"])), f"cell {c['name']} traffic")
        need(_line(c.get("why")), f"cell {c['name']} why")
    used = {c["config"] for c in cells}
    need(config_names <= used, f"configs no cell uses: {config_names - used}")

    cell_names = {c["name"] for c in cells}
    e2e = m.get("end_to_end", [])
    need(1 <= len(e2e) <= 16, "1 to 16 end-to-end metrics")
    need(any(x["name"] == "setup_s" for x in e2e), "no setup_s")
    for x in e2e:
        need(set(x) - {"workloads"} == E2E_KEYS,
             f"metric {x['name']} keys {sorted(x)}")
        need(x.get("source") in E2E_SOURCES, f"metric {x['name']} source")
        b = x.get("bound")
        need(isinstance(b, (int, float)) and 0.01 <= b <= BOUND_MAX,
             f"metric {x['name']} bound {b}")
    layers = m.get("per_layer", [])
    need(1 <= len(layers) <= 128, "1 to 128 per-layer metrics")
    e2e_names = {x["name"] for x in e2e}
    for x in layers:
        need(set(x) - {"workloads"} == LAYER_KEYS,
             f"metric {x['name']} keys {sorted(x)}")
        need(x.get("source") in SOURCES, f"metric {x['name']} source")
        need(_line(x.get("layer")), f"metric {x['name']} layer")
        need(x.get("moves") in e2e_names, f"metric {x['name']} moves")
        if x["name"].endswith("_roofline"):
            need(x["unit"] == "%", f"metric {x['name']} unit")
    for x in e2e + layers:
        need(UNIT.fullmatch(x.get("unit", "")), f"metric {x['name']} unit")
        need(x.get("better") in ("lower", "higher"),
             f"metric {x['name']} better")
        for c in x.get("workloads", []):
            need(c in cell_names, f"metric {x['name']} lists {c}")
        need(os.path.isfile(bench.reader_path(x["name"])),
             f"metric {x['name']} has no reader")
    for c in cell_names:
        own = {x["name"] for x in bench.end_to_end(c)}
        need("setup_s" in own and len(own) >= 2,
             f"cell {c} reports no end-to-end metric beside setup_s")
        need(bench.per_layer(c), f"cell {c} reports no per-layer metric")
        for x in layers:
            if c in x.get("workloads", ()):
                need(x["moves"] in own, f"metric {x['name']} in {c}: "
                                        f"{x['moves']} is not reported there")
    return bad
