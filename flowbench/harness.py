"""The benchmark's run of one cell: set-up, a closed-loop window over the
cell's traffic, an optional traced sub-window, the check of the window's
answers against the plain reference, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the configuration file it names, the traffic file
``flowbench/traffic/<traffic>.json``, the limits of its comparison
``flowbench/limits/<cell>.json``, the adapter of its algorithm
``flowbench/algos/<algo>.py`` and one reader per metric,
``flowbench/metrics/<metric>.py``, whose ``read(record)`` returns the
metric's value or None where it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from flowbench import program, trace
from flowbench.traffic import generator

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ofot_tpu")
PROFILE_TRIES = 4


def forbidden(module_names) -> list[str]:
    """The forbidden packages among ``module_names``, compared by their
    whole top-level name (the part before the first dot)."""
    tops = {name.split(".", 1)[0] for name in module_names}
    return sorted(tops & set(FORBIDDEN))


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with its configuration, traffic, limits
    and metric entries, read from ``root``."""

    def __init__(self, root: Path, name: str, bench: dict | None = None,
                 base: Path = HERE):
        self.root, self.base = Path(root), Path(base)
        self.bench = bench or _json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = _json(self.root / configs[self.entry["config"]]["file"])
        self.traffic = _json(self.base / "traffic"
                             / f"{self.entry['traffic']}.json")
        limits = self.base / "limits" / f"{name}.json"
        self.limits = _json(limits)["numbers"] if limits.exists() else {}

    def metrics(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]

    def algo(self):
        return load_module(self.base / "algos" / f"{self.config['algo']}.py",
                           f"flowbench.algos.{self.config['algo']}")

    def reader(self, metric: str):
        return load_module(self.base / "metrics" / f"{metric}.py",
                           f"flowbench.metrics.{metric}")


def _sample(rng, calls, n: int, batch: int, counter: str):
    """The answers the check compares: ``n`` pairs drawn with ``rng`` from
    the window's, among them the one of most iterations (the longest) and
    both plain and lum pairs; for a lockstep batch, pairs of one batch
    that holds both kinds (each pair's freeze at its own stop), the whole
    batch where ``n`` reaches its size."""
    items = [(c, i) for c in range(len(calls))
             for i in range(len(calls[c]["pairs"]))]
    if batch > 1:
        mixed = [c for c in range(len(calls))
                 if len({p.lum for p in calls[c]["pairs"]}) == 2]
        c = int(rng.choice(mixed or range(len(calls))))
        items = [(c, i) for i in range(len(calls[c]["pairs"]))]
        if n >= len(items):
            return [(calls[c]["pairs"][i], *calls[c]["outs"][i])
                    for _, i in items]
    longest = max(items, key=lambda ci: calls[ci[0]]["outs"][ci[1]][1][
        counter])
    chosen = [longest]
    for lum in (False, True):
        kind = [ci for ci in items if ci not in chosen
                and calls[ci[0]]["pairs"][ci[1]].lum == lum]
        want = (n - len(chosen)) // (2 if not lum else 1)
        for j in rng.permutation(len(kind))[:want]:
            chosen.append(kind[int(j)])
    return [(calls[c]["pairs"][i], *calls[c]["outs"][i]) for c, i in chosen]


def _finite(fields) -> bool:
    return all(np.isfinite(f).all() for f in fields)


class Control:
    """The control in the program's place: each pair of a call solved by
    the algorithm's reference one precision step below the
    configuration's."""

    def __init__(self, algo, config):
        self.algo, self.config = algo, config

    def __call__(self, frames):
        return [self.algo.control(self.config, f1, f2) for f1, f2 in frames]


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", cell: Cell | None = None,
        control: bool = False, min_calls: int = 1):
    """Run one cell; returns the result line's object and every number the
    check computed (those the limits name are the result's ``checks``).
    ``device`` "cpu" runs the same path on the CPU (the tests' form, with
    no device numbers).  ``control``: the control answers in the
    program's place; ``min_calls``: the window runs at least this many
    calls."""
    import torch

    cell = cell or Cell(root, workload)
    program.load(root)
    algo = cell.algo()
    config, traffic = cell.config, cell.traffic
    batch = traffic["batch"]
    pool = generator.make_pool(traffic)
    frames = [tuple(torch.as_tensor(f, device=device) for f in (p.f1, p.f2))
              for p in pool]
    solve = (Control(algo, config) if control
             else algo.Program(config, traffic, device))
    stream = generator.order(seed, len(pool))

    def call(idx):
        return solve([frames[i] for i in idx])

    loops0 = program.loop_stats()
    if not control:
        call(list(range(batch)))                  # warm-up: the cell's shapes
    if device != "cpu":
        torch.cuda.synchronize()
    loops1 = program.loop_stats()

    calls = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    while time.perf_counter() < deadline or len(calls) < min_calls:
        idx = [next(stream) for _ in range(batch)]
        start = time.perf_counter()
        outs = call(idx)
        end = time.perf_counter()
        calls.append({"start": start, "end": end, "idx": idx,
                      "pairs": [pool[i] for i in idx], "outs": outs})
    memory_peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                   else 0)

    profile = None
    if traced:
        sub = [[next(stream) for _ in range(batch)]
               for _ in range(traffic["profile_calls"])]
        recs = []
        for _ in range(PROFILE_TRIES):
            rec = trace.profile_calls(call, sub, program.launch_counts)
            if trace.complete(rec, *recs):
                profile = rec
                break
            recs.append(rec)
        if profile is None:
            profile = trace.fullest(recs)
            print(f"flowbench: none of {len(recs)} traced sub-windows "
                  "proved complete (kernel records "
                  f"{[trace.total_records(r) for r in recs]}, #1 records "
                  f"missing {[trace.missing(r) for r in recs]}); the "
                  "fullest is kept", file=sys.stderr)

    record = {
        "config": config, "traffic": traffic, "setup_s": setup_s, "calls": [
            {"start": c["start"], "end": c["end"], "pairs": len(c["idx"]),
             "counters": [o[1] for o in c["outs"]]} for c in calls],
        "setup_loop": {k: loops1[k] - loops0[k] for k in loops1},
        "profile": profile, "device_kind": (
            torch.cuda.get_device_name(0) if device != "cpu" else "cpu"),
    }

    # the program's state goes before the reference runs
    program.free()
    del solve, frames
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    attempted = sum(len(c["idx"]) for c in calls)
    failed = sum(not _finite(o[0]) for c in calls for o in c["outs"])
    rng = np.random.default_rng([seed, 2])
    sample = _sample(rng, calls, traffic["check_sample"], batch, algo.COUNTER)
    numbers = algo.check(config, sample, device)
    # only the numbers that the cell's limits name are compared (a cell
    # with no limits file compares nothing and is not correct)
    checks = {k: {"value": v, "limit": cell.limits[k]["limit"]}
              for k, v in numbers.items() if k in cell.limits}
    correct = (failed == 0 and bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = cell.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": record["device_kind"], "count": cell.entry["chips"],
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        result["breakdown"] = trace.breakdown(profile)
    result["checks"] = checks
    return result, numbers


def check_lines(result) -> list[str]:
    """Each number compared beside its limit, one line each."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in result["checks"].items()]
