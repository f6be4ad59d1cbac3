"""One cell of ``BENCHMARK.json`` run as ``flowbench/run.py`` runs it, with
the program's spans and counters on from set-up to the end:

    python3 flowbench/spanrun.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The last line of standard output is run.py's result line, plus:
``--trace 1`` the nine span metrics of ``flowbench/spans.py`` that the
cell reports among its per-layer metrics, and in ``breakdown`` the traced
sub-window's ``idle_by_span``, its ``idle_s`` and the clock ``anchors``;
always ``spans``: the program's ``device_loop.launch`` spans and the
device loop's replays counted over the run (equal where nothing was
dropped), and the ring's ``dropped`` count.  ``--trace 0`` measures the
end-to-end metrics with spans on, against run.py's with them off.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cell_class(harness, spans):
    class SpanCell(harness.Cell):
        """The cell, with the span metrics among its per-layer ones."""

        def metrics(self, kind):
            found = super().metrics(kind)
            if kind == "per_layer":
                found += [m for m in spans.METRICS
                          if self.name in m["workloads"]]
            return found

        def reader(self, metric):
            if metric in spans.READERS:
                return SimpleNamespace(read=spans.READERS[metric])
            return super().reader(metric)
    return SpanCell


def _with_spans(trace, spans, program_spans):
    """Route the harness's trace reduction through ``spans.reduce`` and
    its breakdown past the idle gaps by span."""
    plain, breakdown = trace.reduce, trace.breakdown

    def reduce(events):
        return spans.reduce(events, program_spans().spans, plain)

    def with_idle_by_span(rec, top=10):
        out = breakdown(rec, top)
        out.update({k: rec[k] for k in ("idle_by_span", "idle_s", "anchors")
                    if k in rec})
        return out

    trace.reduce = reduce
    trace.breakdown = with_idle_by_span


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from flowbench import harness, program, run, spans, trace

    args = run.parse(argv)
    import torch
    torch.set_num_threads(4)
    if not torch.cuda.is_available():
        return run.fail("no CUDA device: the benchmark measures the card "
                        "only")
    try:
        program.load(ROOT)
    except program.ProgramMissing as e:
        return run.fail(str(e))
    from ofot_tpu_torch.utils import trace as program_trace
    from ofot_tpu_torch.solvers import device_loop

    cell = _cell_class(harness, spans)(ROOT, args.workload)
    _with_spans(trace, spans, program_trace.spans)
    replays = device_loop.stats.replays
    program_trace.enable(True)
    result, _ = harness.run(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START, cell=cell)
    program_trace.enable(False)
    got = program_trace.spans()
    result["spans"] = {
        "launch_spans": sum(s.name == "device_loop.launch"
                            for s in got.spans),
        "replays": device_loop.stats.replays - replays,
        "dropped": got.dropped}
    found = harness.forbidden(list(sys.modules))
    if found:
        return run.fail(f"modules of {', '.join(found)} are loaded in this "
                        "process")
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
