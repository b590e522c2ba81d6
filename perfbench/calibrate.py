"""Readings that the check's limits are set from, for one cell, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 3,4,5] [--out readings.json]

For each of ``--seeds``: the cell's set-up from that seed and its window up
to the checked request, then the check (the program's readings: the lower
ends).  For each of ``--control-seeds``: the check with the reference
computed one precision below the configuration (an fp8 trunk, and heads in
TF32 where the configuration states fp32 with TF32 off) in the program's
place (the upper ends).  Prints one JSON object; writes it to ``--out``
after every reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from perfbench import harness
    from perfbench.reference import precision

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    bench = harness.read_json(CHECKOUT / "BENCHMARK.json")
    cell, config, traffic = harness.cell_spec(bench, args.workload)
    entry = harness.load_file(harness.BENCH_DIR / "entries" / f"{traffic['entry']}.py",
                              "perfbench_entry")
    device = torch.device("cuda", 0)
    out = {"workload": args.workload, "card": harness.power_limit(), "program": {},
           "control": {}}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    runs = [("program", s, {}) for s in seeds]
    runs += [("control", s, entry.control(config, precision)) for s in controls]
    for kind, seed, kwargs in runs:
        t = time.perf_counter()
        ctx = {"config": config, "traffic": traffic, "seed": seed, "device": device,
               "cell": cell}
        state = entry.setup(ctx)
        need = entry.min_requests(state)
        if kind == "program" and need:
            entry.window(state, lambda count, elapsed: count >= need)
        entry.release(state)
        gc.collect()
        torch.cuda.empty_cache()
        checks = entry.check(state, **kwargs)
        out[kind][seed] = {name: v for name, v, _ in checks}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[calibrate] {kind} seed {seed}: {out[kind][seed]} "
              f"({time.perf_counter() - t:.1f} s)", file=sys.stderr, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
