"""The readings that a configuration's ``limits`` are set from: for each
seed, the numbers of ``kvbench/check.py`` for the program's replay of each
of the seed's two traces against the reference, and, for the control
seeds, for the control (the reference computed in bfloat16, put in the
program's place). Not run by the benchmark's runs. ::

    python3 -m kvbench.readings --workload wan5-10m.ycsb-b-hotspot --seeds 1 2 3 --control-seeds 1 2 3

prints one JSON line a seed, trace and side, and the largest program
reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kvbench.run import ROOT, _fixed_caches, load_cell


def readings(cell: dict, seeds, control_seeds, device: str = "cuda", log=print) -> dict:
    """``{"program": {number: largest}, "control": {number: smallest}}``
    over the seeds, each line logged as it comes."""
    import torch

    from kvbench import check, traffic
    from kvbench.program import Scenario
    from kvbench.reference import engine

    config, mix = cell["config"], cell["traffic"]
    dev = torch.device(device)
    program = Scenario(config)
    high = {n: 0 for n in check.NUMBERS}
    low = {n: float("inf") for n in check.NUMBERS}
    for seed in sorted(set(seeds) | set(control_seeds)):
        store, traces = traffic.draw_inputs(config, mix, seed, dev)
        for i, req in enumerate(traces):
            args = (config, store.natural_node, store.object_bytes, *req)
            want = check.reference_answers(engine.replay(*args), config)
            sides = []
            if seed in seeds:
                t0 = time.perf_counter()
                got = check.program_answers(*program.replay(store, req), config)
                sides.append(("program", got, time.perf_counter() - t0))
            if seed in control_seeds:
                t0 = time.perf_counter()
                got = check.reference_answers(engine.replay(*args, dtype=torch.bfloat16), config)
                sides.append(("control", got, time.perf_counter() - t0))
            for side, got, wall in sides:
                numbers = check.compare(got, want)
                log(json.dumps(dict(workload=cell["name"], seed=seed, trace=i, side=side,
                                    wall_s=wall, **numbers)))
                for n in check.NUMBERS:
                    if side == "program":
                        high[n] = max(high[n], numbers[n])
                    else:
                        low[n] = min(low[n], numbers[n])
        del store, traces
    return {"program": high, "control": low}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    out = readings(load_cell(args.workload), args.seeds, args.control_seeds)
    print(json.dumps(dict(workload=args.workload, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
