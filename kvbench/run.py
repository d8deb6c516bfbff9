"""The benchmark of ``repro_torch``: simulated requests per second of
``repro_torch.kvsim.run_scenario`` replaying traces drawn from a seed.

Run from the root of a checkout, on a machine with the card(s) the cell
asks for::

    python3 -m kvbench.run --workload wan5-10m.ycsb-b-hotspot --seed 7 --seconds 10 --trace 0

A run draws a store and two traces on the card from ``--seed``, warms the
path up on the first chunks, then replays whole scenarios back to back,
alternating the two traces, until one ends at or after ``--seconds``: the
window. Then it replays each trace once through the plain reference
(``kvbench/reference/``) and compares every scenario's answers with it
(``kvbench/check.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted`` and ``failed`` (scenarios), ``metrics``
(with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from ``torch.profiler`` over the window), and
``device``; ``--trace 1`` adds ``breakdown``. The numbers compared, each
with its limit, close both standard error and the JSON line (``check``).

Everything is found by name from ``BENCHMARK.json``:

* a cell (``workloads``) names a configuration and a traffic mix;
* a configuration is ``configs/<name>.json`` (the file its entry names):
  the store, the cluster, the policy, the guarantees and the ``limits``
  of the comparison;
* a traffic mix is ``traffic/<name>.json``, parameters of the one
  generator ``kvbench/traffic.py``;
* a per-layer metric is ``metrics/<name>.py``, whose ``read(window)``
  returns a number or ``None`` (nothing to read: the metric is left out).

To add a cell, add its data files (and a metric's reader) and its entries
in ``BENCHMARK.json``; no file that is there changes. The check of a new
configuration's answers is ``kvbench/readings.py`` (the program's numbers
over seeds, and the control's), from which its ``limits`` are set.

Builds and kernel caches stay inside the checkout (``build/``). The exit
code is not 0, and no result is printed, when there is no card or fewer
than the cell asks for, when ``repro_torch`` cannot be imported, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
WARM_CHUNKS = 3  # the warm-up replays this many chunks: every shape of a scenario

__all__ = ["load_cell", "execute", "main"]


def _fixed_caches() -> None:
    """Kernel build and compile caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell ``name``: its entry, configuration, traffic and metrics."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; expected one of {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    per_layer = {m["name"]: m["unit"] for m in bench["per_layer"] if name in m.get("workloads", [name])}
    end_to_end = {m["name"]: m["unit"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    return dict(
        name=name, chips=cell["chips"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        per_layer=per_layer, end_to_end=end_to_end,
    )


def _reader(metric: str):
    spec = importlib.util.spec_from_file_location(f"kvbench_metric_{metric}",
                                                  HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def execute(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
            log=print) -> dict:
    """One run of ``cell``: set-up, the window, the check. Returns the
    result (the JSON line's object) with the numbers compared under
    ``check``."""
    import torch

    from kvbench import check, traffic
    from kvbench.program import Scenario
    from kvbench.reference import engine

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    config, mix = cell["config"], cell["traffic"]
    t_import = time.perf_counter()
    store, traces = traffic.draw_inputs(config, mix, seed, dev)
    sync()
    t_draw = time.perf_counter()
    program = Scenario(config)
    prof = None
    if trace:
        # The profiler's warm-up step takes the warm-up replay: CUPTI starts
        # (seconds, the first time in a process) before the window.
        from torch.profiler import ProfilerActivity, profile, schedule

        prof = profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1))
        prof.start()
    program.replay(store, traces[0], min(WARM_CHUNKS * config["daemon_interval"],
                                         config["scenario_requests"]))
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - _T0
    log(f"set-up {setup_s:.3f} s: to the first draw {t_import - _T0:.3f} s, the draw "
        f"{t_draw - t_import:.3f} s, the warm-up {_T0 + setup_s - t_draw:.3f} s", file=sys.stderr)

    answers, order = [], []
    if prof is not None:
        prof.step()
    start = time.perf_counter()
    while True:
        i = len(order) % 2
        answers.append(program.replay(store, traces[i]))
        order.append(i)
        if time.perf_counter() - start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - start
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    requests = len(order) * config["scenario_requests"]
    ticks = len(order) * -(-config["scenario_requests"] // config["daemon_interval"])

    metrics, device_rec, extra = {}, {}, {}
    if prof is not None:
        from kvbench import profile as profile_mod

        win = profile_mod.reduce_events(
            prof.profiler.kineto_results.events(), window_s, ticks,
            dict(config=config, traffic=mix, requests=[traces[i] for i in order]))
        del prof
        for name, unit in cell["per_layer"].items():
            value = _reader(name)(win)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": unit}
        device_rec = dict(busy_s=win.busy_s, window_s=window_s)
        extra["breakdown"] = profile_mod.breakdown(win)
        del win
    else:
        values = dict(sim_req_per_s=requests / window_s, peak_mem_gib=peak / 2**30, setup_s=setup_s)
        for name, unit in cell["end_to_end"].items():
            metrics[name] = {"value": float(values[name]), "unit": unit}

    # The check: the program's state is gone; the reference replays each
    # trace once, on the card, and every scenario of the window is held to it.
    program = None
    if cuda:
        torch.cuda.empty_cache()
    got = [check.program_answers(res, tr, config) for res, tr in answers]
    answers = None
    worst = {name: 0 for name in check.NUMBERS}
    failed = 0
    limits = config["limits"]
    for i in sorted(set(order)):
        ref = engine.replay(config, store.natural_node, store.object_bytes, *traces[i])
        want = check.reference_answers(ref, config)
        for j, k in enumerate(order):
            if k != i:
                continue
            numbers = check.compare(got[j], want)
            if any(numbers[n] > limits[n] for n in check.NUMBERS):
                failed += 1
            for n in check.NUMBERS:
                worst[n] = max(worst[n], numbers[n])
            log(f"scenario {j} (trace {i}): " + ", ".join(
                f"{n} {numbers[n]!r}" for n in check.NUMBERS) + f" (widest in {numbers['worst']})",
                file=sys.stderr)
    sync()
    dev_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    return dict(
        correct=failed == 0, attempted=len(order), failed=failed, metrics=metrics,
        device=dict(platform="gpu" if cuda else "cpu", kind=dev_name, count=1 if cuda else 0,
                    memory_peak_bytes=int(peak), **device_rec),
        **extra,
        # JSON has no infinity: a wholly missing answer reads as the largest double.
        check={n: {"value": min(worst[n], sys.float_info.max), "limit": limits[n]}
               for n in check.NUMBERS},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"kvbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    from kvbench.guard import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"kvbench: modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, rec in result["check"].items():
        print(f"check {name}: {rec['value']!r} (limit {rec['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
