"""The port's key-sharded engine (``run_scenario(..., num_shards=S)`` on the
ranks of a gloo group, ``repro_torch.spmd``) on the CPU against the JAX
reference's ``shard_map`` run on ``S`` virtual CPU devices.

Every JAX case of a rank count runs in one subprocess (``XLA_FLAGS`` sets
the device count before JAX starts), which writes an ``.npz``; the port's
cases of a rank count run in one launch of ``S`` spawned ranks
(``spmd.run_ranks``), while the JAX subprocesses run. JAX's materialized
engine is the reference: its streamed mode draws other windows than its
materialized trace (a fault of the reference), so the port's streamed runs
are held to the port's own materialized runs instead.

Bars, each with its reason:

* against JAX's sharded run and against the port's one-rank run:
  histograms, hit rates, hit and request counts, the move counters, the
  routing and fault totals and series, the attribution histograms and the
  flight records' integer plane exact (integer counts, summed over ranks
  exactly); the f32 aggregates and series (throughput, mean latency, busy,
  occupancy, load factor, the dark-key fractions, the attribution sums, the
  flight values) within rtol 1e-4, the bar of ``tests/test_sharded_engine.py``
  (the ranks' partial f32 sums re-associate);
* against the port's one-rank run, the load factor and the attribution sums
  exact too: their folds are f64 sums rounded once, after the fold;
* the streamed sharded run against the materialized sharded run: every
  field bit for bit (a window is the trace's positions);
* every rank returns the same result, bit for bit.
"""

import inspect
import os
import subprocess
import sys
import time
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kvsim as jk  # noqa: E402
import repro_torch.kvsim as tk  # noqa: E402
from repro_torch.spmd import call_each, run_ranks  # noqa: E402


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()

ROOT = Path(__file__).resolve().parents[1]
SEED = 3
# tests/test_sharded_engine.py's scenario (wan5, 20,000 requests, contention
# on, telemetry on, interval 1,000), the keyspace that does not divide, and
# one case each for the routing tier (a bounded cache, lag 8, on the diurnal
# workload, whose shifts make views stale), a region-0 crash and the
# provenance layer (attribution and the flight recorder).
CASES = {
    "redynis": dict(keys=500, policy="redynis"),
    "local": dict(keys=500, policy="local"),
    "redynis_501": dict(keys=501, policy="redynis"),
    "local_501": dict(keys=501, policy="local"),
    "routing": dict(keys=500, policy="redynis", interval=200, routing=(8, 64), diurnal=True),
    "crash": dict(keys=500, policy="redynis", interval=200, crash=(0, 30, 20)),
    "provenance": dict(keys=500, policy="redynis", provenance=True),
}
RANK_CASES = {2: list(CASES), 4: ["redynis", "local"]}
STREAMED = {2: ["redynis", "redynis_501", "routing"], 4: ["redynis"]}

RESULT_EXACT = ("hit_rate", "replication_moves", "deletion_moves", "evictions",
                "capacity_evictions", "router_consults", "directory_fetches", "mis_routes",
                "stale_consults", "unavailable_reads", "unavailable_writes", "failovers",
                "repair_moves")
RESULT_CLOSE = ("throughput_ops_s", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes")
TRACE_EXACT = ("hist_group", "chunk_hist", "hit_rate", "requests", "moves", "drops", "evictions",
               "router_consults", "directory_fetches", "mis_routes", "stale_consults",
               "stale_age_hist", "unavailable_reads", "unavailable_writes", "failovers",
               "repair_moves", "attr_hist_group", "flight_meta")
TRACE_CLOSE = ("mean_latency_ms", "p99_latency_ms", "occupancy_bytes", "load_factor",
               "unreachable_frac", "wiped_frac", "attr_chunk_sum_ms", "flight_vals")
F64_FOLDS = ("load_factor", "attr_chunk_sum_ms")


def build_case(k, case: dict) -> tuple:
    """``((workload, cluster, policy), kwargs)`` of ``case`` for the kvsim
    package ``k`` (the reference's or the port's: the names are shared)."""
    make = k.diurnal_workload if case.get("diurnal") else k.wan5_workload
    wl = make(num_requests=20_000, num_keys=case["keys"])
    cl = k.wan5_cluster()._replace(service=k.ServiceConfig(enabled=True))
    if "routing" in case:
        lag, entries = case["routing"]
        cl = cl._replace(routing=k.RoutingConfig(publish_lag_chunks=lag, cache_entries=entries))
    if "crash" in case:
        cl = cl._replace(faults=k.region_outage(*case["crash"]))
    telemetry = k.TelemetryConfig()
    if case.get("provenance"):
        telemetry = k.TelemetryConfig(attribution=k.AttributionConfig(),
                                      flight=k.FlightRecorderConfig())
    policy = k.RedynisPolicy() if case["policy"] == "redynis" else k.StaticPolicy(mode=case["policy"])
    return (wl, cl, policy), dict(seed=SEED, daemon_interval=case.get("interval", 1000),
                                  telemetry=telemetry)


JAX_SCRIPT = """
import sys
import numpy as np
import repro.kvsim as k

SEED = {seed}
{build}
CASES = {cases}
out = {{}}
for name in {names}:
    args, kw = build_case(k, CASES[name])
    res, tr = k.run_scenario(*args, **kw, num_shards={shards})
    for f in res._fields:
        out[name + "/r/" + f] = np.asarray(getattr(res, f), dtype=np.float64)
    for f in tr._fields:
        v = getattr(tr, f)
        if v is not None:
            out[name + "/t/" + f] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("JAX_SHARDED_DONE")
"""


def _start_jax(shards: int, path: Path) -> subprocess.Popen:
    script = JAX_SCRIPT.format(seed=SEED, build=inspect.getsource(build_case), cases=repr(CASES),
                               names=repr(RANK_CASES[shards]), shards=shards)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={shards}")
    return subprocess.Popen([sys.executable, "-c", script, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _port_calls(shards: int) -> list:
    calls = []
    for name in RANK_CASES[shards]:
        args, kw = build_case(tk, CASES[name])
        calls.append((args, dict(kw, device="cpu", num_shards=shards)))
    for name in STREAMED[shards]:
        args, kw = build_case(tk, CASES[name])
        calls.append((args, dict(kw, device="cpu", num_shards=shards, trace_mode="streamed")))
    return calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{S: (JAX's sharded results, every rank's port results)}``: the JAX
    subprocesses run while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("sharded")
    jobs = {s: _start_jax(s, tmp / f"jax_{s}.npz") for s in RANK_CASES}
    try:
        port = {s: run_ranks(call_each, s, tk.run_scenario, _port_calls(s), timeout=300)
                for s in RANK_CASES}
        for s, job in jobs.items():
            out, _ = job.communicate(timeout=300)
            assert job.returncode == 0 and "JAX_SHARDED_DONE" in out, out
    finally:
        for job in jobs.values():
            if job.poll() is None:
                job.kill()
                job.communicate()
    out = {}
    for s in RANK_CASES:
        with np.load(tmp / f"jax_{s}.npz") as z:
            jax_runs = {name: {key.split("/", 1)[1]: z[key] for key in z.files
                               if key.split("/", 1)[0] == name} for name in RANK_CASES[s]}
        out[s] = (jax_runs, port[s])
    return out


@lru_cache(maxsize=None)
def _one_rank(name: str):
    args, kw = build_case(tk, CASES[name])
    return tk.run_scenario(*args, **kw, device="cpu")


def _sharded(runs, shards: int, name: str, streamed: bool = False):
    names = RANK_CASES[shards] + STREAMED[shards]
    at = RANK_CASES[shards].index(name) if not streamed else len(RANK_CASES[shards]) + \
        STREAMED[shards].index(name)
    assert names[at] == name
    return runs[shards][1][0][at]


def _assert_match(got, want, ctx: str, exact_f64_folds: bool) -> None:
    """``got`` a port ``(SimResult, SimTrace)``; ``want`` the same or a
    JAX run's ``{"r/<field>" | "t/<field>": array}``."""
    if isinstance(want, dict):
        w_res = {f: want["r/" + f] for f in RESULT_EXACT + RESULT_CLOSE}
        w_tr = {f[2:]: v for f, v in want.items() if f.startswith("t/")}
    else:
        w_res = want[0]._asdict()
        w_tr = {f: v for f, v in want[1]._asdict().items() if v is not None}
    res, tr = got
    for f in RESULT_EXACT:
        assert getattr(res, f) == float(w_res[f]), (ctx, f, getattr(res, f), w_res[f])
    for f in RESULT_CLOSE:
        np.testing.assert_allclose(np.asarray(getattr(res, f)), np.asarray(w_res[f]), rtol=1e-4,
                                   err_msg=f"{ctx} {f}")
    for f in TRACE_EXACT + TRACE_CLOSE:
        mine = getattr(tr, f)
        assert (mine is None) == (f not in w_tr), (ctx, f)
        if mine is None:
            continue
        if f in TRACE_EXACT or (exact_f64_folds and f in F64_FOLDS):
            np.testing.assert_array_equal(np.asarray(mine), np.asarray(w_tr[f]), err_msg=f"{ctx} {f}")
        else:
            np.testing.assert_allclose(np.asarray(mine), np.asarray(w_tr[f]), rtol=1e-4,
                                       err_msg=f"{ctx} {f}")


def _identical(a, b, ctx: str) -> None:
    for part_a, part_b in zip(a, b):
        for f in part_a._fields:
            x, y = getattr(part_a, f), getattr(part_b, f)
            if x is None or y is None:
                assert x is None and y is None, (ctx, f)
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{ctx} {f}")


PAIRS = [(s, name) for s in RANK_CASES for name in RANK_CASES[s]]
STREAM_PAIRS = [(s, name) for s in STREAMED for name in STREAMED[s]]


@pytest.mark.parametrize("shards,name", PAIRS, ids=[f"{s}-{n}" for s, n in PAIRS])
def test_sharded_matches_jax_shard_map(runs, shards, name):
    got = _sharded(runs, shards, name)
    _assert_match(got, runs[shards][0][name], f"{shards} ranks {name}", exact_f64_folds=False)
    res, tr = got
    assert tr.requests.sum() == 20_000 - res.unavailable_reads - res.unavailable_writes
    if CASES[name]["policy"] == "redynis":
        assert res.replication_moves > 0
    if "routing" in CASES[name]:
        assert res.mis_routes > 0 and res.directory_fetches > 0
    if "crash" in CASES[name]:
        assert res.unavailable_reads > 0 and res.repair_moves > 0 and tr.wiped_frac.max() > 0
    if CASES[name].get("provenance"):
        assert (tr.flight_meta[..., 4] & 2).any()


@pytest.mark.parametrize("shards,name", PAIRS, ids=[f"{s}-{n}" for s, n in PAIRS])
def test_sharded_matches_one_rank(runs, shards, name):
    _assert_match(_sharded(runs, shards, name), _one_rank(name), f"{shards} ranks {name}",
                  exact_f64_folds=True)


@pytest.mark.parametrize("shards,name", STREAM_PAIRS, ids=[f"{s}-{n}" for s, n in STREAM_PAIRS])
def test_streamed_sharded_equals_materialized(runs, shards, name):
    _identical(_sharded(runs, shards, name, streamed=True), _sharded(runs, shards, name),
               f"{shards} ranks {name} streamed")


@pytest.mark.parametrize("shards", list(RANK_CASES))
def test_every_rank_returns_the_same_result(runs, shards):
    per_rank = runs[shards][1]
    for rank, results in enumerate(per_rank[1:], start=1):
        for i, (a, b) in enumerate(zip(per_rank[0], results)):
            _identical(a, b, f"{shards} ranks, call {i}, rank {rank}")


def _small():
    return tk.wan5_workload(num_requests=100, num_keys=500), tk.wan5_cluster()


@pytest.mark.parametrize(
    "make,num_shards,match",
    [
        (lambda: (tk.TopKPolicy(), tk.wan5_cluster(), jk.TopKPolicy(), jk.wan5_cluster()), 2, "topk"),
        (lambda: (tk.RedynisPolicy(), tk.wan5_cluster()._replace(capacity_bytes=10_000.0),
                  jk.RedynisPolicy(), jk.wan5_cluster()._replace(capacity_bytes=10_000.0)),
         2, "capacity"),
        (lambda: (tk.RedynisPolicy(), tk.wan5_cluster(), jk.RedynisPolicy(), jk.wan5_cluster()),
         0, "num_shards"),
    ],
    ids=["topk", "finite_capacity", "no_shards"],
)
def test_rejected_as_the_reference_rejects(make, num_shards, match):
    """``topk`` and finite budgets need a global sort; the port raises the
    reference's message, before it looks for a group."""
    tpol, tcl, jpol, jcl = make()
    with pytest.raises(ValueError, match=match) as ours:
        tk.run_scenario(tk.wan5_workload(num_requests=100, num_keys=500), tcl, tpol,
                        num_shards=num_shards, device="cpu")
    with pytest.raises(ValueError, match=match) as ref:
        jk.run_scenario(jk.wan5_workload(num_requests=100, num_keys=500), jcl, jpol,
                        num_shards=num_shards)
    assert str(ours.value) == str(ref.value)


def test_sharded_call_without_a_group_raises():
    wl, cl = _small()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="none is initialised"):
        tk.run_scenario(wl, cl, tk.RedynisPolicy(), num_shards=2, device="cpu")


def test_sharded_call_in_a_group_of_another_size_raises(tmp_path):
    wl, cl = _small()
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                         rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="the initialised group has 1"):
            tk.run_scenario(wl, cl, tk.RedynisPolicy(), num_shards=2, device="cpu")
        # num_shards=1 in a group is the one-rank program.
        _identical([tk.run_scenario(wl, cl, tk.RedynisPolicy(), num_shards=1, device="cpu")],
                   [tk.run_scenario(wl, cl, tk.RedynisPolicy(), device="cpu")], "one rank")
    finally:
        torch.distributed.destroy_process_group()


def test_launcher_reports_a_failing_rank():
    wl, cl = _small()
    with pytest.raises(RuntimeError, match="rank [01] failed"):
        run_ranks(call_each, 2, tk.run_scenario, [((wl, cl, None), dict(device="cpu"))], timeout=120)


def test_launcher_kills_ranks_past_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(time.sleep, 2, 60, timeout=8)
    assert time.monotonic() - t0 < 30
