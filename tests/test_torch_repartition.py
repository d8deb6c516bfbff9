"""The port's repartition layer (``core/repartition.py``) on the CPU against
the JAX reference.

The reference's properties (``tests/test_repartition_properties.py``) hold
for the port: slots unique and within capacity, the hottest wanted keys
kept, every add published, desired slots filled. On random plans the port
equals JAX exactly (``slot_ids``, ``publish_ids``, ``moved_bytes``,
``slot_bytes``, and the filled cache's ``ids`` and ``data``): integer
state, stable sorts on both sides, first-index argmaxes, and byte sizes
that are whole numbers (their sums exact in any order). ``publish_and_fill``
over a 2-rank gloo group equals the reference's ``shard_map`` run on 2
virtual devices (one subprocess), and both equal the ``group=None`` path.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from repro.core.placement import PlacementPlan as JPlan  # noqa: E402
from repro.core.repartition import create_cache as j_create_cache  # noqa: E402
from repro.core.repartition import plan_moves as j_plan_moves  # noqa: E402
from repro.core.repartition import publish_and_fill as j_publish_and_fill  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CommitState,
    PlacementPlan,
    ReplicaCache,
    create_cache,
    plan_moves,
    publish_and_fill,
)
from repro_torch.spmd import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()


def random_plan(rng, k, n):
    """The reference test's random plan, as numpy arrays."""
    owners = rng.random((k, n)) < 0.5
    home = rng.integers(0, n, size=k).astype(np.int32)
    owners[np.arange(k), home] = True
    prev = rng.random((k, n)) < 0.3
    return owners, owners & ~prev, prev & ~owners, home


def _tplan(owners, to_add, to_drop):
    t = torch.from_numpy
    return PlacementPlan(owners=t(owners), to_add=t(to_add), to_drop=t(to_drop),
                         expired=torch.zeros(owners.shape[0], dtype=torch.bool))


def _jplan(owners, to_add, to_drop):
    return JPlan(owners=jnp.asarray(owners), to_add=jnp.asarray(to_add),
                 to_drop=jnp.asarray(to_drop), expired=jnp.zeros((owners.shape[0],), bool))


@pytest.mark.parametrize("seed", range(8))
def test_plan_moves_slots_unique_and_within_capacity(seed):
    rng = np.random.default_rng(seed)
    k, n, cap = int(rng.integers(4, 40)), int(rng.integers(2, 6)), int(rng.integers(1, 9))
    owners, to_add, to_drop, home = random_plan(rng, k, n)
    moves = plan_moves(_tplan(owners, to_add, to_drop), torch.from_numpy(home), cap, max_moves=k,
                       object_bytes=8.0)
    slot_ids = moves.slot_ids.numpy()
    assert slot_ids.shape == (n, min(cap, k)) and slot_ids.dtype == np.int32
    for r in range(n):
        filled = slot_ids[r][slot_ids[r] >= 0]
        assert len(set(filled.tolist())) == len(filled)
        wanted = set(np.nonzero(owners[:, r] & (home != r))[0].tolist())
        assert set(filled.tolist()) <= wanted
        assert len(filled) == min(len(wanted), cap)


@pytest.mark.parametrize("seed", range(8))
def test_plan_moves_priority_keeps_hottest(seed):
    rng = np.random.default_rng(100 + seed)
    k, n, cap = int(rng.integers(6, 40)), int(rng.integers(2, 5)), int(rng.integers(1, 6))
    owners, to_add, to_drop, home = random_plan(rng, k, n)
    heat = rng.integers(0, 5, size=k).astype(np.float32)  # few levels: ties
    moves = plan_moves(_tplan(owners, to_add, to_drop), torch.from_numpy(home), cap, max_moves=k,
                       object_bytes=8.0, priority=torch.from_numpy(heat))
    for r in range(n):
        wanted = np.nonzero(owners[:, r] & (home != r))[0]
        expect = sorted(wanted.tolist(), key=lambda i: (-heat[i], i))[:cap]
        assert [i for i in moves.slot_ids[r].tolist() if i >= 0] == expect, r


@pytest.mark.parametrize("seed", range(4))
def test_plan_moves_publishes_every_add(seed):
    rng = np.random.default_rng(7 + seed)
    k, n = 16, 3
    owners, to_add, to_drop, home = random_plan(rng, k, n)
    moves = plan_moves(_tplan(owners, to_add, to_drop), torch.from_numpy(home), 8, max_moves=k,
                       object_bytes=4.0)
    published = {i for i in moves.publish_ids.tolist() if i >= 0}
    added = set(np.nonzero(to_add.any(axis=1))[0].tolist())
    assert published == added
    assert float(moves.moved_bytes) == 4.0 * len(added)


@pytest.mark.parametrize("seed", range(4))
def test_publish_and_fill_fills_desired_slots(seed):
    rng = np.random.default_rng(11 + seed)
    k, n, cap = 12, 2, 6
    owners, to_add, to_drop, home = random_plan(rng, k, n)
    moves = plan_moves(_tplan(owners, to_add, to_drop), torch.from_numpy(home), cap, max_moves=k,
                       object_bytes=4.0)
    values = torch.arange(k * 3, dtype=torch.float32).reshape(k, 3)
    published = {i for i in moves.publish_ids.tolist() if i >= 0}
    for r in range(n):
        filled = publish_and_fill(create_cache(cap, (3,), device="cpu"), moves, values,
                                  torch.arange(k, dtype=torch.int32), rank=r)
        for slot, want in enumerate(moves.slot_ids[r].tolist()):
            if want >= 0 and want in published:
                assert filled.ids[slot] == want
                assert torch.equal(filled.data[slot], values[want])
            else:
                assert filled.ids[slot] == -1 and not filled.data[slot].any()


def _random_case(seed):
    """A random plan at one of two shapes (few shapes keep JAX's eager
    compiles few): 40 keys on 4 ranks, 6 slots a rank and 12 moves, or
    more slots than keys and every key's move."""
    rng = np.random.default_rng(1000 + seed)
    k, n, d = 40, 4, 3
    cap, max_moves = (6, 12) if seed % 2 else (45, 40)
    owners, to_add, to_drop, home = random_plan(rng, k, n)
    sizes = rng.integers(1, 5_000, size=k).astype(np.float32)
    priority = rng.integers(0, 6, size=k).astype(np.float32)
    values = rng.standard_normal((k, d)).astype(np.float32)
    slots = min(cap, k)  # the schedule's slots a rank, and so the cache's
    old_ids = np.full(slots, -1, np.int32)
    held = rng.choice(k, size=slots, replace=False)[: int(rng.integers(0, slots + 1))]
    old_ids[: len(held)] = held
    old_data = rng.standard_normal((slots, d)).astype(np.float32)
    return (owners, to_add, to_drop, home), sizes, priority, cap, max_moves, values, old_ids, old_data


@pytest.mark.parametrize("with_priority", [False, True], ids=["id_order", "priority"])
@pytest.mark.parametrize("seed", range(8))
def test_plan_moves_and_fill_match_jax(seed, with_priority):
    plan, sizes, priority, cap, max_moves, values, old_ids, old_data = _random_case(seed)
    owners, to_add, to_drop, home = plan
    t = torch.from_numpy
    moves = plan_moves(_tplan(owners, to_add, to_drop), t(home), cap, max_moves, t(sizes),
                       priority=t(priority) if with_priority else None)
    jmoves = j_plan_moves(_jplan(owners, to_add, to_drop), jnp.asarray(home), cap, max_moves,
                          jnp.asarray(sizes),
                          priority=jnp.asarray(priority) if with_priority else None)
    for name in moves._fields:
        np.testing.assert_array_equal(getattr(moves, name).numpy(), np.asarray(getattr(jmoves, name)),
                                      err_msg=name)
    k, n = owners.shape
    for r in range(n):
        got = publish_and_fill(ReplicaCache(t(old_ids), t(old_data)), moves, t(values),
                               torch.arange(k, dtype=torch.int32), rank=r)
        from repro.core.repartition import ReplicaCache as JCache

        want = j_publish_and_fill(JCache(jnp.asarray(old_ids), jnp.asarray(old_data)), jmoves,
                                  jnp.asarray(values), jnp.arange(k, dtype=jnp.int32), rank=r)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


@pytest.mark.parametrize("seed", range(4))
def test_cache_lookup_matches_jax(seed):
    from repro.core.repartition import ReplicaCache as JCache

    rng = np.random.default_rng(seed)
    ids = rng.permutation(40)[:10].astype(np.int32)
    ids[rng.random(10) < 0.3] = -1
    probe = rng.integers(-1, 40, size=(3, 7)).astype(np.int32)
    got = ReplicaCache(torch.from_numpy(ids), torch.zeros(10, 2)).lookup(torch.from_numpy(probe))
    want = JCache(jnp.asarray(ids), jnp.zeros((10, 2))).lookup(jnp.asarray(probe))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ReplicaCache(torch.from_numpy(ids), torch.zeros(10, 2)).capacity == 10


def test_create_cache_matches_jax():
    got = create_cache(5, (3, 2), dtype=torch.float16, device="cpu")
    want = j_create_cache(5, (3, 2), dtype=jnp.float16)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert got.data.shape == want.data.shape and got.data.dtype == torch.float16
    assert not got.data.any()


def test_commit_state_double_buffers():
    """Consumers read ``active`` until the commit, whatever is staged."""
    first = create_cache(4, (2,), device="cpu")
    second = ReplicaCache(torch.tensor([3, -1, 1, -1], dtype=torch.int32), torch.ones(4, 2))
    third = ReplicaCache(torch.tensor([0, 2, -1, -1], dtype=torch.int32), torch.full((4, 2), 2.0))
    state = CommitState.create(first)
    assert state.active is first and state.staged is first
    state = state.stage(second)
    assert state.active is first and state.staged is second
    state = state.stage(third)
    assert state.active is first and state.staged is third
    state = state.commit()
    assert state.active is third and state.staged is third


# The reference test's 2-rank case (k 12, 2 ranks, 5 slots, payload 3, an
# even split of homes), and a larger random one with an uneven split.
SHARD_CASES = {"reference": (0, 12, 5, 3, "even"), "uneven": (5, 60, 9, 4, "random")}

JAX_SCRIPT = r"""
import sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.placement import PlacementPlan
from repro.core.repartition import create_cache, plan_moves, publish_and_fill

case = dict(np.load(sys.argv[1]))
out = {}
for name in case["names"]:
    g = lambda f: case[name + "/" + f]
    owners, to_add, to_drop, home = g("owners"), g("to_add"), g("to_drop"), g("home")
    cap, values = int(g("cap")), g("values")
    k, d = values.shape
    plan = PlacementPlan(owners=jnp.asarray(owners), to_add=jnp.asarray(to_add),
                         to_drop=jnp.asarray(to_drop), expired=jnp.zeros((k,), bool))
    moves = plan_moves(plan, jnp.asarray(home), cap, max_moves=k, object_bytes=4.0)
    local_ids = g("local_ids")  # [2, K_local], -1 padded
    local_vals = g("local_vals")
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))

    @partial(shard_map, mesh=mesh, in_specs=(P("x"), P("x")), out_specs=P("x"))
    def run(lv, lid):
        got = publish_and_fill(create_cache(cap, (d,)), moves, lv[0], lid[0],
                               rank=jax.lax.axis_index("x"), axis_name="x")
        return jax.tree_util.tree_map(lambda a: a[None], got)

    got = run(jnp.asarray(local_vals), jnp.asarray(local_ids))
    out[name + "/ids"] = np.asarray(got.ids)
    out[name + "/data"] = np.asarray(got.data)
np.savez(sys.argv[2], **out)
print("SHARD_MAP_DONE")
"""


def _shard_case(name):
    seed, k, cap, d, split = SHARD_CASES[name]
    rng = np.random.default_rng(seed)
    owners = rng.random((k, 2)) < 0.6
    home = (np.arange(k) % 2 if split == "even" else rng.integers(0, 2, size=k)).astype(np.int32)
    owners[np.arange(k), home] = True
    prev = rng.random((k, 2)) < 0.3
    values = (np.arange(k * d, dtype=np.float32).reshape(k, d) if split == "even"
              else rng.standard_normal((k, d)).astype(np.float32))
    width = max(int((home == r).sum()) for r in range(2))
    local_ids = np.full((2, width), -1, np.int32)  # -1 pads the shorter shard
    local_vals = np.zeros((2, width, d), np.float32)
    for r in range(2):
        mine = np.nonzero(home == r)[0]
        local_ids[r, : len(mine)] = mine
        local_vals[r, : len(mine)] = values[mine]
    return dict(owners=owners, to_add=owners & ~prev, to_drop=prev & ~owners, home=home, cap=cap,
                values=values, local_ids=local_ids, local_vals=local_vals)


def _fill_rank(calls: list):
    """Each rank's ``publish_and_fill`` over the default group: rank ``r``
    takes ``calls[r]`` (cache, moves, its shard's objects and ids)."""
    rank = dist.get_rank()
    return publish_and_fill(*calls[rank], rank=rank, group=dist.group.WORLD)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``{case: (JAX's shard_map caches [2], the port's gloo caches [2],
    the port's moves, the case)}``."""
    tmp = tmp_path_factory.mktemp("repartition")
    cases = {name: _shard_case(name) for name in SHARD_CASES}
    np.savez(tmp / "in.npz", names=np.array(list(cases)),
             **{f"{name}/{f}": v for name, c in cases.items() for f, v in c.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    job = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.npz"),
                            str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        port = {}
        for name, c in cases.items():
            t = torch.from_numpy
            moves = plan_moves(_tplan(c["owners"], c["to_add"], c["to_drop"]), t(c["home"]), c["cap"],
                               max_moves=len(c["home"]), object_bytes=4.0)
            d = c["values"].shape[1]
            calls = [(create_cache(c["cap"], (d,), device="cpu"), moves, t(c["local_vals"][r]),
                      t(c["local_ids"][r])) for r in range(2)]
            port[name] = (run_ranks(_fill_rank, 2, calls, timeout=120), moves)
        out, _ = job.communicate(timeout=300)
        assert job.returncode == 0 and "SHARD_MAP_DONE" in out, out
    finally:
        if job.poll() is None:
            job.kill()
            job.communicate()
    with np.load(tmp / "out.npz") as z:
        return {name: ((z[f"{name}/ids"], z[f"{name}/data"]), *port[name], cases[name])
                for name in SHARD_CASES}


@pytest.mark.parametrize("name", list(SHARD_CASES))
def test_publish_and_fill_two_gloo_ranks_match_shard_map(two_ranks, name):
    (jax_ids, jax_data), caches, moves, case = two_ranks[name]
    for r in range(2):
        np.testing.assert_array_equal(caches[r].ids.numpy(), jax_ids[r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(caches[r].data.numpy(), jax_data[r], err_msg=f"rank {r}")
        # The one-process path, every object local, gives the same cache.
        k, d = case["values"].shape
        alone = publish_and_fill(create_cache(case["cap"], (d,), device="cpu"), moves,
                                 torch.from_numpy(case["values"]), torch.arange(k, dtype=torch.int32),
                                 rank=r)
        assert torch.equal(alone.ids, caches[r].ids) and torch.equal(alone.data, caches[r].data)
    assert (jax_ids >= 0).any()
