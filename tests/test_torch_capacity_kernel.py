"""The ``capacity_projection`` kernel against its plain version.

On the CPU the wrapper runs the plain version (``ref.py``) and launches
nothing, and its budget handling gives the plain version's f32 budgets.
The ``cuda`` cases hold the kernel to the plain version on the same card
tensors, bit for bit in all three outputs (the f64 byte sums are exact in
any order: sizes here span fewer than 53 bits), at tie groups that cross
the budget, ``-0.0`` beside ``0.0``, infinite, mixed, zero and negative
budgets, no owners, 1, 5 and 64 nodes (also in turns), key counts off the
tile, lognormal sizes and the benchmark cell's own shape; and check that
the reference engine's route (``policy_sweep(fused=False)``) launches no
kernel. They skip where there is no card and run on one with ``python -m
pytest -m cuda tests/test_torch_capacity_kernel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.capacity_projection import ops, ref  # noqa: E402

INF = float("inf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _fractions(rng, k, n):
    counts = rng.integers(0, 4, (k, n))
    total = counts.sum(1, keepdims=True)
    return np.where(total > 0, counts / np.maximum(total, 1), 0).astype(np.float32)


def _case(name: str):
    """``(owners, hosts, f, object_bytes, budgets)`` as numpy arrays."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "tie_group":
        # Most owned entries at f = 1.0; each node's budget crosses that tie
        # group, in its held part (nodes 0, 2) or its add part (1, 3, 4).
        k, n = 200_003, 5
        f = np.where(rng.random((k, n)) < 0.8, 1.0, rng.random((k, n))).astype(np.float32)
        owners = rng.random((k, n)) < 0.7
        hosts = rng.random((k, n)) < 0.5
        obj = np.full(k, 1024.0, np.float32)
        ones = owners & (f == 1.0)
        held = (ones & hosts).sum(0)
        share = np.array([0.5, 0.3, 0.9, 0.01, 0.99])
        budgets = np.where(np.arange(n) % 2 == 0, share * held, held + share * (ones & ~hosts).sum(0))
        return owners, hosts, f, obj, (1024.0 * budgets + 512.0).astype(np.float32)
    if name == "negative_zero":
        # -0.0 and 0.0 are one tie group, which the budget crosses.
        k, n = 50_000, 5
        f = rng.choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), (k, n), p=[0.35, 0.35, 0.2, 0.1])
        owners = rng.random((k, n)) < 0.8
        hosts = rng.random((k, n)) < 0.5
        obj = rng.choice(np.array([512.0, 1024.0, 4096.0], np.float32), k)
        return owners, hosts, f, obj, np.full(n, 1024.0 * k * 0.4, np.float32)
    if name in ("infinite", "mixed"):
        k, n = 30_000, 5
        f = _fractions(rng, k, n)
        budgets = np.full(n, INF, np.float32)
        if name == "mixed":  # finite and infinite budgets side by side, as in wan5_edge_cluster
            budgets[[1, 4]] = [1024.0 * 3_000, 1024.0 * 100]
        return rng.random((k, n)) < 0.6, rng.random((k, n)) < 0.5, f, np.full(k, 1024.0, np.float32), budgets
    if name == "zero_budget":
        # Budgets 0 (zero-size keys fit, until the first sized one), -1, and
        # one that fits exactly on a key's prefix sum.
        k, n = 20_000, 5
        f = _fractions(rng, k, n)
        obj = np.where(rng.random(k) < 0.3, 0.0, 1024.0).astype(np.float32)
        budgets = np.array([0.0, -1.0, 1024.0 * 200, 0.0, 1024.0], np.float32)
        return rng.random((k, n)) < 0.6, rng.random((k, n)) < 0.5, f, obj, budgets
    if name == "no_owners":
        k, n = 10_000, 5
        return (np.zeros((k, n), bool), rng.random((k, n)) < 0.5, _fractions(rng, k, n),
                np.full(k, 1024.0, np.float32), np.full(n, 1024.0 * 50, np.float32))
    if name.startswith("nodes_"):
        n = int(name.split("_")[1])
        k = 40_001
        f = _fractions(rng, k, n)
        obj = rng.choice(np.array([512.0, 1024.0, 2048.0, 8192.0], np.float32), k)
        budgets = (obj.mean() * k * rng.uniform(0.05, 0.5, n)).astype(np.float32)
        return rng.random((k, n)) < 0.6, rng.random((k, n)) < 0.5, f, obj, budgets
    if name == "lognormal":
        k, n = 100_000, 5
        obj = (1024 * np.exp(0.5 * rng.standard_normal(k))).astype(np.float32)
        return (rng.random((k, n)) < 0.6, rng.random((k, n)) < 0.5, _fractions(rng, k, n), obj,
                np.full(n, 1024.0 * k / 10, np.float32))
    if name == "cell":
        # The benchmark cell's shape: 10 M keys x 5, 1,024 B, 512,000,000 B a
        # node; at node 0 a million owned keys at f = 1.0 cross the budget.
        k, n = 10_000_000, 5
        f = rng.choice(np.array([0.2, 0.5, 0.87, 1.0], np.float32), (k, n), p=[0.4, 0.3, 0.2, 0.1])
        f[:, 0] = np.where(rng.random(k) < 0.15, 1.0, f[:, 0])
        owners = rng.random((k, n)) < 0.45
        hosts = rng.random((k, n)) < 0.3
        return owners, hosts, f, np.full(k, 1024.0, np.float32), np.full(n, 512_000_000.0, np.float32)
    raise KeyError(name)


CASES = ["tie_group", "negative_zero", "infinite", "mixed", "zero_budget", "no_owners", "nodes_1",
         "nodes_5", "nodes_64", "lognormal", "cell"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_the_plain_version_bit_for_bit(cuda, name):
    owners, hosts, f, obj, budgets = (torch.from_numpy(a).to(cuda) for a in _case(name))
    before = ops.capacity_projection.launches
    got = ops.capacity_projection(owners, hosts, f, obj, budgets)
    want = ref.project_capacity_ref(owners, hosts, f, obj, budgets)
    torch.cuda.synchronize()
    assert ops.capacity_projection.launches == before + 1
    for label, g, w in zip(("projected", "evicted", "rejected"), got, want):
        diff = int((g != w).sum())
        assert diff == 0, f"{name}: {label} differs in {diff} entries"
    if name in ("tie_group", "negative_zero", "lognormal", "cell"):
        assert want[1].any() and want[2].any(), name  # the budget bites on held and added replicas


@pytest.mark.cuda
def test_kernel_keeps_its_launch_sizes_across_node_counts(cuda):
    # The kernel asks the card for its launch sizes once a (device, N) and
    # keeps them: calls that alternate node counts stay exact.
    cases = {name: [torch.from_numpy(a).to(cuda) for a in _case(name)]
             for name in ("nodes_64", "nodes_1", "nodes_5")}
    for name in [*cases, *cases]:
        got = ops.capacity_projection(*cases[name])
        want = ref.project_capacity_ref(*cases[name])
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


@pytest.mark.cuda
def test_kernel_takes_scalar_and_host_budgets(cuda):
    owners, hosts, f, obj, budgets = (torch.from_numpy(a).to(cuda) for a in _case("lognormal"))
    want = ref.project_capacity_ref(owners, hosts, f, obj, budgets)
    for cap in (float(budgets[0]), np.float32(budgets[0].item()), budgets.cpu().tolist()):
        got = ops.capacity_projection(owners, hosts, f, obj, cap)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_reference_engine_route_launches_no_kernel(cuda):
    from repro_torch.core import policy as tp
    from repro_torch.interop import store_from_numpy

    rng = np.random.default_rng(5)
    k, n = 50_000, 5
    counts = rng.integers(0, 4, (k, n)).astype(np.int32)
    store = store_from_numpy(counts, rng.random((k, n)) < 0.4, rng.integers(0, 10, k).astype(np.int32),
                             np.ones(k, bool), np.zeros(k, np.int32), device=cuda)
    static, params = tp.split_policy(tp.parse_policy("redynis").resolve(n))
    ctx = tp.PolicyContext(rtt=torch.zeros((n, n), device=cuda),
                           object_bytes=torch.full((k,), 1024.0, device=cuda),
                           capacity_bytes=torch.full((n,), 1024.0 * 4_000, device=cuda), params=params)
    state = static.init(store, ctx)
    before = ops.capacity_projection.launches
    plain, _, _ = tp.policy_sweep(static, state, store, 9, ctx, fused=False)
    assert ops.capacity_projection.launches == before
    fused, _, _ = tp.policy_sweep(static, state, store, 9, ctx)
    assert ops.capacity_projection.launches == before + 1
    assert plain.capacity_evicted.any()
    for name in ("owners", "to_add", "to_drop", "capacity_evicted"):
        assert torch.equal(getattr(plain, name), getattr(fused, name)), name


@pytest.mark.parametrize("name", ["tie_group", "zero_budget", "mixed"])
def test_wrapper_runs_the_plain_version_on_the_cpu(name):
    rng = np.random.default_rng(1)
    owners, hosts, f, obj, budgets = _case(name)
    rows = rng.choice(owners.shape[0], 500, replace=False)  # a few seconds' worth at most
    args = [torch.from_numpy(np.ascontiguousarray(a[rows])) for a in (owners, hosts, f, obj)]
    before = ops.capacity_projection.launches
    got = ops.capacity_projection(*args, torch.from_numpy(budgets))
    want = ref.project_capacity_ref(*args, torch.from_numpy(budgets))
    assert ops.capacity_projection.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("cap", [2.5e8, np.float32(1e6 + 0.3), [1.0, 2.0, INF], (0.1, 0.2, 0.3)],
                         ids=["float", "numpy", "list", "tuple"])
def test_budget_is_the_plain_versions_f32_budget(cap):
    got = ops._budget(cap, 3, torch.device("cpu"))
    want = torch.as_tensor(cap, dtype=torch.float32).expand(3)
    assert got.dtype == torch.float32 and got.shape == (3,) and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.parametrize("cap", [torch.tensor(1e6 + 0.3, dtype=torch.float64),
                                 torch.tensor([1.0, 2.0, INF], dtype=torch.float64)],
                         ids=["0-d", "[N]"])
def test_budget_casts_a_device_tensor_as_the_plain_version(cap):
    got = ops._budget(cap, 3, torch.device("cpu"))
    assert torch.equal(got, torch.as_tensor(cap, dtype=torch.float32).expand(3))
    with pytest.raises(ValueError, match="capacity_bytes is on"):
        ops._budget(cap, 3, torch.device("meta"))
