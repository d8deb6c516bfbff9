"""The port's MoE layer and router against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's params are carried across with ``params_from_numpy``.

Tolerances, each with its reason:

* router ids and counts — exact: the same softmax formula and the same
  first-index tie rule; no row of these inputs is within ulps of a tie;
* router gates — rtol 1e-6: ``exp`` and the softmax sum differ by ulps
  between XLA-CPU and PyTorch;
* ``counts``, ``dropped``, ``hot_frac`` — exact: whole-number sums;
* ``aux`` — rtol 1e-5 (f32 sums in another order);
* ``y`` — atol 2e-2, the reference's own bar for bf16 MoE outputs
  (``tests/test_redynis_integrations.py``): the bf16 einsums accumulate in
  another order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.moe_router.kernel import moe_router_call  # noqa: E402
from repro.kernels.moe_router.ops import moe_router as jax_moe_router  # noqa: E402
from repro.kernels.moe_router.ref import router_ref as jax_router_ref  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, reduced  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.moe_router.ops import moe_router  # noqa: E402
from repro_torch.kernels.moe_router.ref import router_ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import swiglu  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (seen with torch 2.13 on AVX-512 hosts, about one
    process in eight); one call on a single element first avoids it."""
    torch.exp(torch.zeros(1))


ROUTER_CASES = [(512, 64, 6, 128), (300, 32, 8, 128), (1024, 8, 2, 256)]


def _logits(seed, t, e):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)


@pytest.mark.parametrize("t,e,k,group", ROUTER_CASES)
def test_router_ref_matches_jax(t, e, k, group):
    x = _logits(t + e, t, e)
    gates, ids, counts = moe_router(torch.from_numpy(x), k=k, group=group)
    jg, ji, jc = jax_router_ref(jnp.asarray(x), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
    assert counts.shape == (-(-t // group), e)
    np.testing.assert_array_equal(counts.sum(0).numpy(), np.asarray(jc))
    # The reference's interpret-mode Pallas kernel: same ids, same totals.
    pg, pi, pc = jax_moe_router(jnp.asarray(x), k=k, tt=group)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(counts.sum(0).numpy(), np.asarray(pc))
    np.testing.assert_allclose(gates.numpy(), np.asarray(pg), rtol=1e-6, atol=0)
    if t % group == 0:  # one Pallas tile per group: per-tile histograms equal
        _, _, hist = moe_router_call(jnp.asarray(x), k=k, tt=group, interpret=True)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(hist))
    assert float(counts.sum()) == t * k


def test_router_ties_pick_the_lower_expert():
    """Equal logits: the first rounds take the lowest ids, as jax.lax.top_k."""
    x = np.zeros((4, 8), np.float32)
    x[1, [5, 2, 7]] = 1.0
    gates, ids, counts = router_ref(torch.from_numpy(x), 3, 2)
    _, ji, _ = jax_router_ref(jnp.asarray(x), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    assert ids[0].tolist() == [0, 1, 2] and ids[1].tolist() == [2, 5, 7]
    assert counts.tolist()[0] == [1, 1, 2, 0, 0, 1, 0, 1]


def _cfg_pair(**overrides):
    jcfg = jax_reduced(jax_get_config("deepseek-moe-16b"), **overrides)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def test_configs_carry_across():
    jcfg, cfg = _cfg_pair()
    assert cfg == reduced(get_config("deepseek-moe-16b"))
    full = get_config("deepseek-moe-16b")
    assert full == ModelConfig(**dataclasses.asdict(jax_get_config("deepseek-moe-16b")))
    assert full.padded_vocab == 102_400 and full.d_ff == 1408 and full.top_k == 6
    # Every id of the reference is ported; an id it does not know raises.
    assert get_config("rwkv6-1.6b") == ModelConfig(**dataclasses.asdict(jax_get_config("rwkv6-1.6b")))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def test_capacities_match_jax():
    for jcfg, cfg in (_cfg_pair(), _cfg_pair(hot_expert_slots=0)):
        for group in (64, 512):
            assert moe.cold_capacity(cfg, group) == jax_moe.cold_capacity(jcfg, group)
            if cfg.hot_expert_slots:
                assert moe.hot_capacity(cfg, group) == jax_moe.hot_capacity(jcfg, group)
    full = get_config("deepseek-moe-16b")
    assert (moe.cold_capacity(full, 512), moe.hot_capacity(full, 512)) == (32, 288)


def test_init_params_shapes_dtypes_and_scale():
    _, cfg = _cfg_pair()
    specs = moe.moe_specs(cfg, ())
    params = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    jparams = jax_init_params(jax_moe.moe_specs(_cfg_pair()[0], ()), jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype).endswith(str(leaf.dtype)), path
    w = params["w_gate"].float()
    # A unit normal truncated at +-3 has std 0.9866.
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 0.9866) < 0.03
    assert float(w.abs().max()) <= 3.0 / np.sqrt(cfg.d_model) * 1.01
    assert sum(t.numel() for t in params.values() if torch.is_tensor(t)) + sum(
        t.numel() for t in params["shared"].values()) == sum(leaf.size for _, leaf in flat)
    again = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["w_down"], params["w_down"])


def _jax_params_and_x(cfg_j, seed, b, s):
    params = jax_init_params(jax_moe.moe_specs(cfg_j, ()), jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).standard_normal((b, s, cfg_j.d_model)).astype(np.float32)
    return params, jnp.asarray(x).astype(jnp.bfloat16)


MOE_CASES = [
    ("no_hot", {}, None),
    ("hot", {}, [0, 1, 2, 3]),
    ("hot_with_empty_slot", {}, [5, -1, 2, 7]),
    ("tight_capacity", {"moe_capacity_factor": 0.5}, [1, 3, -1, -1]),
    ("ragged_group", {"moe_group_size": 48}, [6, 0, 3, 1]),
]


@pytest.mark.parametrize("name,overrides,hot", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_apply_matches_jax(name, overrides, hot):
    jcfg, cfg = _cfg_pair(**overrides)
    jparams, xj = _jax_params_and_x(jcfg, 3, 2, 80)
    hot_j = None if hot is None else jnp.asarray(hot, jnp.int32)
    yj, sj = jax_moe.moe_apply(jparams, xj, jcfg, None, hot_j)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    x = params_from_numpy({"x": np.asarray(xj)}, device="cpu")["x"]
    hot_t = None if hot is None else torch.tensor(hot, dtype=torch.int32)
    y, st = moe.moe_apply(params, x, cfg, None, hot_t)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    np.testing.assert_array_equal(st["counts"].numpy(), np.asarray(sj["counts"]))
    for key in ("dropped", "hot_frac"):
        assert float(st[key]) == float(sj[key]), key
    np.testing.assert_allclose(float(st["aux"]), float(sj["aux"]), rtol=1e-5)
    np.testing.assert_allclose(
        y.float().numpy(), np.asarray(yj, np.float32), atol=2e-2, rtol=0
    )
    if hot is not None and name != "tight_capacity":
        assert float(st["hot_frac"]) > 0
    if name == "tight_capacity":
        assert float(st["dropped"]) > 0


def test_moe_module_and_swiglu():
    jcfg, cfg = _cfg_pair()
    jparams, xj = _jax_params_and_x(jcfg, 4, 1, 64)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    x = params_from_numpy({"x": np.asarray(xj)}, device="cpu")["x"]
    from repro.models.layers import swiglu as jax_swiglu

    np.testing.assert_allclose(
        swiglu(params["shared"], x).float().numpy(),
        np.asarray(jax_swiglu(jparams["shared"], xj), np.float32), atol=2e-2, rtol=0,
    )
    layer = moe.MoE(cfg, params)
    y, st = layer(x, torch.arange(cfg.hot_expert_slots, dtype=torch.int32))
    y2, st2 = moe.moe_apply(params, x, cfg, None, torch.arange(cfg.hot_expert_slots, dtype=torch.int32))
    assert torch.equal(y, y2) and torch.equal(st["counts"], st2["counts"])


def test_out_of_slice_moe_inputs_raise():
    # moe_impl="sort" is ported (tests/test_torch_train_parts.py); an unknown
    # dispatch raises. A mesh is ported too (tests/test_torch_dist_mesh.py):
    # a DistSpec without one is the one-device run.
    from repro_torch.dist import DistSpec

    _, cfg = _cfg_pair(moe_impl="gather")
    params = init_params(moe.moe_specs(cfg, ()), torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="moe_impl"):
        moe.moe_apply(params, x, cfg)
    ecfg = dataclasses.replace(cfg, moe_impl="einsum")
    y, st = moe.moe_apply(params, x, ecfg, DistSpec())
    y2, st2 = moe.moe_apply(params, x, ecfg, None)
    assert torch.equal(y, y2) and torch.equal(st["counts"], st2["counts"])
