"""The port's ML-state placement (hot-row embedding cache, MoE expert
placement, traffic stats) against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

Tolerances, each with its reason:

* gathered rows, hit flags, ``hot_ids``, ``slot_map``, ``moved`` and the
  daemons' f32 counts — exact: copies, integers, and the same f32 adds in
  the same order (one add per token event, the decay as one f32 multiply);
* the ``hot_gather`` gradient — atol 1e-5, the reference kernel test's bar
  (``tests/test_kernels.py``); the scatter adds in the same order, so it is
  exact here;
* ``hit_rate`` — rtol 1e-6: a sum over the whole count matrix, in another
  order;
* MoE ``y`` — atol 2e-2 (bf16 einsums accumulated in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import traffic as jax_traffic  # noqa: E402
from repro.core.expert_placement import ExpertPlacement as JaxExpertPlacement  # noqa: E402
from repro.core.hot_embedding import HotEmbedding as JaxHotEmbedding  # noqa: E402
from repro.core.hot_embedding import embed_with_cache as jax_embed_with_cache  # noqa: E402
from repro.kernels.hot_gather.ops import hot_gather as jax_hot_gather  # noqa: E402
from repro.kernels.hot_gather.ref import hot_gather_ref as jax_hot_gather_ref  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core import traffic  # noqa: E402
from repro_torch.core.expert_placement import ExpertPlacement  # noqa: E402
from repro_torch.core.hot_embedding import HotEmbedding, embed_with_cache  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    expert_state_from_numpy,
    hot_embedding_state_from_numpy,
    params_from_numpy,
)
from repro_torch.kernels.hot_gather.ops import hot_gather  # noqa: E402
from repro_torch.models import moe  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (seen with torch 2.13 on AVX-512 hosts, about one
    process in eight); one call on a single element first avoids it."""
    torch.exp(torch.zeros(1))


def _np(t):
    return t.detach().cpu().numpy()


def _bits(a):
    """f32/bf16 arrays or tensors as integers, for bit-exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a.view(np.uint32)


def _gather_case(v, r, d, t, dtype, seed):
    rng = np.random.default_rng(seed)
    slot_map = np.full(v, -1, np.int32)
    slot_map[rng.choice(v, r, replace=False)] = np.arange(r, dtype=np.int32)
    table = rng.standard_normal((r, d)).astype(np.float32)
    tokens = rng.integers(0, v, t).astype(np.int32)
    return tokens, slot_map, table


@pytest.mark.parametrize("v,r,d,t", [(5000, 64, 256, 333), (1024, 8, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hot_gather_matches_jax(v, r, d, t, dtype):
    tokens, slot_map, table = _gather_case(v, r, d, t, dtype, v + t)
    jtable = jnp.asarray(table).astype(dtype)
    jrows, jhit = jax_hot_gather(jnp.asarray(tokens), jnp.asarray(slot_map), jtable, tt=128, td=128)
    rrows, rhit = jax_hot_gather_ref(jnp.asarray(tokens), jnp.asarray(slot_map), jtable)
    ttable = params_from_numpy({"t": np.asarray(jtable)}, device="cpu")["t"]
    rows, hit = hot_gather(torch.from_numpy(tokens), torch.from_numpy(slot_map), ttable)
    assert rows.dtype == ttable.dtype and hit.dtype == torch.bool
    np.testing.assert_array_equal(_np(hit), np.asarray(jhit))
    np.testing.assert_array_equal(_np(hit), np.asarray(rhit))
    got = _bits(rows)
    np.testing.assert_array_equal(got, _bits(jrows))
    np.testing.assert_array_equal(got, _bits(rrows))
    assert 0 < int(hit.sum()) < t


def test_hot_gather_gradient_matches_jax_grad():
    v, r, d = 200, 16, 32
    slot_map = np.full(v, -1, np.int32)
    slot_map[np.arange(r) * 3] = np.arange(r, dtype=np.int32)
    rng = np.random.default_rng(0)
    table = rng.standard_normal((r, d)).astype(np.float32)
    tokens = rng.integers(0, v, 64).astype(np.int32)
    jgrad = jax.grad(
        lambda tab: jnp.sum(jnp.sin(jax_hot_gather(jnp.asarray(tokens), jnp.asarray(slot_map), tab)[0]))
    )(jnp.asarray(table))
    ttable = torch.from_numpy(table).requires_grad_(True)
    rows, hit = hot_gather(torch.from_numpy(tokens), torch.from_numpy(slot_map), ttable)
    torch.sin(rows).sum().backward()
    np.testing.assert_allclose(_np(ttable.grad), np.asarray(jgrad), atol=1e-5, rtol=0)
    assert not hit.requires_grad
    # bf16 tables: the cotangent is summed in f32 and cast once.
    tb = ttable.detach().to(torch.bfloat16).requires_grad_(True)
    hot_gather(torch.from_numpy(tokens), torch.from_numpy(slot_map), tb)[0].float().sum().backward()
    assert tb.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tb.grad.float()).sum(1) / d, _count_hits(tokens, slot_map, r))


def _count_hits(tokens, slot_map, r):
    slots = slot_map[tokens]
    return np.bincount(slots[slots >= 0], minlength=r).astype(np.float32)


def _zipf_tokens(rng, v, shape, hot=64):
    return np.where(rng.random(shape) < 0.9, rng.integers(0, hot, shape), rng.integers(hot, v, shape))


def _assert_hot_state(state, jstate):
    np.testing.assert_array_equal(_bits(state.counts), _bits(jstate.counts))
    np.testing.assert_array_equal(_np(state.hot_ids), np.asarray(jstate.hot_ids))
    np.testing.assert_array_equal(_np(state.slot_map), np.asarray(jstate.slot_map))
    assert int(state.sweeps) == int(jstate.sweeps)


@pytest.mark.parametrize("rows,decay", [(64, 0.98), (16, 0.5), (300, 0.9)])
def test_hot_embedding_daemon_matches_jax(rows, decay):
    """Multi-sweep loop (as tests/test_redynis_integrations.py drives it):
    counts bit-exact, cache contents exact, then lookups exact."""
    v, n = 1000, 4
    he = HotEmbedding(vocab=v, num_nodes=n, rows=rows, period=5, decay=decay)
    jhe = JaxHotEmbedding(vocab=v, num_nodes=n, rows=rows, period=5, decay=decay)
    hs, jhs = he.init_state(device="cpu"), jhe.init_state()
    rng = np.random.default_rng(rows)
    nodes = (np.arange(8) % n).astype(np.int32)
    for step in range(17):
        toks = _zipf_tokens(rng, v, (8, 128)).astype(np.int32)
        hs = he.fold(hs, torch.from_numpy(toks), torch.from_numpy(nodes))
        jhs = jhe.fold(jhs, jnp.asarray(toks), jnp.asarray(nodes))
        if he.due(step + 1):
            hs, jhs = he.sweep(hs), jhe.sweep(jhs)
        _assert_hot_state(hs, jhs)
    assert int(hs.sweeps) == 3
    np.testing.assert_allclose(float(he.hit_rate(hs)), float(jhe.hit_rate(jhs)), rtol=1e-6)
    # Ties: integer totals tie often, the -1 scores of cold rows always.
    assert (_np(hs.hot_ids) >= 0).sum() == min(rows, int((_np(hs.counts).sum(1) > 0).sum()))
    # Lookups through the cache equal the table's rows, bit for bit.
    table = rng.standard_normal((1024, 32)).astype(np.float32)
    toks = _zipf_tokens(rng, v, (2, 64)).astype(np.int32)
    rows_out, hit = embed_with_cache(torch.from_numpy(table), torch.from_numpy(toks), hs)
    jrows, jhit = jax_embed_with_cache(jnp.asarray(table), jnp.asarray(toks), jhs)
    np.testing.assert_array_equal(_np(hit), np.asarray(jhit))
    np.testing.assert_array_equal(_np(rows_out), table[toks])
    np.testing.assert_array_equal(_np(rows_out), np.asarray(jrows))
    if rows >= 64:  # the cache holds the 64 hot tokens
        assert float(hit.float().mean()) > 0.5


def test_embed_with_cache_bf16_rows_exact_from_reference_state():
    """A reference state carried across: bf16 rows equal ``table[tokens]``."""
    v, n, r = 512, 4, 32
    jhe = JaxHotEmbedding(vocab=v, num_nodes=n, rows=r, period=1)
    rng = np.random.default_rng(7)
    toks = _zipf_tokens(rng, v, (4, 64), hot=40).astype(np.int32)
    jhs = jhe.sweep(jhe.fold(jhe.init_state(), jnp.asarray(toks), jnp.arange(4, dtype=jnp.int32)))
    hs = hot_embedding_state_from_numpy(*(np.asarray(a) for a in jhs), device="cpu")
    jtable = jnp.asarray(rng.standard_normal((v, 48)).astype(np.float32)).astype(jnp.bfloat16)
    table = params_from_numpy({"t": np.asarray(jtable)}, device="cpu")["t"]
    rows_out, hit = embed_with_cache(table, torch.from_numpy(toks), hs)
    assert torch.equal(rows_out, table[torch.from_numpy(toks).long()])
    jrows, jhit = jax_embed_with_cache(jtable, jnp.asarray(toks), jhs)
    np.testing.assert_array_equal(_np(hit), np.asarray(jhit))
    np.testing.assert_array_equal(_bits(rows_out), _bits(jrows))
    assert bool(hit.any()) and not bool(hit.all())


def _assert_expert_state(state, jstate):
    np.testing.assert_array_equal(_bits(state.counts), _bits(jstate.counts))
    np.testing.assert_array_equal(_np(state.hot_ids), np.asarray(jstate.hot_ids))
    assert int(state.step) == int(jstate.step) and int(state.sweeps) == int(jstate.sweeps)
    assert float(state.moved) == float(jstate.moved)


def test_expert_placement_tracks_hot_experts_like_jax():
    """tests/test_redynis_integrations.py's tracking loop on both daemons."""
    args, kw = (3, 16, 4), dict(slots=4, period=10)
    ep, jep = ExpertPlacement(*args, **kw), JaxExpertPlacement(*args, **kw)
    st, jst = ep.init_state(device="cpu"), jep.init_state()
    rng = np.random.default_rng(0)
    nodes = (np.arange(8) % 4).astype(np.int32)
    moved = []
    for step in range(30):
        counts = np.zeros((3, 8, 16), np.float32)
        for layer in range(3):
            for g in range(8):
                np.add.at(counts[layer, g], rng.choice([3, 7, 11], 100), 1)
                np.add.at(counts[layer, g], rng.integers(0, 16, 25), 1)
        st = ep.fold(st, torch.from_numpy(counts), torch.from_numpy(nodes))
        jst = jep.fold(jst, jnp.asarray(counts), jnp.asarray(nodes))
        if ep.due(step + 1):
            st, jst = ep.sweep(st), jep.sweep(jst)
            moved.append(float(st.moved))
        _assert_expert_state(st, jst)
    for layer in range(3):
        assert {3, 7, 11} <= set(_np(st.hot_ids)[layer].tolist())
    np.testing.assert_allclose(float(ep.hit_rate(st)), float(jep.hit_rate(jst)), rtol=1e-6)
    assert moved[0] > 0


@pytest.mark.parametrize("nodes_of_group", ["spread", "one_rank"])
def test_expert_placement_shift_and_skew_like_jax(nodes_of_group):
    """Traffic shifts under a fast decay, with ties among equal totals and
    silent layers; skewed per-rank traffic exercises the starvation guard."""
    ep, jep = ExpertPlacement(3, 16, 2, slots=2, period=5, decay=0.5), JaxExpertPlacement(
        3, 16, 2, slots=2, period=5, decay=0.5)
    st, jst = ep.init_state(device="cpu"), jep.init_state()
    nodes = (np.arange(4) % 2 if nodes_of_group == "spread" else np.zeros(4)).astype(np.int32)
    for hot, steps in ((2, 10), (9, 20)):
        for _ in range(steps):
            counts = np.zeros((3, 4, 16), np.float32)
            counts[:2, :, hot] = 50.0  # layer 2 stays silent: it keeps its set
            counts[:2, :, [4, 5]] = 7.0  # equal totals: the lower id first
            st = ep.fold(st, torch.from_numpy(counts), torch.from_numpy(nodes))
            jst = jep.fold(jst, jnp.asarray(counts), jnp.asarray(nodes))
            if ep.due(int(st.step)):
                st, jst = ep.sweep(st), jep.sweep(jst)
            _assert_expert_state(st, jst)
        assert hot in _np(st.hot_ids)[0]
    assert _np(st.hot_ids)[2].tolist() == [0, 1]


def test_expert_state_from_numpy_round_trip():
    jep = JaxExpertPlacement(2, 8, 4, slots=3, period=1)
    jst = jep.sweep(jep.fold(jep.init_state(), jnp.ones((2, 4, 8)), jnp.arange(4, dtype=jnp.int32)))
    st = expert_state_from_numpy(*(np.asarray(a) for a in jst), device="cpu")
    ep = ExpertPlacement(2, 8, 4, slots=3, period=1)
    _assert_expert_state(st, jst)
    _assert_expert_state(ep.sweep(st), jep.sweep(jst))


def test_traffic_stats_match_jax():
    rng = np.random.default_rng(4)
    k, n = 50, 3
    stats, jstats = traffic.create_stats(k, n, device="cpu"), jax_traffic.create_stats(k, n)
    for now in range(1, 6):
        delta = (rng.random((k, n)) < 0.2).astype(np.float32) * rng.integers(1, 5, (k, n))
        stats = traffic.fold_counts(stats, torch.from_numpy(delta), now)
        jstats = jax_traffic.fold_counts(jstats, jnp.asarray(delta), now)
        objs = rng.integers(0, k, 40).astype(np.int32)
        nds = rng.integers(0, n, 40).astype(np.int32)
        w = (rng.random(40) * 3).astype(np.float32)
        stats = traffic.fold_events(
            stats, torch.from_numpy(objs), torch.from_numpy(nds), now, torch.from_numpy(w))
        jstats = jax_traffic.fold_events(jstats, jnp.asarray(objs), jnp.asarray(nds), now, jnp.asarray(w))
        stats = traffic.fold_events(stats, torch.from_numpy(objs[:5]), torch.from_numpy(nds[:5]), now + 1)
        jstats = jax_traffic.fold_events(jstats, jnp.asarray(objs[:5]), jnp.asarray(nds[:5]), now + 1)
        stats, jstats = traffic.decay_stats(stats, 0.9), jax_traffic.decay_stats(jstats, 0.9)
        np.testing.assert_array_equal(_bits(stats.counts), _bits(jstats.counts))
        np.testing.assert_array_equal(_np(stats.last_access), np.asarray(jstats.last_access))
        np.testing.assert_allclose(float(stats.total_events), float(jstats.total_events), rtol=1e-6)
    assert stats.num_objects == k and stats.num_nodes == n


def test_daemon_step_loop_matches_jax():
    """The slice as a whole: the Trainer's daemon step (embed through the
    cache, MoE layers with their layer's hot set, fold both daemons, sweep
    when due), forward only, on the reduced deepseek-moe-16b config."""
    jcfg = jax_reduced(jax_get_config("deepseek-moe-16b"), sweep_period=2)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    layers, b, s, n = 2, 4, 32, 2
    keys = jax.random.split(jax.random.PRNGKey(5), layers)
    jparams = [jax_init_params(jax_moe.moe_specs(jcfg, ()), kk) for kk in keys]
    params = [params_from_numpy(jax.tree.map(np.asarray, p), device="cpu") for p in jparams]
    rng = np.random.default_rng(5)
    jtable = jnp.asarray(rng.standard_normal((cfg.padded_vocab, cfg.d_model)).astype(np.float32))
    jtable = jtable.astype(jnp.bfloat16)
    table = params_from_numpy({"t": np.asarray(jtable)}, device="cpu")["t"]
    dkw = dict(decay=cfg.traffic_decay, period=cfg.sweep_period)
    he, jhe = (cls(cfg.padded_vocab, n, cfg.hot_embed_rows, **dkw) for cls in (HotEmbedding, JaxHotEmbedding))
    ep, jep = (cls(layers, cfg.num_experts, n, cfg.hot_expert_slots, **dkw)
               for cls in (ExpertPlacement, JaxExpertPlacement))
    hs, jhs = he.init_state(device="cpu"), jhe.init_state()
    es, jes = ep.init_state(device="cpu"), jep.init_state()
    ranks = np.arange(1, cfg.padded_vocab + 1) ** -1.1
    tok_nodes = (np.arange(b) // (b // n) % n).astype(np.int32)
    hit_fracs = []
    for step in range(1, 7):
        toks = rng.choice(cfg.padded_vocab, (b, s), p=ranks / ranks.sum()).astype(np.int32)
        x, hit = embed_with_cache(table, torch.from_numpy(toks), hs)
        jx, jhit = jax_embed_with_cache(jtable, jnp.asarray(toks), jhs)
        np.testing.assert_array_equal(_np(hit), np.asarray(jhit))
        assert torch.equal(x, table[torch.from_numpy(toks).long()])
        hit_fracs.append(float(hit.float().mean()))
        counts, jcounts = [], []
        for layer in range(layers):
            y, st = moe.moe_apply(params[layer], x, cfg, None, es.hot_ids[layer])
            jy, jst = jax_moe.moe_apply(jparams[layer], jx, jcfg, None, jes.hot_ids[layer])
            np.testing.assert_array_equal(_np(st["counts"]), np.asarray(jst["counts"]))
            assert float(st["hot_frac"]) == float(jst["hot_frac"])
            assert float(st["dropped"]) == float(jst["dropped"])
            np.testing.assert_allclose(_np(y.float()), np.asarray(jy, np.float32), atol=2e-2, rtol=0)
            counts.append(st["counts"])
            jcounts.append(jst["counts"])
        g = counts[0].shape[0]
        group_nodes = (np.arange(g) // max(g // n, 1) % n).astype(np.int32)
        es = ep.fold(es, torch.stack(counts), torch.from_numpy(group_nodes))
        jes = jep.fold(jes, jnp.stack(jcounts), jnp.asarray(group_nodes))
        hs = he.fold(hs, torch.from_numpy(toks), torch.from_numpy(tok_nodes))
        jhs = jhe.fold(jhs, jnp.asarray(toks), jnp.asarray(tok_nodes))
        if ep.due(step):
            es, jes = ep.sweep(es), jep.sweep(jes)
            hs, jhs = he.sweep(hs), jhe.sweep(jhs)
        _assert_expert_state(es, jes)
        _assert_hot_state(hs, jhs)
    assert hit_fracs[0] == 0.0 and hit_fracs[-1] > 0.3
