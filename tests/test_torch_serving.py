"""The port's serving path against the JAX reference, on the CPU: the
model's prefill and decode step, the batched engine, the Redynis session
router and its placement daemon, and the serving launcher.

The models are the reduced configs (``reduced``); the reference's params
are carried across bit for bit with ``params_from_numpy``, and prompts and
request streams are made with numpy from a seed.

Tolerances, each with its reason:

* logits — 2e-2 (atol and rtol), the bf16 bar of ``tests/test_kernels.py``:
  the reference's prefill attention (``blockwise_attention``) rounds each
  block's PV product to bf16 where the Pallas kernel and the port keep it
  in f32, so activations differ by a bf16 ulp from layer 1 on;
* the KV cache — rtol 2e-2 and atol 2**-4: the bf16 projections sum
  their f32 products in another order (an element can round the other
  way); k and v have unit RMS (qk-norm), and a bf16 ulp in a layer's
  input moves an element of any size by a few ulps of that unit scale
  (2**-7 each), so the bar is absolute at 8 of them;
* greedy tokens — the port's engine is teacher-forced with the
  reference's tokens, and its own greedy token must equal the reference's
  wherever the reference's top-2 margin is wider than twice the largest
  logit difference (which forces the same argmax); within that margin
  (a near tie; the reduced model's random logits have many) either token
  is right;
* router stats, placement plans and metadata — exact (integers, booleans,
  and the same f32 decay).
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import metadata as jax_metadata  # noqa: E402
from repro.core import placement as jax_placement  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serving import SessionRouter as JaxSessionRouter  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core import metadata  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.interop import kv_cache_from_numpy, params_from_numpy, store_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import Request, ServeEngine, SessionRouter  # noqa: E402

TOL = 2e-2
CACHE_ATOL = 2**-4


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (seen with torch 2.13 on AVX-512 hosts, about one
    process in eight); one call on a single element first avoids it."""
    torch.exp(torch.zeros(1))


def _models(arch: str, **overrides):
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(ModelConfig(**dataclasses.asdict(jcfg)), "cpu")
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _models("qwen3-1.7b")


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _check_cache(cache, jcache, s: int):
    """Every layer to the cache bar, the padding zeros."""
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        got, want = _f32(got), _f32(want)
        np.testing.assert_allclose(got, want, atol=CACHE_ATOL, rtol=TOL)
        assert not got[:, :, s:].any()
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))


@pytest.mark.parametrize("window", [0, 16])
def test_prefill_and_decode_steps_match_jax(window):
    """Prefill and four decode steps; window 16 takes the sliding-window
    masks and the ring-buffer slot of the decode write."""
    jm, jp, m, p = _models("qwen3-1.7b", window=window)
    toks = np.random.default_rng(0).integers(0, m.cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=48)
    logits, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)}, cache_len=48)
    assert logits.dtype == torch.float32 and logits.shape == (2, m.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _check_cache(cache, jcache, 37)
    # Decode from the reference's own state, fed the reference's tokens.
    state = kv_cache_from_numpy(*(np.asarray(a) for a in jcache), device="cpu")
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(4):
        jl, jcache = jm.decode_step(jp, jcache, tok)
        logits, state = m.decode_step(p, state, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    _check_cache(state, jcache, 41)


def _engines(qwen, lanes: int, cache_len: int):
    """A reference engine and the port's, the port's teacher-forced: each
    of its sampling calls records its own logits and greedy tokens, and
    hands on the reference's tokens from the same call, so both engines
    see the same inputs at every step. Drive them in turns, the
    reference first."""
    jm, jp, m, p = qwen
    jeng = JaxServeEngine(jm, jp, num_lanes=lanes, cache_len=cache_len)
    eng = ServeEngine(m, p, num_lanes=lanes, cache_len=cache_len)
    jlog, log = [], []
    jsample, sample = jeng._sample, eng._sample

    def jax_sample(logits):
        tok = jsample(logits)
        jlog.append((np.asarray(logits, np.float32), np.asarray(tok)))
        return tok

    def forced_sample(logits):
        own = sample(logits)
        log.append((logits.float().numpy(), own.numpy()))
        return torch.from_numpy(np.array(jlog[len(log) - 1][1], np.int32))

    jeng._sample, eng._sample = jax_sample, forced_sample
    return jeng, eng, jlog, log


def _assert_same_generation(jeng, eng, jlog, log):
    """Every step's logits to the bar, every lane's greedy token equal to
    the reference's but at near ties (a top-2 margin within twice the
    largest logit difference, where either token is right). Returns the
    near-tie count."""
    assert len(jlog) == len(log)
    near = 0
    for (jl, jt), (l, t) in zip(jlog, log):
        np.testing.assert_allclose(l, jl, atol=TOL, rtol=TOL)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= 2 * np.abs(l - jl).max()
        np.testing.assert_array_equal(t[~tie], jt[~tie])
        near += int((t != jt).sum())
    assert eng.outputs == jeng.outputs
    assert eng.tokens_out == jeng.tokens_out and eng.steps == jeng.steps
    return near


def _finish(jeng, eng):
    """``run_to_completion`` on both, step by step in turns."""
    while True:
        out = jeng.step()
        assert eng.step() == out
        if not out:
            return


def _prompt(rng, n, vocab):
    return rng.integers(0, vocab, n).astype(np.int32)


def test_engine_batched_generation_matches_jax(qwen):
    jeng, eng, jlog, log = _engines(qwen, lanes=4, cache_len=64)
    rng = np.random.default_rng(0)
    for i in range(3):
        prompt = _prompt(rng, 12, qwen[2].cfg.vocab_size)
        for e, req in ((jeng, JaxRequest), (eng, Request)):
            e.admit(req(f"s{i}", prompt, max_new=5))
    _finish(jeng, eng)
    assert all(len(v) == 6 for v in eng.outputs.values()) and eng.tokens_out == 15
    _assert_same_generation(jeng, eng, jlog, log)


def test_engine_interleaved_admission_and_lane_reuse_match_jax(qwen):
    """A request joins mid-flight, and a fourth session on two lanes evicts
    the least recently used one: the re-bound lane must hold nothing of its
    last session (its whole slice is overwritten)."""
    jeng, eng, jlog, log = _engines(qwen, lanes=2, cache_len=32)
    vocab = qwen[2].cfg.vocab_size
    rng = np.random.default_rng(1)
    plan = [("a", 8, 6), ("step",), ("b", 10, 4), ("step",), ("c", 5, 3), ("step",), ("step",),
            ("d", 9, 4)]
    for item in plan:
        if item[0] == "step":
            out = jeng.step()
            assert eng.step() == out
            continue
        sid, n, max_new = item
        prompt = _prompt(rng, n, vocab)
        lanes = {e.admit(req(sid, prompt, max_new=max_new))
                 for e, req in ((jeng, JaxRequest), (eng, Request))}
        assert len(lanes) == 1
    _finish(jeng, eng)
    assert len(eng.outputs) == 4
    _assert_same_generation(jeng, eng, jlog, log)


def test_engine_cache_overflow_matches_jax(qwen):
    """Lengths outgrow a small cache: the reference drops the writes past
    the last slot and its mask then admits the whole cache; the port must
    give the same tokens (and must not raise on the out-of-range slot)."""
    jeng, eng, jlog, log = _engines(qwen, lanes=2, cache_len=16)
    rng = np.random.default_rng(2)
    for sid, n in (("x", 12), ("y", 15)):
        prompt = _prompt(rng, n, qwen[2].cfg.vocab_size)
        for e, req in ((jeng, JaxRequest), (eng, Request)):
            e.admit(req(sid, prompt, max_new=9))
    _finish(jeng, eng)
    assert int(eng.state.length.max()) > eng.cache_len
    _assert_same_generation(jeng, eng, jlog, log)
    np.testing.assert_allclose(_f32(eng.state.k), _f32(jeng.state.k), atol=CACHE_ATOL, rtol=TOL)


def test_engine_sampling_is_seeded(qwen):
    """``temperature > 0`` draws from a seeded ``torch.Generator``: the
    same seed gives the same tokens, another seed other tokens (the bits
    are not the reference's, so this is not held against JAX)."""
    _, _, m, p = qwen
    outs = []
    for seed in (7, 7, 8):
        eng = ServeEngine(m, p, num_lanes=2, cache_len=32, temperature=1.0, seed=seed)
        eng.admit(Request("a", np.arange(8) % m.cfg.vocab_size, max_new=12))
        outs.append(eng.run_to_completion()["a"])
    assert outs[0] == outs[1] != outs[2]
    assert all(0 <= t < m.cfg.vocab_size for t in outs[0])


@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_norms_and_rope_match_jax(positions):
    """rmsnorm, layernorm and rope on bf16 activations: f32 math rounded
    once to bf16, so within one bf16 ulp (rtol 2**-7)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    scale, bias = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    pos = np.arange(9) + 100 if positions == "shared" else rng.integers(0, 5000, (2, 9))
    pairs = [
        (layers.rmsnorm(torch.from_numpy(scale), tx), jax_layers.rmsnorm(jnp.asarray(scale), jx)),
        (layers.layernorm(torch.from_numpy(scale), torch.from_numpy(bias), tx),
         jax_layers.layernorm(jnp.asarray(scale), jnp.asarray(bias), jx)),
        (layers.rope(tx, torch.from_numpy(pos), 1e6), jax_layers.rope(jx, jnp.asarray(pos), 1e6)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2**-7, atol=2**-7)


def test_moe_prefill_matches_jax():
    """The MoE branch of ``mlp_apply`` (reduced deepseek-moe-16b)."""
    jm, jp, m, p = _models("deepseek-moe-16b")
    toks = np.random.default_rng(3).integers(0, m.cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=32)
    logits, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)}, cache_len=32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _check_cache(cache, jcache, 24)


def _store_arrays(rng, k, n):
    counts = rng.integers(0, 5, (k, n)).astype(np.int32)
    counts[rng.random(k) < 0.3] = 0
    return (counts, rng.random((k, n)) < 0.4, rng.integers(0, 20, k).astype(np.int32),
            rng.random(k) < 0.9, rng.integers(0, n, k).astype(np.int32))


def _assert_store(store, jstore):
    for name in ("access_counts", "hosts", "last_access", "live", "home"):
        np.testing.assert_array_equal(getattr(store, name).numpy(), np.asarray(getattr(jstore, name)),
                                      err_msg=name)


@pytest.mark.parametrize("expiry,decay,avail", [(None, 1.0, False), (5, 0.5, False), (0, 0.9, True)])
def test_placement_daemon_step_matches_jax(expiry, decay, avail):
    rng = np.random.default_rng(7)
    k, n = 200, 4
    arrays = _store_arrays(rng, k, n)
    jstore = jax_metadata.MetadataStore(*(jnp.asarray(a) for a in arrays))
    store = store_from_numpy(*arrays, device="cpu")
    up = np.array([True, False, True, True])
    jd = jax_placement.PlacementDaemon(n, expiry=expiry, decay=decay)
    d = placement.PlacementDaemon(n, expiry=expiry, decay=decay)
    jplan, jstore = jd.step(jstore, 20, avail=jnp.asarray(up) if avail else None)
    plan, store = d.step(store, 20, avail=torch.from_numpy(up) if avail else None)
    for name in ("owners", "to_add", "to_drop", "expired", "f"):
        np.testing.assert_array_equal(getattr(plan, name).numpy(), np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    _assert_store(store, jstore)
    present = rng.random((k, n)) < 0.5
    np.testing.assert_array_equal(placement.apply_plan(torch.from_numpy(present), plan).numpy(),
                                  np.asarray(jax_placement.apply_plan(jnp.asarray(present), jplan)))


def test_placement_rejects_what_is_not_ported():
    store = metadata.create_store(4, 2, "cpu")
    # A finite budget is ported (tests/test_torch_capacity.py holds it to
    # JAX): a zero budget admits no replica.
    plan, _ = placement.sweep(store._replace(hosts=torch.ones(4, 2, dtype=torch.bool),
                                             live=torch.ones(4, dtype=torch.bool)),
                              0.5, 0, capacity_bytes=torch.zeros(2))
    assert not plan.owners.any() and plan.capacity_evicted.all()
    with pytest.raises(ValueError, match="backend"):
        placement.PlacementDaemon(2, backend="tpu")


def test_record_new_keys_matches_jax():
    """A mixed batch: new keys get their home and replica, live keys are
    left alone, and every row's access is logged."""
    rng = np.random.default_rng(9)
    arrays = _store_arrays(rng, 50, 3)
    jstore = jax_metadata.MetadataStore(*(jnp.asarray(a) for a in arrays))
    store = store_from_numpy(*arrays, device="cpu")
    keys = rng.choice(50, 20, replace=False).astype(np.int32)
    nodes = rng.integers(0, 3, 20).astype(np.int32)
    jstore = jax_metadata.record_new_keys(jstore, jnp.asarray(keys), jnp.asarray(nodes), 33)
    store = metadata.record_new_keys(store, torch.from_numpy(keys), torch.from_numpy(nodes), 33)
    _assert_store(store, jstore)


def test_session_router_matches_jax():
    """One request stream through both routers: sessions created on pod 0,
    then served from their home pods (the daemon migrates them), then the
    leader fails and is re-elected. Stats and metadata equal after every
    phase."""
    kw = dict(num_pods=4, max_sessions=64, sweep_period=10, session_bytes=1e6)
    jr, r = JaxSessionRouter(**kw), SessionRouter(**kw, device="cpu")
    rng = np.random.default_rng(2)
    for i in range(16):
        assert r.route(f"sess{i}", 0) == jr.route(f"sess{i}", 0)
    home = {f"sess{i}": i % 4 for i in range(16)}
    for _ in range(300):
        s = f"sess{rng.integers(0, 16)}"
        assert r.route(s, home[s]) == jr.route(s, home[s])
        r.tick()
        jr.tick()
    assert r.stats == jr.stats and r.stats["migrations"] > 0 and r.hit_rate() > 0.5
    _assert_store(r.store, jr.store)
    lead = r.leader
    r.fail_pod(lead)
    jr.fail_pod(lead)
    for _ in range(12):
        s = f"sess{rng.integers(0, 16)}"
        assert r.route(s, home[s]) == jr.route(s, home[s])
        r.tick()
        jr.tick()
    assert r.leader == jr.leader != lead
    assert r.stats == jr.stats and r.stats["elections"] == 1
    _assert_store(r.store, jr.store)


def test_serve_launcher_on_cpu_matches_jax_router_line(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu`` runs the whole
    path; its router line (hit rate, migrations, elections after a pod
    fails) equals the reference launcher's on the same arguments."""
    args = ["--requests", "24", "--sessions", "6", "--lanes", "4", "--prompt-len", "10",
            "--max-new", "4", "--fail-pod", "3"]
    serve.main(args + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jax_serve.main()
    theirs = capsys.readouterr().out.splitlines()
    assert ours[0] == theirs[0] == "!! killing pod 3 (leader=3)"
    assert ours[-1] == theirs[-1] and "elections=1" in ours[-1]
    assert ours[1].split(" in ")[0] == theirs[1].split(" in ")[0]  # tokens served
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the default device is valid here")
        serve.main(args)
