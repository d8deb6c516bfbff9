"""``ServeEngine`` for the four families of this
slice — rwkv6-1.6b, recurrentgemma-2b, whisper-base and llava-next-34b —
against the JAX reference's on the CPU (reduced configs, params carried
across with ``params_from_numpy``, prompts drawn with numpy from a seed).

Bars, each with its reason:

* the decode state's bytes (``state_bytes``, the router's migration
  payload) — exact: the same leaves of the same shapes and dtypes;
* logits — atol 0.05, ``tests/test_torch_families.py``'s bf16 bar (the
  reason is there); the port's engine is teacher-forced with the
  reference's tokens, and its own greedy token must equal the reference's
  wherever the reference's top-2 margin is wider than twice the largest
  logit difference.

The serving launcher of these families is held in
``tests/test_torch_family_launch.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serving.kvcache import state_bytes as jax_state_bytes  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import Request, ServeEngine, state_bytes  # noqa: E402

LOGIT_ATOL = 0.05
ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b", "whisper-base", "llava-next-34b"]


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


def _engines(arch: str, lanes: int, cache_len: int):
    """The reference's engine and the port's on the same params, the port's
    teacher-forced: each of its sampling calls records its own logits and
    greedy tokens and hands on the reference's tokens from the same call.
    Drive them in turns, the reference first."""
    jcfg = jax_reduced(jax_get_config(arch))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(ModelConfig(**dataclasses.asdict(jcfg)), "cpu")
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jeng = JaxServeEngine(jm, jp, num_lanes=lanes, cache_len=cache_len)
    eng = ServeEngine(m, p, num_lanes=lanes, cache_len=cache_len)
    jlog, log = [], []
    jsample, sample = jeng._sample, eng._sample

    def jax_sample(logits):
        tok = jsample(logits)
        jlog.append((np.asarray(logits, np.float32), np.asarray(tok)))
        return tok

    def forced_sample(logits):
        log.append((logits.float().numpy(), sample(logits).numpy()))
        return torch.from_numpy(np.array(jlog[len(log) - 1][1], np.int32))

    jeng._sample, eng._sample = jax_sample, forced_sample
    return jeng, eng, jlog, log


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generation_and_state_bytes_match_jax(arch):
    """Three sessions on two lanes (the third evicts the least recently used
    one, whose whole lane slice is then overwritten), a request joining
    mid-flight, to completion; prompts of 9 tokens (under one RWKV chunk)
    and 32 (one chunk)."""
    jeng, eng, jlog, log = _engines(arch, lanes=2, cache_len=64)
    cfg = eng.model.cfg
    assert state_bytes(eng.state) == jax_state_bytes(jeng.state) == eng.cache_bytes()
    rng = np.random.default_rng(0)
    # Two prompt lengths, so that the reference compiles two prefills.
    plan = [("a", 9, 5), ("step",), ("b", 32, 4), ("step",), ("c", 9, 3), ("step",), ("step",)]
    for item in plan:
        if item[0] == "step":
            out = jeng.step()
            assert eng.step() == out
            continue
        sid, n, max_new = item
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        lanes = {e.admit(req(sid, prompt, max_new=max_new))
                 for e, req in ((jeng, JaxRequest), (eng, Request))}
        assert len(lanes) == 1
    while True:
        out = jeng.step()
        assert eng.step() == out
        if not out:
            break
    assert len(jlog) == len(log) and len(eng.outputs) == 3
    for (jl, jt), (lg, t) in zip(jlog, log):
        np.testing.assert_allclose(lg, jl, atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * np.abs(lg - jl).max()
        np.testing.assert_array_equal(t[clear], jt[clear])
    assert eng.outputs == jeng.outputs and eng.tokens_out == jeng.tokens_out
    assert state_bytes(eng.state) == jax_state_bytes(jeng.state)
