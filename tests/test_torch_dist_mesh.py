"""The port's distribution seam on a mesh: one group of 4 gloo CPU ranks
(``spmd.run_ranks``, started once for the file), meshes (data 2, model 2)
and (pod 1, data 2, model 2), against the JAX package's **local** results
on the same numpy inputs — the six checks of ``tests/test_distributed.py``
at the reference's own bars:

* ``embed_lookup`` (vocab over model, rows over data): exact;
* ``softmax_xent`` (vocab-split logits, f32): rtol 1e-5;
* reduced qwen3-1.7b and granite-moe-1b-a400m (2 layers), and reduced
  llama3.2-3b with 3 heads and 1 kv head (the head count the model axis
  does not divide: head_dim split in params, attention computed whole,
  the decode cache split by sequence): the sharded bf16 loss within rtol
  2e-2 of JAX's and 1e-3 of the port's own local loss; in f32 the sharded
  loss within 1e-5 of the port's local loss and every gradient block within
  relative L2 1e-5 of the local gradient's block (measured ~1e-6: f32 sums
  in another order);
* sharded decode logits (prefill of 2 prompts, then 4 teacher-forced
  steps) within atol 0.15, rtol 0.05 of JAX's local decode;
* ``Trainer.run`` on the mesh (f32 qwen3, int8 gradient compression, the
  hot-row daemon sweeping, a checkpoint at step 2) against the same run
  on one device: the losses rtol 1e-5, the params gathered whole within
  relative L2 1e-4 a leaf (measured 1.1e-8; an int8 level may flip where ``g / scale + u``
  lies within f32 noise of an integer, ``tests/test_torch_trainer.py``),
  the daemon state exact, the checkpoint restored on the mesh equal to the
  state it saved; ``ServeEngine`` on the mesh (bf16, lanes over data, kv
  heads over model) giving the one-device engine's greedy tokens.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.dist import embed_lookup as jax_embed_lookup  # noqa: E402
from repro.dist import softmax_xent as jax_softmax_xent  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")), "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
MODELS = {  # name: (arch, overrides of reduced(), meshes)
    "qwen3": ("qwen3-1.7b", {}, ("2x2", "1x2x2")),
    "granite": ("granite-moe-1b-a400m", {}, ("2x2", "1x2x2")),
    "llama-uneven": ("llama3.2-3b", {"num_heads": 3, "num_kv_heads": 1}, ("2x2",)),
}
DECODE = ("qwen3", "llama-uneven")
B, S, NEW, CACHE = 4, 32, 4, 48


def _jax_cfg(name):
    arch, ov, _ = MODELS[name]
    return jax_reduced(jax_get_config(arch), num_layers=2, remat="none", **ov)


def _inputs():
    """Every case's numpy inputs, made once from seeds."""
    rng = np.random.default_rng(0)
    v, d = 512, 64
    units = {
        "table": rng.standard_normal((v, d)).astype(np.float32),
        "tokens": rng.integers(0, v, (B, 16)).astype(np.int32),
        "x": rng.standard_normal((B, 16, d)).astype(np.float32),
        "targets": rng.integers(0, v - 20, (B, 16)).astype(np.int32),
        "mask": rng.random((B, 16)) < 0.9,
        "vocab": v - 12,
    }
    models = {}
    for name in MODELS:
        jcfg = _jax_cfg(name)
        params = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
        toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
        targets = toks[:, 1:].copy()
        targets[0, :3] = -1
        models[name] = {"cfg": dataclasses.asdict(jcfg), "params": params,
                        "batch": {"tokens": toks[:, :-1], "targets": targets}}
    return units, models


# ---------------------------------------------------------------------------
# The ranks' side (module-level: the spawned ranks import it).


def _place_rows(t, dist):
    from repro_torch.launch.sharding import NamedSharding, place

    return place(t, NamedSharding(dist.mesh, (dist.batch,) + (None,) * (t.dim() - 1)), dist)


def _whole_rows(t, dist):
    from repro_torch.dist import all_gather

    return all_gather(t.detach(), 0, dist, dist.batch_axes)


def _units(units, dist):
    from repro_torch.dist import embed_lookup, softmax_xent
    from repro_torch.launch.sharding import NamedSharding, place

    table = place(torch.from_numpy(units["table"]), NamedSharding(dist.mesh, ("model", None)), dist)
    tok = _place_rows(torch.from_numpy(units["tokens"]), dist)
    emb = _whole_rows(embed_lookup(table, tok, dist), dist)
    xent = softmax_xent(_place_rows(torch.from_numpy(units["x"]), dist), table,
                        _place_rows(torch.from_numpy(units["targets"]), dist), dist,
                        mask=_place_rows(torch.from_numpy(units["mask"]), dist), num_chunks=4,
                        vocab_size=units["vocab"])
    return {"embed": emb.numpy(), "xent": float(xent)}


def _model_case(case, dist, f32: bool, decode: bool):
    from repro_torch import dist as D
    from repro_torch import tree as tree_lib
    from repro_torch.configs import ModelConfig
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch import sharding as sh
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import _entry_leaves

    class PortF32(Model):
        def embed_tokens(self, params, tokens, dist=None, hot_embed=None):
            return D.embed_lookup(params["embed"], tokens, dist)

    cfg = ModelConfig(**case["cfg"])
    model = (PortF32 if f32 else Model)(cfg, "cpu")
    params = params_from_numpy(case["params"], "cpu")
    if f32:
        params = tree_lib.tree_map(lambda t: t.float(), params)
    shardings = sh.param_shardings(model, dist.mesh)
    local = sh.place_tree(params, shardings, dist)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    lb = {k: _place_rows(v, dist) for k, v in batch.items()}
    out = {}
    leaves = tree_lib.leaves(local)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = model.loss(local, lb, dist)[0]
    full = tree_lib.leaves(params)
    for leaf in full:
        leaf.requires_grad_(True)
    ref = model.loss(params, batch, None)[0]
    out["loss"], out["local_loss"] = float(loss), float(ref)
    if f32:
        grads = D.sync_grads(list(torch.autograd.grad(loss, leaves)),
                             _entry_leaves(sh.param_entries(model, dist.mesh)), dist)
        rgrads = torch.autograd.grad(ref, full)
        errs = []
        for g, rg, s in zip(grads, rgrads, tree_lib.leaves(shardings)):
            want = sh.place(rg, s, dist).double()
            errs.append(float((g.double() - want).norm() / max(float(want.norm()), 1e-30)))
        out["grad_rel_l2"] = max(errs)
    if decode:
        out["decode"] = _decode(model, local, case, dist)
    return out


def _decode(model, local, case, dist):
    """Prefill 2 prompts (cache ``CACHE``), then ``NEW`` steps fed the
    reference's greedy tokens (``case["feed"]``); every step's whole logits."""
    from repro_torch.dist import gather_logits

    with torch.no_grad():  # the 2 prompts split over data 2
        prompts = torch.from_numpy(case["batch"]["tokens"][:2])
        logits, state = model.prefill(local, {"tokens": _place_rows(prompts, dist)}, dist,
                                      cache_len=CACHE)
        steps = [_whole_rows(gather_logits(logits, dist), dist).numpy()]
        for tok in case["feed"]:
            logits, state = model.decode_step(local, state, _place_rows(torch.from_numpy(tok), dist), dist)
            steps.append(_whole_rows(gather_logits(logits, dist), dist).numpy())
    return np.stack(steps)


def _f32_model(cfg_dict):
    from repro_torch import dist as D
    from repro_torch.configs import ModelConfig
    from repro_torch.models.model import Model

    class PortF32(Model):
        def embed_tokens(self, params, tokens, dist=None, hot_embed=None):
            if hot_embed is not None and self.cfg.hot_embed_rows:
                from repro_torch.core.hot_embedding import embed_with_cache

                return embed_with_cache(params["embed"], tokens, hot_embed, dist)[0]
            return D.embed_lookup(params["embed"], tokens, dist)

    return PortF32(ModelConfig(**cfg_dict), "cpu")


def _trainer_and_engine(case, dist, ckpt_dir):
    """``Trainer.run`` and ``ServeEngine`` on the mesh and on one device."""
    import torch.distributed as tdist

    from repro_torch import dist as D
    from repro_torch import tree as tree_lib
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.launch import sharding as sh
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    model = _f32_model(case["cfg"])
    cfg = model.cfg
    out = {}
    kw = dict(opt=OptConfig(lr=1e-3, warmup_steps=0, total_steps=10), grad_compression="int8")
    runs = {}
    for name, d, extra in (("mesh", dist, dict(checkpoint_dir=ckpt_dir, checkpoint_every=2)),
                           ("local", None, {})):
        tr = Trainer(model, TrainConfig(**kw, **extra), d, num_nodes=2)
        st = tr.init_state(torch.Generator().manual_seed(0))
        st = st._replace(params=tree_lib.tree_map(lambda t: t.detach().float().requires_grad_(True),
                                                  st.params))
        st = st._replace(opt=st.opt._replace(m=tree_lib.tree_map(torch.zeros_like, st.opt.m),
                                             v=tree_lib.tree_map(torch.zeros_like, st.opt.v)))
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4), "cpu")
        st, hist = tr.run(st, pipe, 2, log=False)
        runs[name] = (tr, st, hist)
    tdist.barrier()  # rank 0's checkpoint is written
    tr, st, hist = runs["mesh"]
    _, lst, lhist = runs["local"]
    out["losses"] = ([h["loss"] for h in hist], [h["loss"] for h in lhist])
    entries = tr.entries
    errs = []
    for i, (a, b) in enumerate(zip(tree_lib.leaves(st.params), tree_lib.leaves(lst.params))):
        whole = D.gather_tree(a.detach(), entries[i], dist).double()
        errs.append(float((whole - b.detach().double()).norm() / max(float(b.detach().double().norm()), 1e-30)))
    out["param_rel_l2"] = max(errs)
    out["hot_embed_equal"] = all(torch.equal(x, y) for x, y in zip(tree_lib.leaves(st.hot_embed),
                                                                  tree_lib.leaves(lst.hot_embed)))
    restored = tr.restore(torch.Generator().manual_seed(5))
    # A restore makes fresh (bf16) params and copies the saved f32 ones into them.
    out["restored_equal"] = all(torch.equal(x, y.detach().to(x.dtype)) for x, y in zip(
        tree_lib.leaves({"p": restored.params, "o": restored.opt}), tree_lib.leaves({"p": st.params, "o": st.opt})))
    out["restored_step"] = restored.data_step == st.data_step

    # The serving engine (bf16: the decode step embeds in bf16): lanes over
    # data, kv heads over model.
    from repro_torch.models.model import Model

    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    reqs = [Request(f"s{i}", rng.integers(0, cfg.vocab_size, n).astype(np.int32), 4)
            for i, n in enumerate((12, 20))]
    outs = []
    with torch.no_grad():
        for d, p in ((dist, sh.place_tree(params, sh.param_shardings(model, dist.mesh), dist)), (None, params)):
            eng = ServeEngine(model, p, num_lanes=4, cache_len=48, dist=d)
            for r in reqs:
                eng.admit(r)
            outs.append(eng.run_to_completion())
    out["engine"] = outs
    return out


def _rank_main(units, models, ckpt_dir=None):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import make_dist

    torch.set_num_threads(2)  # four ranks beside the other test workers
    out = {}
    for mname, (shape, axes) in MESHES.items():
        dist = make_dist(make_mesh(shape, axes, device_type="cpu"))
        out[("units", mname)] = _units(units, dist)
        for name, (_, _, meshes) in MODELS.items():
            if mname in meshes:
                case = models[name]
                out[(name, mname, "bf16")] = _model_case(case, dist, False, name in DECODE)
                if mname == "2x2":
                    out[(name, mname, "f32")] = _model_case(case, dist, True, False)
        if mname == "2x2" and ckpt_dir is not None:
            out["trainer_engine"] = _trainer_and_engine(models["qwen3"], dist, ckpt_dir)
    return out


# ---------------------------------------------------------------------------
# The tests' side.


def _jax_decode(name, case):
    """JAX's local prefill and greedy decode: every step's logits and the
    tokens fed to each step."""
    jm = JaxModel(_jax_cfg(name))
    params = jax.tree.map(jnp.asarray, case["params"])
    logits, state = jm.prefill(params, {"tokens": jnp.asarray(case["batch"]["tokens"][:2])}, None,
                               cache_len=CACHE)
    steps, feed = [np.asarray(logits, np.float32)], []
    step = jax.jit(lambda p, s, t: jm.decode_step(p, s, t, None))
    for _ in range(NEW):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32)
        feed.append(tok)
        logits, state = step(params, state, jnp.asarray(tok))
        steps.append(np.asarray(logits, np.float32))
    return np.stack(steps), feed


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch import spmd

    torch.exp(torch.zeros(1))
    units, models = _inputs()
    want_decode = {}
    for name in DECODE:
        want_decode[name], models[name]["feed"] = _jax_decode(name, models[name])
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    res = spmd.run_ranks(_rank_main, 4, units, models, ckpt, timeout=900)
    return units, models, want_decode, res


def test_all_ranks_agree(ranks):
    res = ranks[3]
    for key, val in res[0].items():
        if key == "trainer_engine":
            continue
        for other in res[1:]:
            for k in ("loss", "xent"):
                if k in val:
                    assert other[key][k] == val[k], (key, k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_embed_lookup_is_exact(ranks, mesh):
    units, _, _, res = ranks
    want = np.asarray(jax_embed_lookup(jnp.asarray(units["table"]), jnp.asarray(units["tokens"]), None))
    np.testing.assert_array_equal(res[0][("units", mesh)]["embed"], want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_softmax_xent_matches(ranks, mesh):
    units, _, _, res = ranks
    want = jax_softmax_xent(jnp.asarray(units["x"]), jnp.asarray(units["table"]),
                            jnp.asarray(units["targets"]), None, mask=jnp.asarray(units["mask"]),
                            num_chunks=4, vocab_size=units["vocab"])
    np.testing.assert_allclose(res[0][("units", mesh)]["xent"], float(want), rtol=1e-5)


LOSS_CASES = [(n, m) for n, (_, _, ms) in MODELS.items() for m in ms]


@pytest.mark.parametrize("name,mesh", LOSS_CASES)
def test_sharded_loss_matches_jax_and_the_local_loss(ranks, name, mesh):
    _, models, _, res = ranks
    case = models[name]
    jm = JaxModel(_jax_cfg(name))
    want, _ = jax.jit(lambda p, b: jm.loss(p, b, None))(
        jax.tree.map(jnp.asarray, case["params"]), jax.tree.map(jnp.asarray, case["batch"]))
    got = res[0][(name, mesh, "bf16")]
    np.testing.assert_allclose(got["loss"], float(want), rtol=2e-2)
    np.testing.assert_allclose(got["loss"], got["local_loss"], rtol=1e-3)


@pytest.mark.parametrize("name", list(MODELS))
def test_f32_sharded_loss_and_grads_equal_the_local_ones(ranks, name):
    got = ranks[3][0][(name, "2x2", "f32")]
    np.testing.assert_allclose(got["loss"], got["local_loss"], rtol=1e-5)
    assert got["grad_rel_l2"] < 1e-5


@pytest.mark.parametrize("name", DECODE)
def test_sharded_decode_logits_match_jax(ranks, name):
    _, _, want, res = ranks
    got = res[0][(name, "2x2", "bf16")]["decode"]
    assert got.shape == want[name].shape
    cfg = _jax_cfg(name)
    np.testing.assert_allclose(got[..., :cfg.vocab_size], want[name][..., :cfg.vocab_size],
                               atol=0.15, rtol=0.05)


def test_trainer_run_on_the_mesh_matches_one_device(ranks):
    got = ranks[3][0]["trainer_engine"]
    mesh, local = got["losses"]
    np.testing.assert_allclose(mesh, local, rtol=1e-5)
    print(f"params after 2 int8 steps, mesh against one device: relative L2 {got['param_rel_l2']:.3g}")
    assert got["param_rel_l2"] < 1e-4, got["param_rel_l2"]
    assert got["hot_embed_equal"]
    for rank in ranks[3]:
        assert rank["trainer_engine"]["losses"] == got["losses"]


def test_checkpoint_on_the_mesh_restores_the_state(ranks):
    for rank in ranks[3]:
        assert rank["trainer_engine"]["restored_equal"] and rank["trainer_engine"]["restored_step"]


def test_serve_engine_on_the_mesh_gives_the_one_device_tokens(ranks):
    for rank in ranks[3]:
        mesh, local = rank["trainer_engine"]["engine"]
        assert mesh == local and all(len(v) == 1 + 4 for v in local.values()), (mesh, local)
