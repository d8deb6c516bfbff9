"""The port's package exports against the reference's: ``repro_torch.core``,
``.kvsim`` and ``.kernels`` export every name of ``repro.core``,
``.kvsim`` and ``.kernels`` (name by name), but for the exceptions below,
each with its reason, and the kernel functions shadow their subpackages as
in the reference while every kernel's ``ops`` and ``ref`` modules stay
reachable by their paths. The training slice's modules (``train/*``,
``data/pipeline``, ``models/*``, ``dist``) export their reference
module's ``__all__`` with their own listed exceptions; ``repro_torch.models``
exports ``Model`` and ``build`` as ``repro.models`` does, and
``repro_torch.train`` and ``.data`` (namespace packages in the reference)
export their modules' names; ``configs/base`` and ``configs/registry``
export their reference module's ``__all__`` (the shape cells
``ShapeConfig``, ``SHAPES``, ``get_shape`` and ``cells`` among them). ``chunk_latency`` equals the reference's on the
CPU (exact: the same f32 expressions), and a legacy ``Scenario`` passed as
a policy raises the reference's message."""

import importlib
import inspect
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.core  # noqa: E402
import repro.kernels  # noqa: E402
import repro.kvsim as jk  # noqa: E402
import repro_torch.core  # noqa: E402
import repro_torch.kernels  # noqa: E402
import repro_torch.kvsim as tk  # noqa: E402

PACKAGES = {"core": (repro.core, repro_torch.core), "kvsim": (jk, tk),
            "kernels": (repro.kernels, repro_torch.kernels)}
# Reference names the port does not export, by design.
NOT_PORTED = {
    "core": {"TPU_V5E": "the hardware model describes the card the port runs on: H100_SXM"},
    "kvsim": {"REPLAY_BACKENDS": "the port has one replay backend, the CUDA chunk_replay kernel "
                                 "(its plain version on the CPU), so there is nothing to select"},
    "kernels": {},
}
# Port names the reference's package does not export, by design.
PORT_ONLY = {
    "core": {
        "H100_SXM": "the port's hardware model, in place of TPU_V5E",
        "SizeAwarePolicy": "defined in both packages' core/policy.py; the reference exports it "
                           "from repro.kvsim only",
        "eligible_from_fractions": "the eligibility rule on fractions already computed, shared "
                                   "by ownership_sweep's plain version and the policies",
        "policy_repr": "the policy label of run_experiment's rows, public for the grid's callers",
    },
    "kvsim": {},
    "kernels": {"trace_window": "a port-only kernel: the reference draws traces in XLA",
                "capacity_projection": "a port-only kernel: the reference projects budgets "
                                       "with sorts in XLA"},
}
KERNELS = ("chunk_replay", "ownership_sweep", "latency_histogram", "moe_router", "hot_gather",
           "flash_attention", "flash_decode", "trace_window", "capacity_projection")


def _torch_warm():
    torch.exp(torch.zeros(1))


_torch_warm()

REF_NAMES = [(pkg, name) for pkg, (ref, _) in PACKAGES.items() for name in ref.__all__]


@pytest.mark.parametrize("pkg,name", REF_NAMES, ids=[f"{p}.{n}" for p, n in REF_NAMES])
def test_reference_name_is_exported(pkg, name):
    ref, port = PACKAGES[pkg]
    if name in NOT_PORTED[pkg]:
        assert name not in port.__all__ and not hasattr(port, name), (pkg, name)
        return
    assert name in port.__all__, (pkg, name)
    mine, theirs = getattr(port, name), getattr(ref, name)
    assert inspect.isclass(mine) == inspect.isclass(theirs), (pkg, name)
    assert callable(mine) == callable(theirs), (pkg, name)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_port_only_names_are_the_listed_ones(pkg):
    ref, port = PACKAGES[pkg]
    assert set(port.__all__) - set(ref.__all__) == set(PORT_ONLY[pkg])
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), (pkg, name)


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_function_shadows_its_subpackage_whose_modules_stay_reachable(name):
    fn = getattr(repro_torch.kernels, name)
    assert inspect.isfunction(fn) and fn.__name__ == name
    ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    ref = importlib.import_module(f"repro_torch.kernels.{name}.ref")
    assert getattr(ops, name) is fn
    assert sys.modules[f"repro_torch.kernels.{name}"].__file__.endswith("__init__.py")
    # The spellings the port's code and scripts use.
    scope: dict = {}
    exec(f"from repro_torch.kernels.{name} import ops, ref", scope)
    assert scope["ops"] is ops and scope["ref"] is ref
    exec(f"from repro_torch.kernels import {name}", scope)
    assert scope[name] is fn


def test_core_exports_the_traffic_and_repartition_modules_names():
    from repro_torch.core import repartition, traffic

    for module in (traffic, repartition):
        for name in module.__all__:
            assert getattr(repro_torch.core, name) is getattr(module, name)


@pytest.mark.parametrize("read_mode", ["map", "no_local", "ideal"])
@pytest.mark.parametrize("topology", ["flat", "wan5"])
def test_chunk_latency_equals_the_reference(read_mode, topology):
    from repro.kernels import chunk_latency as jax_chunk_latency
    from repro_torch.kernels import chunk_latency

    jcl = jk.ClusterConfig() if topology == "flat" else jk.wan5_cluster()
    tcl = tk.ClusterConfig() if topology == "flat" else tk.wan5_cluster()
    n = jcl.num_nodes
    rng = np.random.default_rng(len(read_mode) * 7 + n)
    k, b = 300, 2_000
    hosts = rng.random((k, n)) < 0.4
    hosts[rng.random(k) < 0.1] = False
    keys = rng.integers(0, k, b).astype(np.int32)
    nodes = rng.integers(0, n, b).astype(np.int32)
    is_read = rng.random(b) < 0.7
    kw = dict(service_ms=jcl.service_ms, master=jcl.master,
              xfer_read_ms=jcl.transfer_ms(jcl.value_bytes),
              xfer_write_ms=jcl.transfer_ms(jcl.value_bytes + jcl.key_bytes), read_mode=read_mode)
    want_lat, want_hit = jax_chunk_latency(jnp.asarray(hosts), jnp.asarray(keys), jnp.asarray(nodes),
                                           jnp.asarray(is_read), jcl.rtt_matrix(), **kw)
    lat, hit = chunk_latency(torch.from_numpy(hosts), torch.from_numpy(keys), torch.from_numpy(nodes),
                             torch.from_numpy(is_read), tcl.rtt_matrix("cpu"), **kw)
    np.testing.assert_array_equal(lat.numpy(), np.asarray(want_lat))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))


@pytest.mark.parametrize("member", [m.name for m in jk.Scenario])
@pytest.mark.parametrize("entry", ["run_scenario", "run_scenario_reference", "run_experiment"])
def test_scenario_as_policy_raises_the_reference_message(member, entry):
    assert [m.value for m in tk.Scenario] == [m.value for m in jk.Scenario]

    def call(k, scenario, **kw):
        if entry == "run_experiment":
            return k.run_experiment(iterations=1, num_requests=100, policies=[scenario], **kw)
        return getattr(k, entry)(k.WorkloadConfig(num_requests=100), k.ClusterConfig(), scenario,
                                 **kw)

    with pytest.raises(ValueError, match="legacy scenario") as ours:
        call(tk, tk.Scenario[member], device="cpu")
    with pytest.raises(ValueError, match="legacy scenario") as ref:
        call(jk, jk.Scenario[member])
    assert str(ours.value) == str(ref.value)


# The training slice: module by module. Reference names a port module does
# not export, and port names its reference module does not, each by design.
MODULE_EXCEPTIONS = {
    "train.optim": ({}, {}),
    "train.compress": ({}, {}),
    "train.checkpoint": ({}, {}),
    "train.trainer": ({}, {}),
    "train.fault": ({}, {}),
    "data.pipeline": ({}, {}),
    "configs.base": ({}, {}),  # ModelConfig, ShapeConfig, SHAPES, reduced
    "configs.registry": ({}, {}),  # ARCH_IDS, get_config, get_shape, cells, reduced, SHAPES
    "models.model": ({}, {}),
    "models.moe": ({}, {"MoE": "a thin nn.Module over one layer's params dict, for PyTorch callers"}),
    "models.attention": ({}, {"NEG_INF": "the mask value, shared with the kernels' plain versions"}),
    "models.layers": ({}, {}),
    "models.rwkv6": ({}, {}),
    "models.rglru": ({}, {}),
    "models.encdec": ({}, {}),
    "quant": ({}, {}),
    "models.transformer": (
        {},
        {name: "a layer function the reference keeps public but out of __all__"
         for name in ("attn_decode", "attn_full", "attn_specs", "cross_attn", "cross_attn_kv",
                      "mlp_apply", "mlp_specs", "run_decode_step")}),
    "models.params": ({}, {}),
    "dist": ({}, {}),
    "launch.mesh": ({}, {}),
    "launch.sharding": ({}, {}),
    "launch.roofline": (
        {"HloAnalysis": "the reference parses compiled XLA HLO; the port counts the step on torch "
                        "(StepCount)",
         "analyze_hlo": "the same: count_step runs the step under torch's counters"},
        {"StepCount": "the counts of one step (FLOPs, operator bytes, collectives), in place of "
                      "HloAnalysis",
         "count_step": "runs a step under FlopCounterMode, CommDebugMode and an operator-bytes "
                       "counter, in place of analyze_hlo"}),
}


@pytest.mark.parametrize("module", list(MODULE_EXCEPTIONS))
def test_training_slice_modules_export_the_references_names(module):
    xla = os.environ.get("XLA_FLAGS")
    ref = importlib.import_module(f"repro.{module}")  # repro.launch.dryrun sets XLA_FLAGS
    if xla is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = xla
    port = importlib.import_module(f"repro_torch.{module}")
    not_ported, port_only = MODULE_EXCEPTIONS[module]
    want, got = set(ref.__all__), set(port.__all__)
    assert want - got == set(not_ported), module
    assert got - want == set(port_only), module
    for name in want & got:
        mine, theirs = getattr(port, name), getattr(ref, name)
        assert inspect.isclass(mine) == inspect.isclass(theirs), (module, name)
        assert callable(mine) == callable(theirs), (module, name)
    for name in not_ported:
        assert not hasattr(port, name), (module, name)


def test_serving_slice_names():
    """The state carriers of the families this slice serves, and the
    model modules' public functions that the reference keeps out of its
    ``__all__`` (reachable by their module paths in both packages)."""
    import repro_torch.interop as interop
    from repro.models import encdec as jencdec
    from repro.models import rglru as jrglru
    from repro.models import rwkv6 as jrwkv6
    from repro_torch.models import encdec, rglru, rwkv6

    for name in ("rwkv_state_from_numpy", "rglru_state_from_numpy", "encdec_state_from_numpy"):
        assert name in interop.__all__ and callable(getattr(interop, name))
    for port, ref, names in (
            (rwkv6, jrwkv6, ("time_mix", "channel_mix", "LORA_MIX", "LORA_DECAY", "CHUNK")),
            (rglru, jrglru, ("rec_block", "rec_block_step", "mlp_block", "CONV_WIDTH", "LRU_C")),
            (encdec, jencdec, ("sinusoid_at",))):
        for name in names:
            mine, theirs = getattr(port, name), getattr(ref, name)
            assert callable(mine) == callable(theirs), name
            if not callable(mine):
                assert mine == theirs, name


def test_training_slice_packages():
    import repro.models
    import repro_torch.data
    import repro_torch.data.pipeline
    import repro_torch.models
    import repro_torch.train

    assert repro_torch.models.__all__ == ["Model", "build"]
    assert repro_torch.models.Model is importlib.import_module("repro_torch.models.model").Model
    assert {"Model", "build"} <= set(dir(repro.models))
    assert repro_torch.data.__all__ == repro_torch.data.pipeline.__all__
    for name in repro_torch.data.__all__:
        assert getattr(repro_torch.data, name) is getattr(repro_torch.data.pipeline, name)
    modules = [importlib.import_module(f"repro_torch.train.{m}") for m in ("optim", "trainer", "fault")]
    assert set(repro_torch.train.__all__) == {n for m in modules for n in m.__all__}
    for name in repro_torch.train.__all__:
        assert any(getattr(m, name, None) is getattr(repro_torch.train, name) for m in modules), name


def test_dryrun_has_the_references_entry_points():
    """``repro.launch.dryrun`` keeps no ``__all__``; the port's exports the
    reference's public names, each of the same kind."""
    xla = os.environ.get("XLA_FLAGS")
    ref = importlib.import_module("repro.launch.dryrun")  # sets XLA_FLAGS
    if xla is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = xla
    port = importlib.import_module("repro_torch.launch.dryrun")
    names = ("TRAIN_MICROBATCHES", "analytic_memory_per_chip", "model_flops_per_chip", "build_cell",
             "run_cell", "main")
    assert set(port.__all__) == set(names)
    for name in names:
        assert callable(getattr(port, name)) == callable(getattr(ref, name)), name
