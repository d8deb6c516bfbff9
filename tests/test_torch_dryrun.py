"""The port's dry run against the reference's, on the CPU.

* ``analytic_memory_per_chip`` and ``model_flops_per_chip`` equal the
  reference's (rtol 1e-12: the same float expressions in the same order)
  for every arch, every cell of ``cells()`` and both production meshes.
* ``run_cell`` traces a reduced cell (2 layers, ``DRYRUN_OVERRIDES``) on
  rank 0 of a fake 16x16 mesh in this process and returns the reference's
  JSON keys, its roofline terms priced at the H100's figures.
* ``FlopCounterMode`` on a rank's block of a split matmul counts the
  card's FLOPs exactly (the port's tensors are local: no division).
* A reduced train cell's counted FLOPs fall within [1.0, 4.0] times
  ``6 N_active tokens / chips`` (the forward pass again under remat, the
  attention products, the vocab-split loss and the kv projections every
  model rank makes are on top of 6N).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

_XLA = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jdry  # noqa: E402  (sets XLA_FLAGS for its own process)

if _XLA is None:  # leave the variable as it was for what this process spawns
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA

import jax  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES, cells  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, production_shape  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


class _JaxMesh(jax.sharding.AbstractMesh):
    """An abstract mesh with the ``devices`` array the reference's memory
    model reads the chip count from."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes)


def _meshes(multi_pod):
    sizes, axes = production_shape(multi_pod)
    return _JaxMesh(sizes, axes), AbstractMesh(sizes, axes)


CELLS = [(a, s, mp) for a in ARCH_IDS for s in cells(a) for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_memory_model_and_model_flops_equal_the_reference(arch, shape, multi_pod):
    jm, tm = JaxModel(jax_get_config(arch)), Model(get_config(arch), "cpu")
    jmesh, tmesh = _meshes(multi_pod)
    kind = SHAPES[shape].kind
    micro = jdry.TRAIN_MICROBATCHES.get(arch, 1) if kind == "train" else 1
    assert dryrun.TRAIN_MICROBATCHES == jdry.TRAIN_MICROBATCHES
    want = jdry.analytic_memory_per_chip(jm, SHAPES[shape], jmesh, kind, micro)
    got = dryrun.analytic_memory_per_chip(tm, get_shape(shape), tmesh, kind, micro)
    assert set(got) == set(want)
    for key, val in want.items():
        if isinstance(val, bool):
            assert got[key] == val, key
        else:
            np.testing.assert_allclose(got[key], val, rtol=1e-12, err_msg=key)
    np.testing.assert_allclose(dryrun.model_flops_per_chip(tm, get_shape(shape), tmesh, kind),
                               jdry.model_flops_per_chip(jm, SHAPES[shape], jmesh, kind), rtol=1e-12)


# The reference's run_cell keys (src/repro/launch/dryrun.py) and the roofline
# terms both packages report.
RESULT_KEYS = {"arch", "shape", "mesh", "kind", "chips", "params", "active_params", "ok", "lower_s",
               "compile_s", "memory", "analytic_memory", "xla_cost_analysis", "roofline", "hlo_stats"}
MEMORY_KEYS = {"args_bytes", "temp_bytes", "output_bytes", "alias_bytes", "peak_bytes_per_device",
               "fits_16GB"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "step_time_bound_s", "model_flops",
                 "useful_flops_frac", "roofline_frac"}


@pytest.fixture(scope="module")
def train_cell():
    os.environ["DRYRUN_OVERRIDES"] = json.dumps({"num_layers": 2})
    try:
        return dryrun.run_cell("qwen3-1.7b", "train_4k", multi_pod=False)
    finally:
        del os.environ["DRYRUN_OVERRIDES"]


def test_run_cell_returns_the_reference_keys(train_cell):
    res = train_cell
    assert RESULT_KEYS <= set(res) and res["ok"] and res["chips"] == 256 and res["mesh"] == "16x16"
    assert MEMORY_KEYS <= set(res["memory"]), res["memory"]
    assert ROOFLINE_KEYS <= set(res["roofline"])
    assert res["roofline"]["hw"].startswith("NVIDIA H100")
    assert res["hlo_stats"]["collective_ops"] > 0 and res["hlo_stats"]["dot_ops"] > 0
    assert res["memory"]["peak_bytes_per_device"] > res["memory"]["args_bytes"] > 0


def test_reduced_train_cell_flops_lie_in_the_6n_band(train_cell):
    rf = train_cell["roofline"]
    ratio = rf["counted_flops"] / rf["model_flops"]
    print(f"counted / 6N FLOPs: {ratio:.4f}")
    assert 1.0 <= ratio <= 4.0


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_run_cell_serving_cells_on_the_fake_mesh(shape):
    os.environ["DRYRUN_OVERRIDES"] = json.dumps({"num_layers": 2})
    try:
        res = dryrun.run_cell("granite-moe-1b-a400m", shape, multi_pod=False)
    finally:
        del os.environ["DRYRUN_OVERRIDES"]
    assert RESULT_KEYS <= set(res) and res["ok"] and res["kind"] == SHAPES[shape].kind
    assert res["roofline"]["step_time_bound_s"] > 0


def test_flop_counter_on_a_split_matmul_is_exact_per_card():
    import torch.distributed as tdist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import make_dist
    from repro_torch.models.moe import swiglu_tp

    made = dryrun._fake_group(256)
    try:
        dist = make_dist(make_mesh((16, 16), ("data", "model"), device_type="cpu"))
        t, d, f = 4096, 2048, 6144
        with FakeTensorMode(allow_non_fake_inputs=True):  # the mesh's rank tensor is real
            x = torch.empty((2, t // 2, d), dtype=torch.bfloat16)
            p = {k: torch.empty(s, dtype=torch.bfloat16)
                 for k, s in (("w_gate", (d, f // 16)), ("w_up", (d, f // 16)), ("w_down", (f // 16, d)))}
            with FlopCounterMode(display=False) as fc:
                swiglu_tp(p, x, dist, f)
        assert fc.get_total_flops() == 3 * 2 * t * d * f // 16
    finally:
        if made:
            tdist.destroy_process_group()
