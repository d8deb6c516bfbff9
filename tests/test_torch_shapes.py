"""The shape cells of the port (``ShapeConfig``, ``SHAPES``, ``get_shape``,
``cells``) and ``Model.input_specs`` / ``Model.make_batch`` against the JAX
reference's, on the CPU.

Bars, each with its reason:

* the cells, every architecture's list of cells and every ``input_specs``
  entry (names in order, shapes, dtypes) — equal to the reference's for
  every architecture of ``ARCH_IDS`` at full size and every cell;
* ``make_batch`` — from the same seed's key, the int32 fields (tokens,
  targets) equal the reference's bit for bit (the same threefry stream and
  ``randint`` reduction, ``kvsim/prng.py``); a bf16 field (vlm patches,
  audio frames) is ``normal`` in f32 cast to bf16, and the port's f32
  ``normal`` is within a few ulps of the reference's (its ``erf_inv``'s
  ``log1p`` is correctly rounded, XLA's is up to two ulps off), so after the
  cast a value may sit one bf16 ulp from the reference's where the two f32
  values straddle a rounding boundary: every value equal or one bf16 ulp
  apart, at most 1 in 1,000 apart (measured: 1 of 8,192 patch values and 1
  of 16,384 frame values at seed 1, none at seeds 0 and 7).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, cells, get_config, get_shape  # noqa: E402
from repro_torch.kvsim import prng  # noqa: E402
from repro_torch.models import build  # noqa: E402


def test_shape_cells_equal_the_references():
    assert list(SHAPES) == list(jconfigs.SHAPES)
    for name, shape in SHAPES.items():
        assert isinstance(shape, ShapeConfig) and get_shape(name) is shape
        assert dataclasses.asdict(shape) == dataclasses.asdict(jconfigs.SHAPES[name])
    assert [f.name for f in dataclasses.fields(ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ShapeConfig)]
    with pytest.raises(KeyError):
        get_shape("train_8k")
    assert SHAPES["train_4k"] == ShapeConfig("train_4k", 4_096, 256, "train")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_of_each_arch_equal_the_references(arch):
    assert cells(arch) == jconfigs.cells(arch)
    assert ("long_500k" in cells(arch)) == (get_config(arch).family in ("ssm", "hybrid"))


CELLS = [(arch, cell) for arch in ARCH_IDS for cell in SHAPES]


@pytest.mark.parametrize("arch,cell", CELLS, ids=[f"{a}-{c}" for a, c in CELLS])
def test_input_specs_equal_the_references(arch, cell):
    want = jax_build(jconfigs.get_config(arch)).input_specs(jconfigs.SHAPES[cell])
    got = build(get_config(arch), "cpu").input_specs(SHAPES[cell])
    assert list(got) == list(want)
    for name, spec in got.items():
        assert spec.device.type == "meta", name
        assert tuple(spec.shape) == want[name].shape, name
        assert str(spec.dtype).split(".")[-1] == str(want[name].dtype), name


def test_configs_package_exports_the_references_names():
    names = ("ModelConfig", "ShapeConfig", "SHAPES", "reduced", "ARCH_IDS", "get_config", "get_shape",
             "cells")
    assert sorted(configs.__all__) == sorted(names)
    for name in names:
        assert hasattr(jconfigs, name) and hasattr(configs, name), name


BATCH_CASES = [(arch, kind, seed) for arch in ("llava-next-34b", "whisper-base", "rwkv6-1.6b")
               for kind in ("train", "prefill", "decode") for seed in (0, 1, 7)]


@pytest.mark.parametrize("arch,kind,seed", BATCH_CASES, ids=[f"{a}-{k}-{s}" for a, k, s in BATCH_CASES])
def test_make_batch_equals_the_references(arch, kind, seed):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    want = jax_build(jcfg).make_batch(jconfigs.ShapeConfig("cell", 64, 4, kind), jax.random.PRNGKey(seed))
    got = build(ModelConfig(**dataclasses.asdict(jcfg)), "cpu").make_batch(ShapeConfig("cell", 64, 4, kind),
                                                                            prng.prng_key(seed))
    assert list(got) == list(want)
    for name, val in got.items():
        ref = np.asarray(want[name])
        assert tuple(val.shape) == ref.shape and str(val.dtype).split(".")[-1] == str(ref.dtype), name
        if val.dtype == torch.int32:
            np.testing.assert_array_equal(val.numpy(), ref, err_msg=name)
            assert 0 <= int(val.min()) and int(val.max()) < jcfg.vocab_size
        else:
            bits = val.view(torch.int16).numpy().astype(np.int32)
            ref_bits = ref.view(np.int16).astype(np.int32)
            apart = np.abs(bits - ref_bits)
            assert apart.max() <= 1 and int((apart > 0).sum()) * 1000 <= apart.size, name
            assert np.array_equal(np.sign(val.float().numpy()), np.sign(ref.astype(np.float32))), name


def test_make_batch_draws_on_the_models_device_and_in_specs_order():
    model = build(configs.reduced(get_config("llava-next-34b")), "cpu")
    shape = ShapeConfig("cell", 40, 2, "train")
    batch = model.make_batch(shape, prng.prng_key(3))
    specs = model.input_specs(shape)
    assert list(batch) == ["tokens", "patches", "targets"] == list(specs)
    assert all(v.device.type == "cpu" for v in batch.values())
    # one split a field: the targets are not the tokens
    assert not torch.equal(batch["tokens"], batch["targets"])
    assert batch["tokens"].shape == (2, max(40 - model.cfg.num_patches, 1))
    assert model.input_specs(SHAPES["decode_32k"])["tokens"].shape == (128,)
