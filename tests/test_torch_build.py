"""The port's kernel build flags and the attention dispatch rule, on the CPU.

Both are plain Python (``kernels/_build.py``, ``kernels/flash_attention/ops.py``)
and decide what runs on the card: which nvcc flags build each kernel (and so
whether its f32 arithmetic rounds as its plain version does), and which of
the three attention kernels a shape goes to.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402

BIT_EXACT = ("chunk_replay", "ownership_sweep", "latency_histogram", "moe_router", "hot_gather",
             "flash_decode")


@pytest.mark.parametrize("name", BIT_EXACT)
def test_bit_exact_kernels_keep_fmad_false(name):
    flags = _build.flags(name)
    assert "-fmad=false" in flags
    assert "--use_fast_math" not in flags and "-use_fast_math" not in flags


def test_flash_attention_is_built_without_fmad_false():
    flags = _build.flags("flash_attention")
    assert "-fmad=false" not in flags
    assert "--use_fast_math" not in flags
    assert set(_build.KERNEL_SOURCES) == set(BIT_EXACT) | {"flash_attention"}


@pytest.mark.parametrize("name", sorted(_build.KERNEL_SOURCES))
def test_build_hash_covers_each_kernels_own_flags(name, monkeypatch):
    before = {k: _build._target(k) for k in _build.KERNEL_SOURCES}
    monkeypatch.setitem(_build.KERNEL_FLAGS, name, _build.KERNEL_FLAGS[name] + ("-DPROBE",))
    after = {k: _build._target(k) for k in _build.KERNEL_SOURCES}
    assert after[name] != before[name]
    assert all(after[k] == before[k] for k in after if k != name)


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, "tma_wgmma"), (torch.bfloat16, 128, "tma_wgmma"),
    (torch.bfloat16, 32, "mma_sync"), (torch.bfloat16, 256, "mma_sync"),
    (torch.float32, 32, "f32_simt"), (torch.float32, 64, "f32_simt"),
    (torch.float32, 128, "f32_simt"), (torch.float32, 256, "f32_simt"),
])
def test_flash_attention_dispatch_is_a_function_of_dtype_and_head_dim(dtype, head_dim, want):
    assert fa_ops.variant(dtype, head_dim) == want
    assert want in fa_ops.VARIANTS


@pytest.mark.parametrize("s,h,b,want", [
    (512, 16, 1, 64), (1024, 16, 1, 64), (1025, 16, 1, 128), (2048, 16, 1, 128),
    (4096, 16, 1, 128), (1024, 16, 2, 128), (130, 16, 2, 64), (1, 1, 1, 64),
])
def test_tma_q_tile_doubles_the_blocks_only_when_128_row_tiles_underfill_the_card(s, h, b, want):
    """64-row q tiles when ceil(S / 128) * H * B is below the H100's 132 SMs."""
    assert fa_ops.q_rows(s, h, b) == want
    assert (-(-s // 128) * h * b < fa_ops.NUM_SMS) == (want == 64)


def test_launch_counts_start_at_zero_for_every_variant():
    assert set(fa_ops.flash_attention.launches_by_variant) == set(fa_ops.VARIANTS)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (fa_ops.flash_attention.launches, dict(fa_ops.flash_attention.launches_by_variant))
    q = torch.zeros((1, 3, 2, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 3, 1, 64), dtype=torch.bfloat16)
    out = fa_ops.flash_attention(q, k, k)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert (fa_ops.flash_attention.launches, fa_ops.flash_attention.launches_by_variant) == before
