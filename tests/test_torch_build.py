"""The port's kernel build flags, the wrappers' launch rules and their C
signatures, on the CPU.

All are plain Python (``kernels/_build.py``, the ``ops.py`` wrappers) or
source text, and decide what runs on the card: which nvcc flags build each
kernel (and so whether its f32 arithmetic rounds as its plain version
does), which of the three attention kernels a shape goes to, how the
wrappers size their grids and share rows out among blocks, when they move
data as vectors, and whether the ``ctypes`` argument lists match the C
launch functions they call.
"""

import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chunk_replay import ops as cr_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.latency_histogram import ops as lh_ops  # noqa: E402
from repro_torch.kernels.moe_router import ops as mr_ops  # noqa: E402
from repro_torch.kernels.trace_window import ops as tw_ops  # noqa: E402

BIT_EXACT = ("chunk_replay", "ownership_sweep", "latency_histogram", "moe_router", "hot_gather",
             "flash_decode", "trace_window")


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
    (torch.bfloat16, 32, "mma_sync"), (torch.bfloat16, 256, "tma_wgmma"),
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


# (b, kh, t): recurrentgemma-2b's rings, qwen3-1.7b's serving cache and its
# 32,768-slot shape, whisper-base's cross and self caches, and short, long,
# ragged and one-sequence caches.
DECODE_GRIDS = [(8, 1, 2048), (16, 8, 8192), (128, 8, 32768), (8, 8, 1500), (8, 8, 448), (2, 1, 512),
                (1, 1, 100), (1, 1, 63), (1, 1, 10_000), (4, 1, 2048), (3, 1, 700), (1, 8, 4096),
                (2, 2, 130), (16, 1, 64), (2, 8, 3000)]


@pytest.mark.parametrize("b,kh,t", DECODE_GRIDS)
def test_flash_decode_splits_cover_the_cache_and_fill_the_card(b, kh, t):
    """Splits of whole tiles, at most MAX_SPLIT positions, that cover T
    exactly (the last may be short); B x KH x splits reaches the 132 SMs
    wherever T has the tiles for it, with the longest split that does."""
    length, n = fd_ops.split_length(b, kh, t), fd_ops.num_splits(b, kh, t)
    assert length % fd_ops.TILE == 0 and fd_ops.TILE <= length <= fd_ops.MAX_SPLIT
    assert (n - 1) * length < t <= n * length
    tiles = -(-t // fd_ops.TILE)
    if b * kh * tiles >= fd_ops.NUM_SMS:
        assert b * kh * n >= fd_ops.NUM_SMS
        if length < fd_ops.MAX_SPLIT:
            assert b * kh * -(-t // (length + fd_ops.TILE)) < fd_ops.NUM_SMS
    else:
        assert length == fd_ops.TILE  # as many splits as there are tiles
    if b * kh * -(-t // fd_ops.MAX_SPLIT) >= fd_ops.NUM_SMS:
        assert length == fd_ops.MAX_SPLIT


def test_flash_decode_splits_at_the_serving_shapes():
    """recurrentgemma-2b's rings (8 lanes, 1 kv head, 2,048 slots): 32
    splits of one tile, 256 blocks; qwen3-1.7b's serving cache (16 lanes, 8
    kv heads, 8,192 slots): 32 splits of 256, 4,096 blocks."""
    assert (fd_ops.split_length(8, 1, 2048), fd_ops.num_splits(8, 1, 2048)) == (64, 32)
    assert (fd_ops.split_length(16, 8, 8192), fd_ops.num_splits(16, 8, 8192)) == (256, 32)


@pytest.mark.parametrize("group,want", [(1, 1), (2, 1), (10, 1), (16, 1), (17, 2), (40, 3), (96, 6)])
def test_flash_decode_block_holds_every_head_of_its_kv_head_up_to_sixteen(group, want):
    assert fd_ops.head_groups(group) == want


def test_flash_decode_wrapper_constants_match_the_kernel():
    source = _build.KERNEL_SOURCES["flash_decode"].read_text()
    assert re.search(rf"constexpr int kTile = {fd_ops.TILE};", source)
    assert re.search(rf"constexpr int kHeads = {fd_ops.MAX_HEADS};", source)


def test_flash_decode_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = fd_ops.flash_decode.launches
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 9, 2, 64), dtype=torch.bfloat16)
    out = fd_ops.flash_decode(q, k, k, torch.tensor([3, 0], dtype=torch.int32))
    assert out.shape == q.shape and out.dtype == q.dtype
    assert fd_ops.flash_decode.launches == before


@pytest.mark.parametrize("s,t,window,want", [
    (256, 64, 16, True), (256, 64, 0, False), (192, 128, 24, True), (151, 128, 24, False),
    (152, 128, 24, True), (4096, 4096, 0, False), (2048, 2048, 256, False), (300, 300, 100, False),
])
def test_attention_passes_the_mean_of_v_only_where_a_row_sees_no_key(s, t, window, want):
    """Row i sees no key exactly when window > 0 and i >= t + window - 1;
    the serving shapes (t == s) never have such a row."""
    assert fa_ops.has_empty_rows(s, t, window) == want
    for causal in (True, False):
        sees = [any((j <= i or not causal) and (window == 0 or i - j < window) for j in range(t))
                for i in range(s)]
        assert (not all(sees)) == want


@pytest.mark.parametrize("b,n,k,want", [
    (1, 5, 1_000_000, ("cluster", 512, 1)), (2_048, 5, 1_000_000, ("cluster", 512, 1)),
    (2_049, 5, 1_000_000, ("cluster", 512, 2)), (10_000, 5, 1_000_000, ("cluster", 512, 8)),
    (10_007, 3, 100_003, ("cluster", 512, 8)), (16_384, 8, 10, ("cluster", 512, 8)),
    (16_385, 5, 1_000_000, ("grid", 128, 33)), (10_000, 9, 10, ("grid", 128, 20)),
    (10_000, 64, 1_000, ("grid", 128, 20)), (100_003, 5, 100_003, ("grid", 128, 196)),
    (400_012, 5, 100_003, ("packed", 128, 782)), (540_672, 64, 1_000, ("grid", 128, 1_056)),
    (100_000_000, 5, 1_000_000, ("packed", 128, 1_056)), (100_000, 3, 1_000, ("packed", 128, 196)),
])
def test_chunk_replay_launch_is_a_cluster_for_a_chunk_else_a_grid(b, n, k, want):
    """A chunk of up to 16,384 requests on up to 8 nodes: one step a thread,
    one cluster of a power-of-two count (at most 8) of 512-thread blocks
    (the simulator's 10,000-request chunk: 8 blocks). Otherwise 128-thread
    blocks, at most 8 an SM of the H100, looping beyond; with at least
    PACK_RATIO requests a key (the whole trace: 100 per key) and up to 8
    nodes, the map is packed first."""
    mode, threads, blocks = cr_ops.launch_shape(b, n, k)
    assert (mode, threads, blocks) == want and mode in cr_ops.MODES
    steps = -(-b // (cr_ops.PER_THREAD * threads * blocks))
    if mode == "cluster":
        assert steps == 1 and blocks <= cr_ops.CLUSTER_MAX and blocks & (blocks - 1) == 0
        assert blocks == 1 or (blocks // 2) * threads * cr_ops.PER_THREAD < b
    else:
        assert blocks <= cr_ops.MAX_GRID == cr_ops.NUM_SMS * 8
        assert steps == 1 or blocks == cr_ops.MAX_GRID
        assert (mode == "packed") == (n <= 8 and b >= cr_ops.PACK_RATIO * k)


@pytest.mark.parametrize("ptr16,ptr4,want", [
    ([0, 512], [1024, 2048], True), ([0, 512, 4096], [1024, 2048, 8], True),
    ([4, 512], [1024, 2048], False), ([0, 520], [1024, 2048], False),
    ([0, 512], [1025, 2048], False), ([0, 512], [1024, 2048, 6], False),
])
def test_chunk_replay_moves_vectors_only_at_aligned_addresses(ptr16, ptr4, want):
    assert cr_ops.vector_io(ptr16, ptr4) == want


@pytest.mark.parametrize("e,lanes,rows", [
    (8, 4, 64), (32, 4, 64), (64, 4, 64), (65, 8, 32), (128, 8, 32), (256, 8, 32),
])
def test_moe_router_tile_is_a_row_per_subgroup(e, lanes, rows):
    """4 lanes a row up to 64 experts (16 logits a lane), 8 up to 256 (32);
    a 256-thread block then holds 64 or 32 rows: 32,768 rows are 512 blocks."""
    assert mr_ops.lanes_per_row(e) == lanes
    assert mr_ops.THREADS // lanes == rows
    assert -(-e // (4 * lanes)) * 4 <= 32  # logits a lane: registers, not memory
    assert -(-32_768 // (mr_ops.THREADS // mr_ops.lanes_per_row(64))) == 512


@pytest.mark.parametrize("ptr,e,want", [(0, 64, True), (256, 32, True), (4, 64, False),
                                        (0, 63, False), (16, 6, False)])
def test_moe_router_loads_float4_only_on_aligned_rows(ptr, e, want):
    assert mr_ops.vector_io(ptr, e) == want


@pytest.mark.parametrize("chunks", [1, 2, 7, 100, 131, 132, 659, 660, 661, 1_056, 2_113, 10_000])
@pytest.mark.parametrize("rows_per_chunk", [1, 3, 4, 997, 4_096, 10_000, 65_537, 10**6, 10**8])
@pytest.mark.parametrize("short", [0, 1])
@pytest.mark.parametrize("resident", [132, 660, 1_056])
def test_latency_histogram_launch_gives_every_row_to_one_block(chunks, rows_per_chunk, short,
                                                               resident):
    """The kernel's work items are (chunk, tile) pairs, tile t of a chunk
    taking its rows [t * span, (t + 1) * span) clipped to the chunk, and the
    grid-stride loop gives item i to block i % blocks: so every row lies in
    one item, and every item goes to one block, when tiles * span covers a
    chunk and blocks <= items. Never more blocks than fit on the card at
    once; at least that many chunks is a block a chunk (stores, no fill);
    fewer are split into tiles of at least MIN_TILE_ROWS rows (a multiple
    of 4), at most about one a resident block. The last chunk may be short."""
    r = max(1, chunks * rows_per_chunk - short * (rows_per_chunk - 1) // 2)
    for rpc in (rows_per_chunk, None):
        mode, blocks, tiles, span = lh_ops.launch_shape(r, rpc, resident)
        n_chunks = -(-r // (rpc or r))
        rows = min(rpc or r, r)
        assert mode in lh_ops.MODES and (mode == "chunk") == (tiles == 1)
        assert 1 <= blocks <= min(n_chunks * tiles, resident) and span % 4 == 0
        assert tiles * span >= rows and (tiles == 1 or (tiles - 1) * span < rows)
        assert n_chunks < resident or tiles == 1
        assert tiles == 1 or (span >= lh_ops.MIN_TILE_ROWS and n_chunks * (tiles - 1) < resident)
        if n_chunks < resident and rows >= 2 * lh_ops.MIN_TILE_ROWS:
            assert mode == "split"


def test_latency_histogram_splits_the_static_path_by_chunk_and_the_flat_form_by_tile():
    """At [10, 128] an H100 holds 5 blocks an SM (the kernel's 48 registers
    a thread bound it), 660 in all."""
    assert lh_ops.launch_shape(100_000_000, 10_000, 660) == ("chunk", 660, 1, 10_000)
    assert lh_ops.launch_shape(100_000_000, 997, 660) == ("chunk", 660, 1, 1_000)
    assert lh_ops.launch_shape(660 * 10**6, 10**6, 660) == ("chunk", 660, 1, 10**6)
    assert lh_ops.launch_shape(600 * 10**6, 10**6, 660)[:3] == ("split", 660, 2)
    mode, blocks, tiles, span = lh_ops.launch_shape(100_000_000, None, 660)
    assert (mode, blocks, tiles) == ("split", 660, 660) and span * tiles >= 100_000_000


@pytest.mark.parametrize("b,depth", [(3, 2), (4, 2), (5, 3), (32, 5), (128, 7), (129, 8),
                                     (256, 8), (257, 9), (58_112, 16)])
def test_latency_histogram_threshold_tree_holds_every_threshold(b, depth):
    """The table is 2**depth floats: NaN's bin, then the B - 1 thresholds
    in a complete tree of 2**depth - 1 nodes, the least depth that holds
    them."""
    assert lh_ops.table_depth(b) == depth
    assert 2**depth - 1 >= b - 1 > 2 ** (depth - 1) - 1


@pytest.mark.parametrize("ptrs,want", [([0, 512, 4096], True), ([4, 512, 4096], False),
                                       ([0, 520, 4096], False), ([0, 512, 4100], False)])
def test_latency_histogram_reads_vectors_only_from_aligned_inputs(ptrs, want):
    assert lh_ops.vector_io(ptrs) == want


_CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
          "float": ctypes.c_float}


def _c_params(source: str, fn: str) -> list:
    """The ctypes types of a C launch function's parameters, read from its
    definition in ``source``."""
    m = re.search(rf"\bint {fn}\(([^)]*)\)", source)
    assert m, fn
    names = []
    for param in m.group(1).split(","):
        words = param.replace("const ", "").split()
        ctype = " ".join(words[:-1]) + ("*" if words[-1].startswith("*") else "")
        names.append(_CTYPE[ctype.replace(" *", "*")])
    return names


@pytest.mark.parametrize("kernel,fn,argtypes", [
    ("chunk_replay", "chunk_replay_launch", cr_ops._ARGTYPES),
    ("moe_router", "moe_router_launch", mr_ops._ARGTYPES),
    ("flash_attention", "flash_attention_launch", fa_ops._ARGTYPES),
    ("flash_attention", "flash_attention_tma_launch", fa_ops._ARGTYPES),
    ("flash_decode", "flash_decode_launch", fd_ops._ARGTYPES),
    ("latency_histogram", "latency_histogram_launch", lh_ops._ARGTYPES),
    ("latency_histogram", "latency_histogram_resident", lh_ops._RESIDENT_ARGTYPES),
    ("latency_histogram", "latency_histogram_thresholds_launch", lh_ops._THRESHOLD_ARGTYPES),
    ("latency_histogram", "latency_histogram_check_launch", lh_ops._CHECK_ARGTYPES),
    ("trace_window", "trace_window_launch", tw_ops._ARGTYPES),
])
def test_ctypes_argument_lists_match_the_c_launch_functions(kernel, fn, argtypes):
    """A pointer passed where the C side reads an int (or the reverse)
    shifts every later argument: the lists must agree type by type."""
    source = _build.KERNEL_SOURCES[kernel].read_text()
    assert _c_params(source, fn) == list(argtypes)


def test_trace_window_words_match_the_kernel_layout():
    """The wrapper hands the kernel 27 u32 words (18 key words, then the
    three draws' spans, multipliers and minvals), as ``kWords`` reads them."""
    from repro_torch.kvsim.workload import WorkloadConfig, window_params

    source = _build.KERNEL_SOURCES["trace_window"].read_text()
    assert re.search(r"constexpr int kWords = 27;", source)
    assert re.search(rf"constexpr int kThreads = {tw_ops.THREADS};", source)
    params = window_params(WorkloadConfig(num_keys=100, skewed=True, num_nodes=5), 3)
    words = params.words()
    assert len(words) == 27 and all(0 <= w < 2**32 for w in words)
    assert words[18:21] == [d[1] for d in params.draws] and words[24:] == [d[0] for d in params.draws]
