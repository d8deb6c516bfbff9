"""Layer ``kernels/chunk_replay``: the kernel's share of its roofline, the
least time the bytes of the window's replays take at the card's memory
rate over the profiler's time of the kernels named ``chunk_replay_kernel``,
in %.

The bytes of one chunk of ``B`` requests on ``N`` nodes, each read or
written once (``chip_smoke.py``'s count): key, node, read flag and valid
flag, ``10`` a request (``+ 4`` for the wait where the cell has contention);
the replica row of each distinct key the chunk names, ``N`` each; the RTT
matrix ``4 N^2``; busy, latency sum and three counts ``4 (N + 1) + 24``;
the ``[2N, bins]`` int32 histogram where the cell has telemetry."""

import torch

from kvbench.peaks import HBM_BYTES_PER_S


def distinct_per_chunk(keys: torch.Tensor, chunk: int) -> torch.Tensor:
    """``[C]`` int64: how many distinct keys each chunk of ``chunk``
    requests names (the replica rows a replay of it must read)."""
    r = keys.shape[0]
    out = []
    for lo in range(0, r, chunk * 64):
        hi = min(lo + chunk * 64, r)
        full = (hi - lo) // chunk * chunk
        if full:
            s = keys[lo:lo + full].view(-1, chunk).sort(dim=1).values
            out.append((s[:, 1:] != s[:, :-1]).sum(dim=1) + 1)
        if full < hi - lo:
            out.append(keys[lo + full:hi].unique().numel()
                       * torch.ones(1, dtype=torch.int64, device=keys.device))
    return torch.cat(out)


def chunk_bytes(b, distinct, n: int, waits: bool, bins: int):
    return b * (14 if waits else 10) + distinct * n + 4 * n * n + 4 * (n + 1) + 24 + 8 * n * bins


def read(win):
    ops = win.kernels("chunk_replay_kernel")
    if not ops:
        return None
    cfg = win.context["config"]
    n, interval = cfg["num_nodes"], cfg["daemon_interval"]
    tel = cfg["telemetry"]
    bins = 0 if tel is None else tel["num_bins"]
    total, calls = 0, 0
    seen = {}
    for req in win.context["requests"]:
        key = id(req)
        if key not in seen:
            r = req.keys.shape[0]
            distinct = distinct_per_chunk(req.keys, interval).to(torch.float64)
            sizes = torch.full_like(distinct, float(interval))
            sizes[-1] = r - (distinct.numel() - 1) * interval
            seen[key] = (float(chunk_bytes(sizes, distinct, n, cfg["contention"] is not None,
                                           bins).sum()), distinct.numel())
        total += seen[key][0]
        calls += seen[key][1]
    time_s = sum(e - s for _, s, e, _ in ops) / 1e9
    return 100.0 * (total / calls * len(ops)) / HBM_BYTES_PER_S / time_s
