"""Layer ``kernels/ownership_sweep``: the kernel's share of its roofline,
the least time the bytes of one sweep take at the card's memory rate over
the profiler's mean time of the kernels named ``ownership_sweep_kernel``,
in %.

The bytes of a sweep of ``K`` keys on ``N`` nodes with int32 counts, each
read or written once: counts ``4N``, hosts ``N``, live ``1`` and last
access ``4`` read a key; owners, adds and drops ``3N``, expired ``1`` and
the shares ``4N`` written (``chip_smoke.py``'s count)."""

from kvbench.peaks import HBM_BYTES_PER_S


def sweep_bytes(k: int, n: int) -> int:
    return k * (4 * n + n + 1 + 4) + k * (3 * n + 1 + 4 * n)


def read(win):
    ops = win.kernels("ownership_sweep_kernel")
    if not ops:
        return None
    cfg = win.context["config"]
    mean_s = sum(e - s for _, s, e, _ in ops) / len(ops) / 1e9
    return 100.0 * sweep_bytes(cfg["num_keys"], cfg["num_nodes"]) / HBM_BYTES_PER_S / mean_s
