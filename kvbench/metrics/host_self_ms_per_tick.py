"""Layer ``host``: the host's own time a tick, the summed length of the
program's ``chunk`` spans less the part its CUDA API calls (``cuda*``, ``cu*``)
cover, over its ``chunks`` counter, in ms (``kvbench/spans.py``). What the
Python of a tick costs, launches and waits aside."""

from kvbench import spans


def read(win):
    att = spans.attribute(win)
    if att is None or not att.counters.get("chunks") or not att.chunk_ns:
        return None
    return (att.chunk_ns - att.chunk_runtime_ns) / att.counters["chunks"] / 1e6
