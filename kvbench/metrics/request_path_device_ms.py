"""Layer ``chunk loop`` (``kvsim/simulate.py::_simulate``'s loop: the
pre-passes, ``chunk_replay``, the occupancy resample, ``record_accesses``):
the device time launched inside the program's ``chunk`` spans, less that
inside ``policy_step``, over its ``chunks`` counter, in ms
(``kvbench/spans.py``)."""

from kvbench import spans


def read(win):
    att = spans.attribute(win)
    if att is None or not att.counters.get("chunks") or "chunk" not in att.device_ns:
        return None
    ns = att.device_ns["chunk"] - att.device_ns.get("policy_step", 0)
    return ns / att.counters["chunks"] / 1e6
