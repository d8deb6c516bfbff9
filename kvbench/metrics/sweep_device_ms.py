"""Layer ``policy step`` (``core/policy.py::policy_masked_step`` on a due
tick: ``decide``, the masks, ``count_decay``, ``sweep_stats``): the device
time launched inside the program's ``policy_step`` spans, less that inside
``capacity_projection``, over its ``sweeps`` counter, in ms
(``kvbench/spans.py``)."""

from kvbench import spans


def read(win):
    att = spans.attribute(win)
    if att is None or not att.counters.get("sweeps"):
        return None
    ns = att.device_ns.get("policy_step", 0) - att.device_ns.get("capacity_projection", 0)
    return ns / att.counters["sweeps"] / 1e6
