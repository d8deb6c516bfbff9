"""Layer ``capacity projection`` (``core/costmodel.py::project_capacity``
inside the policy step, where the budgets are finite): the device time
launched inside the program's ``capacity_projection`` spans over its
``sweeps`` counter, in ms (``kvbench/spans.py``). Left out where no span
of that name was recorded."""

from kvbench import spans


def read(win):
    att = spans.attribute(win)
    if att is None or "capacity_projection" not in att.device_ns or not att.counters.get("sweeps"):
        return None
    return att.device_ns["capacity_projection"] / att.counters["sweeps"] / 1e6
