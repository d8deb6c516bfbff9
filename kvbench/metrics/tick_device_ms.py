"""Layer ``daemon tick on the device`` (the policy step of
``core/policy.py``, ``core/costmodel.py::project_capacity``, the contention
pre-pass of ``kernels/chunk_replay/ref.py``, ``kvsim/telemetry.py``): the
summed device time of every kernel, copy and memset in the traced window
over the daemon ticks it ran, in ms."""


def read(win):
    if not win.ticks or not win.device_ops:
        return None
    return sum(e - s for _, s, e, _ in win.device_ops) / win.ticks / 1e6
