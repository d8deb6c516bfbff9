"""Layer ``chunk loop`` (``kvsim/simulate.py::_simulate`` with
``core/metadata.py::record_accesses``): the host's kernel launch calls
(``cudaLaunch*``, ``cuLaunch*``) in the traced window over the daemon ticks
the window ran. Moves ``sim_req_per_s`` where the host paces the card."""


def read(win):
    return win.launches / win.ticks if win.ticks else None
