"""Layer ``device`` (one H100): the share of the traced window in which no
operation ran on the card while the host was inside one of the program's
``chunk`` spans, in % (``kvbench/spans.py``). The rest of
``device_idle_pct`` falls at the scenarios' edges (set-up, the copy back,
the harness)."""

from kvbench import spans


def read(win):
    att = spans.attribute(win)
    if att is None or not att.chunk_ns or win.window_s <= 0:
        return None
    return 100.0 * att.idle_in_chunk_ns / (win.window_s * 1e9)
