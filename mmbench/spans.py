"""What the program's own spans and counters say of a traced window, for
the per-layer metrics that read them.

The program records its spans and counters (``repro_torch.analysis.spans``)
while a ``torch.profiler`` records, in its ambient session: with ``--trace
1`` that is the window alone, since set-up, the warm-up and the check run
with no profiler.  A span's device time is taken by CUDA events on the
program's stream, inside the program, not from the profiler's mirror of
the range.  Each helper returns None where there is nothing to read: a
program without the recorder, a window whose calls the session does not
hold one for one, or device time on the CPU.
"""
from __future__ import annotations


def summary() -> dict | None:
    """The program's ``summary()`` of its ambient session, or None."""
    try:
        from repro_torch.analysis import spans
    except ImportError:
        return None
    return spans.summary()


def _window(view) -> dict | None:
    """The summary, where it holds one ``api.call`` per timed product."""
    s = summary()
    if s is None:
        return None
    calls = s["spans"].get("api.call", {}).get("count", 0)
    return s if calls == view.products else None


def per_product_ms(view, names: tuple[str, ...], field: str) -> float | None:
    """Milliseconds per product of ``field`` (``"device_s"`` or
    ``"host_s"``) summed over the spans whose name starts with one of
    ``names``."""
    s = _window(view)
    if s is None:
        return None
    rows = [r for name, r in s["spans"].items() if name.startswith(names)]
    if not rows or any(r[field] is None for r in rows):
        return None
    return 1e3 * sum(r[field] for r in rows) / view.products


def counter_share(view, part: str, whole: str) -> float | None:
    """100 · ``part`` / ``whole``, two of the program's counters."""
    s = _window(view)
    if s is None or not s["counters"].get(whole):
        return None
    return 100.0 * s["counters"].get(part, 0) / s["counters"][whole]
