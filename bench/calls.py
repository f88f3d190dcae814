"""The program's obs spans of a traced run, grouped by the multiply that
recorded them (their ``call`` id): the metric readers of the phases and
launches of a call read them here."""


def in_window(run) -> dict:
    """``{call id: [span, ...]}`` of the calls that began inside the traced
    part of the window (their first span starts in ``run.window_us``);
    empty where the program's spans carry no call id."""
    calls = {}
    for e in run.spans:
        call = e["args"].get("call")
        if call is not None:
            calls.setdefault(call, []).append(e)
    lo, hi = run.window_us
    return {c: spans for c, spans in calls.items()
            if lo <= min(e["ts"] for e in spans) <= hi}


def device_ms(spans: list, name: str) -> list:
    """The ``device_ms`` of the spans named ``name`` that have one (the
    CUDA event pairs of a run on the card)."""
    return [e["args"]["device_ms"] for e in spans
            if e["name"] == name and "device_ms" in e["args"]]
