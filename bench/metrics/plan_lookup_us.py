"""Microseconds of a cached plan lookup: the mean ``plan_build`` span that
hit the plan cache inside the traced part of the window."""


def read(run):
    lo, hi = run.window_us
    hits = [e["dur"] for e in run.spans if e["name"] == "plan_build"
            and e["args"].get("cached") and lo <= e["ts"] <= hi]
    return sum(hits) / len(hits) if hits else None
