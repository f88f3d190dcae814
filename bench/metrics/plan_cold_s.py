"""Seconds of the first, uncached ``plan_build`` span (the cold plan, with
the symbolic phase inside it where the output is sparse)."""


def read(run):
    cold = [e for e in run.spans if e["name"] == "plan_build"
            and not e["args"].get("cached", True)]
    return min(cold, key=lambda e: e["ts"])["dur"] / 1e6 if cold else None
