"""Device-idle time inside the program's ``search.step`` spans per step,
in ms."""

from bench.span_reader import idle_us, of


def read(run):
    got = of(run)
    steps = got[1].count("search.step") if got is not None else 0
    if not steps:
        return None
    trace, placed = got
    return idle_us(trace, placed, ("search.step",)) * 1e-3 / steps
