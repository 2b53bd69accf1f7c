"""Device-busy time of the ops launched inside the program's
``engine.strips`` spans (both axes' strip build, bucketing and tiered
sweep) per ``batch`` call, in ms."""

from bench.span_reader import busy_us, of


def read(run):
    got = of(run)
    calls = got[1].count("batch") if got is not None else 0
    if not calls:
        return None
    trace, placed = got
    return busy_us(trace, placed, ("engine.strips",)) * 1e-3 / calls
