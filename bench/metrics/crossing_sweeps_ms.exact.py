"""Time in the program's ``exact.crossing`` and ``exact.crossing_angle``
spans (the two exact pair sweeps, each up to the host's read of its
count) per ``exact`` call, in ms."""

from bench.span_reader import spans_of


def read(run):
    placed = spans_of(run)
    calls = placed.count("exact") if placed is not None else 0
    if not calls:
        return None
    return placed.length_us(("exact.crossing",
                             "exact.crossing_angle")) * 1e-3 / calls
