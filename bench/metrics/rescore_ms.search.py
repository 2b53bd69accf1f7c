"""Time in the program's ``search.rescore`` spans (the exact re-scores,
their fetch and any replan) per ``search`` call, in ms."""

from bench.span_reader import spans_of


def read(run):
    placed = spans_of(run)
    calls = placed.count("search") if placed is not None else 0
    if not calls:
        return None
    return placed.length_us(("search.rescore",)) * 1e-3 / calls
