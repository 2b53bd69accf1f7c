"""Time in the program's ``search.init`` (restart batch, validation)
and ``search.plan`` spans per ``search`` call, in ms."""

from bench.span_reader import spans_of


def read(run):
    placed = spans_of(run)
    calls = placed.count("search") if placed is not None else 0
    if not calls:
        return None
    return placed.length_us(("search.init", "search.plan")) * 1e-3 / calls
