"""Device-idle time inside the program's ``batch`` spans and outside its
engine's metric spans (validation, planning, the upload, the fetch, the
gaps between them) per ``batch`` call, in ms."""

from bench.span_reader import idle_us, of

ENGINE = ("engine.occlusion", "engine.min_angle", "engine.edge_length",
          "engine.strips")


def read(run):
    got = of(run)
    calls = got[1].count("batch") if got is not None else 0
    if not calls:
        return None
    trace, placed = got
    return idle_us(trace, placed, ("batch",), ENGINE) * 1e-3 / calls
