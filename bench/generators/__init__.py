"""Frozen copies of the graph generators that configurations name, one
file each (``make(graph)`` returning ``(edges, layout or None)``).  They
are kept here, not imported from the program, so that a change to the
program's generators cannot move the yardstick."""
