"""One reader per metric, ``<metric name>.py``, each with ``read(run)``
(:class:`bench.harness.Run`) returning the value, or ``None`` where it
finds nothing to read; ``_work`` holds the roofline arithmetic."""
