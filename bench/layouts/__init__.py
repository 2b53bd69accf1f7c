"""How a configuration's layouts are drawn from ``--seed``, one file per
``layouts.kind``: ``make(config, traffic, base, n_layouts, generator)``
returning ``(n_layouts, V, 2)`` float32 on the generator's device."""
