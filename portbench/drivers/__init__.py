"""One driver a traffic kind (``traffic.KINDS``), found by the mix's
``kind``: ``run(cell, config, mix, *, seed, seconds, trace, device, t0)``
returns a :class:`portbench.record.Record`."""
