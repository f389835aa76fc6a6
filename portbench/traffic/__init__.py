"""One driver per traffic mix, found by the ``traffic`` a cell's file names.

A driver module holds ``Cell(cfg, params, seed, device, control)`` with
``clients``, ``setup()``, ``call(client, k, rec)``, ``counters()``,
``release()``, ``check(window)`` and ``close()``: the harness
(``portbench/run.py``) drives them in that order. Only the drivers and
``program.py`` import the program (``cubefs_tpu_torch``).
"""
