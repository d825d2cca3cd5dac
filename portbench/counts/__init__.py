"""Operations and bytes of the port's kernels, and the card's published
peaks: the yardstick of the ``*_roofline`` metrics.  One module a kernel;
the arithmetic is ``chip_smoke.py``'s (``bound``, ``slot_tests``,
``walk_row``), copied so that the benchmark does not read that script."""
