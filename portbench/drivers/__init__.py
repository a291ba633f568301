"""The drivers of the benchmark's traffic, one module each, found by the
``driver`` that a traffic mix names (``harness.driver``). A driver has
``CONFIG_KEYS`` (the configuration keys it reads), ``run`` (set-up, the
measured and traced windows, the outcome of the timed path), ``reference``
(the same worked out again by the plain reference, after the window) and
``compare`` (the numbers that the cell's limits judge)."""
