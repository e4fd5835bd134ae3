"""Per-layer metric readers, one a family: the harness imports
``<family>.py`` (the metric's name before its first dot) and calls its
``read(ctx)``, which returns a number or None."""
