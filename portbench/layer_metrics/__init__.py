"""Per-layer metric readers, one a family: the harness imports
``<family>.py`` (the metric's name before its first dot) and calls its
``read(ctx)``, which returns a number or None.  A reader that reads only
the device's events, of which a trace on the CPU has none, says so with
``DEVICE_EVENTS_ONLY = True``; the tests expect every other reader to
report on the small CPU cells it is listed for."""
