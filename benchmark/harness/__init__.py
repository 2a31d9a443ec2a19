"""The yardstick's general code: the training loops, the profiler reduction,
the operation counts and peaks, and the comparison that decides
``correct``. Everything that belongs to one configuration, traffic mix or
per-layer metric lives in a file of its own, found by name."""
