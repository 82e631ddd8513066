"""The benchmark's own code: finding cells, configurations, traffic mixes
and metric readers by name; the seeded weights and scenes; the spans and
the profiler window around the port; the work counts; the comparison with
the frozen reference that decides `correct`."""
