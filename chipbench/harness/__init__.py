"""The general part of the benchmark: loading cells by name, the traffic
generator, spans, the profiler window, statistics and the checks."""
