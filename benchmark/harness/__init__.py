"""The benchmark's yardstick: finding a cell's files by name, the clocks,
the topologies, the traffic generator and drivers, the profiler's
arithmetic, the kernels' byte counts and peaks, and the isolation check."""
