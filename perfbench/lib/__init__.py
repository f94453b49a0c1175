"""The harness's shared pieces: the manifest, the traffic generator, the
weights, the trace and the frozen copies of the program's sound pieces."""
