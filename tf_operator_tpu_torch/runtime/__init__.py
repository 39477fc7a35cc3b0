"""The training runtime of the port: optimizer, train step, loop, profiler."""
