"""The harness: data from the seed, the loops, the check, the trace readers."""
