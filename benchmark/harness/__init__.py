"""What every cell shares: the manifest, the traffic generator, seeded
weights, the trace reduction, the comparison and one run's result line."""
