"""Device-resident 2D slice store and the two-stream sampler."""
