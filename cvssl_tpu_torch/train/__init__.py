"""Training: config, state, methods and the engine."""
