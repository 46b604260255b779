"""Device rule, configuration and checkpoints."""
