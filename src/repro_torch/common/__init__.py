"""Device choice and parameter checkpoints."""
