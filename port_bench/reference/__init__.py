"""Plain float32 reference of the benchmark's models."""
