"""The plain float32 reference the benchmark checks the port against."""
