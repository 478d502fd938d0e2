"""History generators for tests, benchmarks and the chip smoke run."""
