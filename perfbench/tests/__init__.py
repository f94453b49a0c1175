"""CPU tests of the benchmark (collected by the repository's pytest run)."""
