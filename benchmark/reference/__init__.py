"""Plain references of the configurations the benchmark runs."""
