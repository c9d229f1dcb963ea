"""The port's benchmark: see bench/README.md."""
