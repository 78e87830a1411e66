"""Part of the benchmark harness (see ``benchmark/README.md``)."""
