"""OSCD data: loaders, patch pipeline, synthetic datasets."""
