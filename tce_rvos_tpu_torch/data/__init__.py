"""Datasets, transforms, batching and loading of the port."""
