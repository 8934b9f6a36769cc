"""Synthetic corpora and workloads mirroring the paper's datasets."""
