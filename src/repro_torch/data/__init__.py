"""Synthetic corpora and workloads mirroring the paper's datasets, and the
recsys click stream and graph generators (copies of ``repro``'s)."""
