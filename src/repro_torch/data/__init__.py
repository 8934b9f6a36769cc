"""Synthetic corpora and workloads mirroring the paper's datasets, and the
recsys click stream, the graph generators and the LM token stream (copies
of ``repro``'s)."""
