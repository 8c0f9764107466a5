"""Ingest and I/O: the expression DSL query transforms read."""
