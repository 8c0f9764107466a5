"""Ingest: the sharded (bin, z) sort the stream flusher reads."""
