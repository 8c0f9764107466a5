"""SQL tier: the ST_ function subset query transforms read."""
