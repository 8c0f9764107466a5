"""Storage: the sorted index tables, the delta tier, the adapter seam,
the catalog and persistence."""
