"""Core LIDER library: LSH, key rescaling, RMI, core model, clustering,
cluster bank and the two-layer index."""
