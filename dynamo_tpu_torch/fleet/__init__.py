"""Fleet topology: what a worker publishes about where its compute lives."""
