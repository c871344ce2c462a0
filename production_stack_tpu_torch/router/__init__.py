"""Router-side pieces the engine server shares (the metric vocabulary)."""
