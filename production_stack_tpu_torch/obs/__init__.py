"""Observability helpers (Prometheus histograms)."""
