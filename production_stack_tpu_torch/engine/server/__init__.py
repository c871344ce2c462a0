"""Async engine bridge and the OpenAI-compatible HTTP server."""
