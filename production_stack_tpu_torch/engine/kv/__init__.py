"""Paged KV block pool."""
