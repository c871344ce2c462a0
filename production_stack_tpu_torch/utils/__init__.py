"""Process lifecycle and request-parsing helpers."""
