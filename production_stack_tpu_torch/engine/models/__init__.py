"""Model forwards and weight loading."""
