"""Performance accounting."""
