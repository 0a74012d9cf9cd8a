"""Models built on the distributed embedding."""
