"""Graph substrate: the planted-partition generator, padding, degrees."""
