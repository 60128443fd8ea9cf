"""Edge sources for the streaming engine (``edge_store``)."""
