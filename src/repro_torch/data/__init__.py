"""Edge sources for the streaming engine (``edge_store``) and synthetic
batch pipelines for the models (``pipeline``)."""
