"""Models: the LM transformer family, SASRec and the GNN family, with the
shared layers and the parameter system."""
