"""BigGraphVis core: streaming community detection, CMS, supergraph,
ForceAtlas2 and coloring, per the paper."""
