"""Graph generators, one module each, found by the name a configuration's
``graph.generator`` gives: ``gen/<name>.py`` defines ``nodes(graph) ->
int`` and ``generate(graph, seed) -> int32 [E, 2]`` host edges (each
undirected edge once, u != v)."""
