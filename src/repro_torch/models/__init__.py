"""Transformer models of dense blocks (GQA and MLA): parameters, layers,
caches and serving steps."""
